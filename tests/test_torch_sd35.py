"""The port's SD3.5 slice against the JAX package: the 2D sin-cos position
table and its centre crop, the 9-chunk dual-attention AdaLN, the three joint
block forms, the transformer (fastdm_tpu_torch/models/sd35.py) in bf16 and
int8 with and without dual blocks, ControlNet residuals, its loader and
converter, the TeaCache / FBCache / DiCache forwards, the batched-CFG
denoiser and the engine, on a tiny config (4 layers, 2 of them dual, 4 heads
x 16). JAX params come from JAX's sd3_load of a synthetic diffusers state
dict, moved across by the converter.

Tolerances:
- sincos_pos_embed_2d, the cropped table (computed or cut from a checkpoint's
  table) bit-exact.
- The AdaLN and each block form on the same bf16 inputs and weights within
  relative L2 1e-2 of JAX per output (bf16 rounds at the same points; XLA and
  PyTorch round about 40% of SiLU / GELU elements one ulp apart).
- The whole forward within relative L2 1e-2 (bf16) and 2e-2 (int8: the GEMM
  is exact, but a one-ulp difference upstream moves a per-token quantization
  step); the denoisers' f32 latents within 2e-2.
- The loaders bit-identical.
- The cached forwards: the same skip decisions as JAX over 4 steps, every
  decision at least 5% of its threshold away from it (the margins fixture of
  tests/test_torch_wan_cache.py); outputs as the forward.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.caching import config as jcc
from fastdm_tpu.caching.xcaching import cache_init_state as j_init_state
from fastdm_tpu.layers import embeddings as jemb
from fastdm_tpu.layers import normalization as jnorm
from fastdm_tpu.models import sd35 as jsd
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline import denoise_more as jden
from fastdm_tpu.pipeline import schedulers as jsch
from fastdm_tpu_torch.caching import config as tcc
from fastdm_tpu_torch.caching import xcaching
from fastdm_tpu_torch.layers import embeddings as temb
from fastdm_tpu_torch.models import sd35 as tsd
from fastdm_tpu_torch.models.convert import sd3_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import schedulers as tsch
from fastdm_tpu_torch.pipeline import vae as tvae
from fastdm_tpu_torch.pipeline.denoise_sd3 import make_sd3_denoiser

sys.path.insert(0, os.path.dirname(__file__))
from reference_harness import lin  # noqa: E402
from test_engine_e2e import _vae_sd, _write_st  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

TINY = dict(sample_size=16, patch_size=2, in_channels=4, out_channels=4, num_layers=4,
            attention_head_dim=16, num_attention_heads=4, joint_attention_dim=32,
            caption_projection_dim=64, pooled_projection_dim=24, pos_embed_max_size=24)
N_DUAL = 2
H, W, TXT = 16, 24, 7  # latent 16x24: 8x12 = 96 tokens
VAE_TINY = dict(latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=4, scaling_factor=1.5305, shift_factor=0.0609)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _state_dict(seed: int, num_layers: int = 4, num_dual: int = N_DUAL) -> dict:
    """A diffusers SD3 transformer state dict at TINY widths: blocks [0,
    num_dual) dual, the last context_pre_only."""
    rng = np.random.default_rng(seed)
    d, hd = TINY["num_attention_heads"] * TINY["attention_head_dim"], TINY["attention_head_dim"]
    sd = {"pos_embed.proj.weight": rng.standard_normal(
              (d, TINY["in_channels"], 2, 2)).astype(np.float32) * 0.05,
          "pos_embed.proj.bias": rng.standard_normal(d).astype(np.float32) * 0.02}
    m = TINY["pos_embed_max_size"]
    sd["pos_embed.pos_embed"] = jemb.sincos_pos_embed_2d(
        d, m, m, base_size=TINY["sample_size"] // 2)[None].astype(np.float32)
    for e, k in (("timestep_embedder", 256), ("text_embedder", TINY["pooled_projection_dim"])):
        lin(sd, rng, f"time_text_embed.{e}.linear_1", k, d)
        lin(sd, rng, f"time_text_embed.{e}.linear_2", d, d)
    lin(sd, rng, "context_embedder", TINY["joint_attention_dim"], d)

    def norms(p, names):
        for nm in names:
            sd[f"{p}.{nm}.weight"] = (1 + 0.05 * rng.standard_normal(hd)).astype(np.float32)

    for i in range(num_layers):
        p, last, dual = f"transformer_blocks.{i}", i == num_layers - 1, i < num_dual
        lin(sd, rng, f"{p}.norm1.linear", d, (9 if dual else 6) * d)
        lin(sd, rng, f"{p}.norm1_context.linear", d, (2 if last else 6) * d)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0"):
            lin(sd, rng, f"{p}.attn.{nm}", d, d)
        norms(f"{p}.attn", ("norm_q", "norm_k", "norm_added_q", "norm_added_k"))
        if not last:
            lin(sd, rng, f"{p}.attn.to_add_out", d, d)
        if dual:
            for nm in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(sd, rng, f"{p}.attn2.{nm}", d, d)
            norms(f"{p}.attn2", ("norm_q", "norm_k"))
        lin(sd, rng, f"{p}.ff.net.0.proj", d, 4 * d)
        lin(sd, rng, f"{p}.ff.net.2", 4 * d, d)
        if not last:
            lin(sd, rng, f"{p}.ff_context.net.0.proj", d, 4 * d)
            lin(sd, rng, f"{p}.ff_context.net.2", 4 * d, d)
    lin(sd, rng, "norm_out.linear", d, 2 * d)
    lin(sd, rng, "proj_out", d, 4 * TINY["out_channels"])
    return sd


def _jax_load(load, sd, cfg):
    """JAX's loader on its jnp quantize path, which the port's quantize_weight
    follows: its native host quantizer multiplies by a reciprocal and moves a
    rare int8 weight one step (ROADMAP.md section 3)."""
    from fastdm_tpu import native

    saved, native.get_lib = native.get_lib, lambda: None
    try:
        return load(JSource(dict(sd)), cfg)
    finally:
        native.get_lib = saved


def _pair(quant, num_dual=N_DUAL, seed=0):
    """(jcfg, jparams, tcfg, tparams converted, tparams from the port's loader)
    from one state dict."""
    sd = _state_dict(seed, num_dual=num_dual)
    jcfg = jsd.SD3Config(quant=quant, num_dual_layers=num_dual, **TINY)
    tcfg = tsd.SD3Config(quant=quant, num_dual_layers=num_dual, **TINY)
    jparams = _jax_load(jsd.sd3_load, sd, jcfg)
    return (jcfg, jparams, tcfg, sd3_params_from_numpy(jax.device_get(jparams), device="cpu"),
            tsd.sd3_load(TSource(dict(sd), device="cpu"), tcfg))


@pytest.fixture(scope="module", params=[None, "int8"])
def models(request):
    return _pair(request.param)


def _inputs(seed: int, b: int = 1):
    """bf16 latent, text and pooled embeddings on both sides (the same
    rounded values) and a timestep in sigma * 1000 units."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((b, TINY["in_channels"], H, W)),
            rng.standard_normal((b, TXT, TINY["joint_attention_dim"])),
            rng.standard_normal((b, TINY["pooled_projection_dim"])))
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    t = [torch.from_numpy(np.array(a, np.float32)).bfloat16() for a in j]
    ts = np.full((b,), 743.0, np.float32)
    return (*j, jnp.asarray(ts)), (*t, torch.from_numpy(ts))


# ------------------------------------------------------------ position table


@pytest.mark.parametrize("args", [(64, 24, 24, 8, 1.0), (32, 6, 10, None, 1.0),
                                  (16, 5, 7, 4, 2.0), (1536, 12, 20, 64, 1.0)])
def test_sincos_pos_embed_2d_bit_exact(args):
    d, gh, gw, base, scale = args
    want = jemb.sincos_pos_embed_2d(d, gh, gw, base_size=base, interpolation_scale=scale)
    got = temb.sincos_pos_embed_2d(d, gh, gw, base_size=base, interpolation_scale=scale)
    assert got.dtype == np.float64 and got.shape == (gh * gw, d)
    np.testing.assert_array_equal(got, want)


def test_sincos_pos_embed_2d_scale_needs_base_size():
    with pytest.raises(ValueError, match="base_size"):
        temb.sincos_pos_embed_2d(8, 2, 2, interpolation_scale=2.0)


@pytest.mark.parametrize("hw", [(H, W), (48, 48), (8, 4)])
def test_cropped_pos_embed_bit_exact(models, hw):
    """Computed from no table (random weights) and cut from a checkpoint's
    table, both centred as JAX crops them; the largest size is the whole
    table."""
    jcfg, jparams, tcfg, tparams, _ = models
    h, w = hw
    want = _np(jsd.sd3_cropped_pos_embed(jcfg, None, h, w))
    got = tsd.sd3_cropped_pos_embed(tcfg, None, h, w, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tsd.sd3_cropped_pos_embed(tcfg, tparams.pos_embed_table, h, w, device="cpu")),
        _np(jsd.sd3_cropped_pos_embed(jcfg, jparams["pos_embed_table"], h, w)))


# -------------------------------------------------------------- parameters


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tsd.SD3Config()) == dataclasses.asdict(jsd.SD3Config())


def test_converter_keeps_every_parameter(models):
    jcfg, jparams, tcfg, tparams, _ = models
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    assert (len(tparams.dual_blocks), len(tparams.std_blocks)) == (N_DUAL, 1)
    assert tparams.last_block.last and tparams.last_block.attn.to_add_out is None
    assert tparams.last_block.attn.add_qkv is not None  # the context still gives q, k, v
    want = np.asarray(jax.device_get(jparams["dual_attn_blocks"]["attn2"]["qkv"]["w"][1]))
    np.testing.assert_array_equal(_np(tparams.dual_blocks[1].attn2.qkv.w),
                                  want.astype(np.float32))


def test_sd3_load_matches_converted_jax_load(models):
    """The port's sd3_load equals JAX's sd3_load moved across by the
    converter, the patch conv's linear, the f32 position table and the int8
    weights and scales bit for bit."""
    _, _, tcfg, tparams, loaded = models
    got, want = loaded.state_dict(), tparams.state_dict()
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert loaded.pos_embed_table.dtype == torch.float32
    q = torch.int8 if tcfg.quant == "int8" else torch.bfloat16
    assert loaded.proj_out.w.dtype == loaded.norm_out.linear.w.dtype == q
    assert loaded.dual_blocks[0].norm1.linear.w.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="never consumed"):
        tsd.sd3_load(TSource(dict(_state_dict(0), extra=np.zeros(3, np.float32)),
                             device="cpu"), tcfg)


def test_sd3_init_random_is_seeded_in_its_format():
    cfg = tsd.SD3Config(quant="int8", num_dual_layers=N_DUAL, **TINY)
    a, b = (tsd.sd3_init_random(3, cfg, device="cpu") for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    loaded = tsd.sd3_load(TSource(_state_dict(1), device="cpu"), cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in loaded.state_dict().items()}
    del shapes["pos_embed_table"]  # a random init computes the table
    assert {k: (v.shape, v.dtype) for k, v in a.state_dict().items()} == shapes


# ------------------------------------------------------------------ blocks


def test_ada_layer_norm_zero_x_matches_jax(models):
    jcfg, jparams, tcfg, tparams, _ = models
    rng = np.random.default_rng(2)
    d = tcfg.inner_dim
    xj, ej = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16) for s in ((2, 9, d), (2, d)))
    want = jnorm.sd35_ada_layer_norm_zero_x(
        jax.tree.map(lambda a: a[0], jparams["dual_attn_blocks"])["norm1"], xj, ej)
    got = tparams.dual_blocks[0].norm1(torch.from_numpy(np.array(xj, np.float32)).bfloat16(),
                                       torch.from_numpy(np.array(ej, np.float32)).bfloat16())
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and _rel_l2(g, w) <= 1e-2


@pytest.mark.parametrize("kind", ["dual", "std", "last"])
def test_sd3_joint_block_matches_jax(models, kind):
    jcfg, jparams, tcfg, tparams, _ = models
    if kind == "dual":
        jblk, tblk = jax.tree.map(lambda a: a[1], jparams["dual_attn_blocks"]), \
            tparams.dual_blocks[1]
    elif kind == "std":
        jblk, tblk = jax.tree.map(lambda a: a[0], jparams["std_blocks"]), tparams.std_blocks[0]
    else:
        jblk, tblk = jparams["last_block"], tparams.last_block
    rng = np.random.default_rng(3)
    d = tcfg.inner_dim
    hj, ej, tj = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                  for s in ((1, 20, d), (1, TXT, d), (1, d)))
    want = jax.jit(lambda b, h, e, t: jsd.sd3_joint_block(
        b, h, e, t, jcfg, dual=kind == "dual", last=kind == "last"))(jblk, hj, ej, tj)
    conv = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()  # noqa: E731
    with torch.inference_mode():
        got = tblk(conv(hj), conv(ej), conv(tj), tcfg)
    assert (tblk.dual, tblk.last) == (kind == "dual", kind == "last")
    assert _rel_l2(got[0], want[0]) <= 1e-2
    if kind == "last":
        assert got[1] is None and want[1] is None
    else:
        assert _rel_l2(got[1], want[1]) <= 1e-2


# ------------------------------------------------------------------ forward


def _jforward(jparams, jcfg, *args, **kw):
    return jax.jit(lambda p, a, k: jsd.sd3_forward(p, jcfg, *a, **k))(jparams, args, kw)


def test_sd3_forward_matches_jax(models):
    """The whole forward, then with ControlNet residuals (one per block, the
    last after the last block)."""
    jcfg, jparams, tcfg, tparams, _ = models
    j, t = _inputs(1)
    jpos = jsd.sd3_cropped_pos_embed(jcfg, jparams["pos_embed_table"], H, W)
    tpos = tsd.sd3_cropped_pos_embed(tcfg, tparams.pos_embed_table, H, W, device="cpu")
    tol = 1e-2 if tcfg.quant is None else 2e-2
    want = _jforward(jparams, jcfg, *j, jpos)
    with torch.inference_mode():
        got = tsd.sd3_forward(tparams, tcfg, *t, tpos)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (
        1, TINY["out_channels"], H, W)
    assert _rel_l2(got, want) <= tol
    n_tok = (H // 2) * (W // 2)
    cn = np.random.default_rng(4).standard_normal(
        (TINY["num_layers"], 1, n_tok, tcfg.inner_dim)).astype(np.float32) * 0.5
    want_cn = _jforward(jparams, jcfg, *j, jpos,
                        controlnet_block_samples=jnp.asarray(cn, jnp.bfloat16))
    with torch.inference_mode():
        got_cn = tsd.sd3_forward(tparams, tcfg, *t, tpos,
                                 controlnet_block_samples=torch.from_numpy(cn).bfloat16())
    assert _rel_l2(got_cn, want_cn) <= tol and _rel_l2(got_cn, got) > 0.05


def test_sd3_forward_without_dual_blocks_matches_jax():
    """num_dual_layers=0 (SD3.0 / SD3.5-large): the dual segment is empty
    on both sides, and TeaCache probes the first standard block."""
    jcfg, jparams, tcfg, tparams, loaded = _pair("int8", num_dual=0, seed=5)
    assert jparams["dual_attn_blocks"] is None and len(tparams.dual_blocks) == 0
    assert len(loaded.std_blocks) == TINY["num_layers"] - 1
    j, t = _inputs(6)
    want = _jforward(jparams, jcfg, *j, jsd.sd3_cropped_pos_embed(jcfg, None, H, W))
    with torch.inference_mode():
        got = tsd.sd3_forward(tparams, tcfg, *t,
                              tsd.sd3_cropped_pos_embed(tcfg, None, H, W, device="cpu"))
    assert _rel_l2(got, want) <= 2e-2
    cc = tcc.TeaCacheConfig(enable_caching=True, threshold=1e6, coefficients=(1.0, 0.0))
    shape = (1, (H // 2) * (W // 2), tcfg.inner_dim)
    with torch.inference_mode():
        out, state = tsd.sd3_forward_cached(
            tparams, tcfg, cc, xcaching.cache_init_state(cc, shape, shape, device="cpu"), 0, 2,
            *t, tsd.sd3_cropped_pos_embed(tcfg, None, H, W, device="cpu"))
    assert torch.equal(out, got) and state["skips"] == 0


# ----------------------------------------------------------- step caches


@pytest.fixture
def margins(monkeypatch):
    """For every decision that is not forced, how far the accumulated error
    lies from the threshold, relative to it (>= 5% asserted at teardown)."""
    seen = []
    decide = xcaching._decide

    def spy(cfg, state, error, step, total_steps):
        should, accum = decide(cfg, state, error, step, total_steps)
        tea = isinstance(cfg, tcc.TeaCacheConfig)
        cand = state["accum"] + (xcaching._polyval(cfg.coefficients, error) if tea else error)
        if tea:
            forced = step == 0
        elif isinstance(cfg, tcc.FBCacheConfig):
            forced = step <= cfg.warmup_steps
        else:
            forced = step <= int(cfg.ret_ratio * total_steps)
        if not forced:
            seen.append(abs(float(cand) / cfg.threshold - 1.0))
        return should, accum

    monkeypatch.setattr(xcaching, "_decide", spy)
    yield seen
    assert not seen or min(seen) > 0.05, f"a decision lies within 5% of its threshold: {seen}"


# name: (config, expected skips over 4 steps); DiCache's probe depth 3 spans
# the two dual blocks and the first standard one
CACHES = {
    "teacache": (dict(cache_algorithm="teacache", threshold=0.044,
                      coefficients=(1.0, 0.0)), 2),
    "fbcache": (dict(cache_algorithm="fbcache", threshold=0.009, warmup_steps=1), 1),
    "dicache": (dict(cache_algorithm="dicache", threshold=0.011, probe_depth=3,
                     ret_ratio=0.25), 1),
}


@pytest.fixture(scope="module")
def int8_models():
    return _pair("int8", seed=7)


@pytest.mark.parametrize("name", sorted(CACHES))
def test_sd3_forward_cached_matches_jax(int8_models, name, margins):
    """Four steps of the batched stream through sd3_forward_cached, a new
    latent each step: the skip counts (and where they fall) equal JAX's."""
    jcfg, jparams, tcfg, tparams, _ = int8_models
    kw, skips = CACHES[name]
    jc = jcc.CacheConfig.from_dict(dict(kw, enable_caching=True))
    tc = tcc.CacheConfig.from_dict(dict(kw, enable_caching=True))
    if name == "dicache":  # the probe runs both dual blocks and the first standard one
        assert tc.probe_depth == 3 > tcfg.num_dual_layers
    j, t = _inputs(8, b=2)
    shape = (2, (H // 2) * (W // 2), tcfg.inner_dim)
    jst, tst = j_init_state(jc, shape, shape), xcaching.cache_init_state(tc, shape, shape,
                                                                         device="cpu")
    jpos = jsd.sd3_cropped_pos_embed(jcfg, None, H, W)
    tpos = tsd.sd3_cropped_pos_embed(tcfg, None, H, W, device="cpu")
    jfwd = jax.jit(jsd.sd3_forward_cached, static_argnums=(1, 2, 5))
    base = np.array(j[0], np.float32)
    for step in range(4):
        lat = base * (1 - 0.02 * step)
        ts = 900.0 - 30 * step
        want, jst = jfwd(jparams, jcfg, jc, jst, jnp.int32(step), 4,
                         jnp.asarray(lat, jnp.bfloat16), j[1], j[2],
                         jnp.full((2,), ts, jnp.float32), jpos)
        with torch.inference_mode():
            got, tst = tsd.sd3_forward_cached(tparams, tcfg, tc, tst, step, 4,
                                              torch.from_numpy(lat).bfloat16(), t[1], t[2],
                                              torch.full((2,), ts), tpos)
        assert tst["skips"] == int(jst["skips"]), f"step {step}"
        assert _rel_l2(got, want) <= 2e-2
    assert tst["skips"] == skips


def test_make_sd3_denoiser_matches_jax(int8_models):
    """Three batched-CFG steps (guidance 7.0, shift 3.0) uncached, then four
    under TeaCache: the [neg; pos] batch, sigma * 1000 timesteps, Euler steps
    and skip counts as JAX; start_step=1 runs the last two steps only."""
    jcfg, jparams, tcfg, tparams, _ = int8_models
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((1, TINY["in_channels"], H, W)).astype(np.float32)
    j, t = _inputs(10, b=2)
    jpos = jsd.sd3_cropped_pos_embed(jcfg, None, H, W)
    tpos = tsd.sd3_cropped_pos_embed(tcfg, None, H, W, device="cpu")
    for steps, cache, start in ((3, None, 0), (4, "teacache", 0), (3, None, 1)):
        jc = tc = None
        if cache:
            kw = dict(CACHES[cache][0], enable_caching=True)
            jc, tc = jcc.CacheConfig.from_dict(kw), tcc.CacheConfig.from_dict(kw)
        jsc, tsc = (m.FlowMatchEulerScheduler.create(steps, shift=3.0) for m in (jsch, tsch))
        np.testing.assert_array_equal(tsc.sigmas, jsc.sigmas)
        want, jskips = jden.make_sd3_denoiser(jcfg, jsc, steps, 7.0, jc, start)(
            jparams, jnp.asarray(lat), j[1], j[2], jpos)
        got, skips = make_sd3_denoiser(tcfg, tsc, steps, 7.0, tc, start)(
            tparams, torch.from_numpy(lat), t[1], t[2], tpos)
        assert got.dtype == torch.float32 and tuple(got.shape) == lat.shape
        assert skips == int(jskips) and (skips > 0) == (cache is not None)
        assert _rel_l2(got, want) <= 2e-2


# ------------------------------------------------------------------- engine


@pytest.fixture
def sd35_root(tmp_path, monkeypatch):
    """A tiny transformer/ (config.json with dual_attention_layers) + vae/
    checkpoint; VAE_CONFIGS["sd35"] shrunk to match, its scaling kept."""
    import fastdm_tpu_torch.engine as engine_mod

    root = str(tmp_path / "sd35-tiny")
    _write_st(os.path.join(root, "transformer", "model.safetensors"), _state_dict(11))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(dict(TINY, dual_attention_layers=list(range(N_DUAL))), f)
    _write_st(os.path.join(root, "vae", "model.safetensors"),
              _vae_sd(np.random.default_rng(12), latent_channels=4))
    assert engine_mod.VAE_CONFIGS["sd35"].scaling_factor == 1.5305
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "sd35", tvae.VAEConfig(**VAE_TINY))
    return root


def _embeds(seed):
    rng = np.random.default_rng(seed)
    return dict(prompt_embeds=rng.standard_normal((1, TXT, 32)).astype(np.float32),
                pooled_prompt_embeds=rng.standard_normal((1, 24)).astype(np.float32),
                negative_prompt_embeds=rng.standard_normal((1, TXT, 32)).astype(np.float32),
                negative_pooled_prompt_embeds=rng.standard_normal((1, 24)).astype(np.float32))


def test_engine_end_to_end(sd35_root):
    """use_int8 with teacache_sd35.json: the config.json overrides, a 2-step
    CFG generate whose latents equal the denoiser's on the same seeded noise
    and the checkpoint's cropped table, and the image their VAE decode; the
    i2i task and missing embeddings raise."""
    from fastdm_tpu_torch.engine import FastDMEngine

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "xcaching", "configs", "teacache_sd35.json")
    eng = FastDMEngine(sd35_root, architecture="sd3.5", use_int8=True, cache_config=path,
                       verbose=False, device="cpu")
    assert eng.cfg.num_dual_layers == N_DUAL and eng.cfg.num_layers == 4
    assert eng.params.std_blocks[0].attn.qkv.w.dtype == torch.int8
    kw = dict(_embeds(13), height=128, width=192, num_inference_steps=2, seed=3)
    img = eng.generate(**kw)
    assert img.shape == (1, 128, 192, 3) and img.dtype == np.uint8
    lat = eng.generate(output_type="latent", **kw)
    sched = tsch.FlowMatchEulerScheduler.create(2, shift=3.0)
    noise = torch.randn((1, 4, 16, 24), generator=torch.Generator().manual_seed(3))
    e = {k: torch.from_numpy(v).bfloat16() for k, v in _embeds(13).items()}
    want, skips = make_sd3_denoiser(eng.cfg, sched, 2, 7.0, eng.cache_config)(
        eng.params, noise, torch.cat([e["negative_prompt_embeds"], e["prompt_embeds"]]),
        torch.cat([e["negative_pooled_prompt_embeds"], e["pooled_prompt_embeds"]]),
        tsd.sd3_cropped_pos_embed(eng.cfg, eng.params.pos_embed_table, 16, 24, device="cpu"))
    np.testing.assert_array_equal(lat, want.numpy())
    assert eng.last_cache_skips == skips
    np.testing.assert_array_equal(img, eng._to_uint8(tvae.vae_decode(eng.vae_params,
                                                                     eng.vae_cfg, want)))
    with pytest.raises(NotImplementedError, match="t2i, i2i are"):
        eng.generate(task="v2v", image=np.zeros((128, 192, 3), np.uint8), **kw)
    # the text encoders have arrived: given embeddings serve the positive, and
    # CFG's negative ("" without negative embeddings) needs tokenizer/
    with pytest.raises(FileNotFoundError, match="tokenizer/"):
        eng.generate(prompt="a cat", prompt_embeds=kw["prompt_embeds"],
                     pooled_prompt_embeds=kw["pooled_prompt_embeds"])


def test_entry_points_default_to_the_card():
    """Without a GPU the entry points raise unless the caller asks for the
    CPU: no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    cfg = tsd.SD3Config(num_dual_layers=N_DUAL, **TINY)
    for call in (lambda: tsd.sd3_init_random(0, cfg),
                 lambda: tsd.sd3_cropped_pos_embed(cfg, None, H, W)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
