"""The port's Qwen-Image slice against the JAX package: the scale_rope RoPE
tables, the dual-stream block, the transformer
(fastdm_tpu_torch/models/qwenimage.py) in bf16, int8 and int4p with
quant_mods, its loader and converter, the TeaCache (text-stream probe) /
FBCache / DiCache forwards, the true-CFG denoiser with its two cache streams,
and the engine with both VAE routes (AutoencoderKL, and the Wan VAE decoder
for a vae/config.json with base_dim), on a tiny config (3 blocks, 2 heads x
32). JAX params come from JAX's qwen_load of a synthetic diffusers state
dict, moved across by the converter.

Tolerances:
- qwen_rope_cos_sin bit-exact (negative scale_rope positions, the text
  offset, extra image entries).
- The block and the whole forward on the same bf16 inputs and weights within
  relative L2 1e-2 of JAX (bf16); 2e-2 for int8 and int4p (the integer GEMMs
  are exact, but a one-ulp difference upstream moves a quantization step);
  the denoisers' f32 latents within 2e-2.
- The loaders bit-identical (bf16, int8 with quant_mods; int4p but for the
  low-rank split, which draws from another generator,
  tests/test_torch_int4.py).
- The cached forwards and the cached denoiser: the same skip decisions as
  JAX, every decision at least 5% of its threshold away from it.
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
from fastdm_tpu.models import qwenimage as jqw
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline import denoise_more as jden
from fastdm_tpu.pipeline import schedulers as jsch
from fastdm_tpu_torch.caching import config as tcc
from fastdm_tpu_torch.caching import xcaching
from fastdm_tpu_torch.models import qwenimage as tqw
from fastdm_tpu_torch.models.convert import qwen_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import schedulers as tsch
from fastdm_tpu_torch.pipeline import vae as tvae
from fastdm_tpu_torch.pipeline import wan_vae as twvae
from fastdm_tpu_torch.pipeline.denoise import flux_unpack_latents
from fastdm_tpu_torch.pipeline.denoise_qwen import make_qwen_denoiser

sys.path.insert(0, os.path.dirname(__file__))
from reference_harness import lin  # noqa: E402
from test_engine_e2e import _vae_sd, _write_st  # noqa: E402
from test_torch_sd35 import margins  # noqa: E402,F401  (fixture)
from test_wan_vae import TINY as WAN_VAE_TINY  # noqa: E402
from test_wan_vae import _mk_diffusers_state_dict  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

TINY = dict(num_layers=3, attention_head_dim=32, num_attention_heads=2, joint_attention_dim=24,
            in_channels=16, out_channels=4, axes_dims_rope=(8, 12, 12))
HT, WT, TXT = 4, 6, 5  # 24 image tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _state_dict(seed: int, cfg: dict = TINY) -> dict:
    """A diffusers Qwen-Image transformer state dict at the widths of cfg."""
    rng = np.random.default_rng(seed)
    d, hd = cfg["num_attention_heads"] * cfg["attention_head_dim"], cfg["attention_head_dim"]
    sd = {}
    lin(sd, rng, "img_in", cfg["in_channels"], d)
    lin(sd, rng, "txt_in", cfg["joint_attention_dim"], d)
    sd["txt_norm.weight"] = (1 + 0.05 * rng.standard_normal(
        cfg["joint_attention_dim"])).astype(np.float32)
    lin(sd, rng, "time_text_embed.timestep_embedder.linear_1", 256, d)
    lin(sd, rng, "time_text_embed.timestep_embedder.linear_2", d, d)
    for i in range(cfg["num_layers"]):
        p = f"transformer_blocks.{i}"
        lin(sd, rng, f"{p}.img_mod.1", d, 6 * d)
        lin(sd, rng, f"{p}.txt_mod.1", d, 6 * d)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0",
                   "to_add_out"):
            lin(sd, rng, f"{p}.attn.{nm}", d, d)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            sd[f"{p}.attn.{nm}.weight"] = (1 + 0.05 * rng.standard_normal(hd)).astype(np.float32)
        for mlp in ("img_mlp", "txt_mlp"):
            lin(sd, rng, f"{p}.{mlp}.net.0.proj", d, 4 * d)
            lin(sd, rng, f"{p}.{mlp}.net.2", 4 * d, d)
    lin(sd, rng, "norm_out.linear", d, 2 * d)
    lin(sd, rng, "proj_out", d, 4 * cfg["out_channels"])
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


def _pair(quant, quant_mods=False, seed=0, port_load=True):
    """(jcfg, jparams, tcfg, tparams converted, tparams from the port's
    loader, or None without port_load) from one state dict."""
    sd = _state_dict(seed)
    jcfg = jqw.QwenImageConfig(quant=quant, quant_mods=quant_mods, **TINY)
    tcfg = tqw.QwenImageConfig(quant=quant, quant_mods=quant_mods, **TINY)
    jparams = _jax_load(jqw.qwen_load, sd, jcfg)
    return (jcfg, jparams, tcfg, qwen_params_from_numpy(jax.device_get(jparams), "cpu"),
            tqw.qwen_load(TSource(dict(sd), "cpu"), tcfg) if port_load else None)


# int8 with quant_mods covers int8 block linears and int8 modulations; bf16
# the bf16 modulations
FORMATS = {"bf16": (None, False), "int8-mods": ("int8", True), "int4p-mods": ("int4p", True)}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def models(request):
    return _pair(*FORMATS[request.param])


def _tol(tcfg):
    return 1e-2 if tcfg.quant is None else 2e-2


def _inputs(seed: int, b: int = 1, txt: int = TXT):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((b, HT * WT, TINY["in_channels"])),
            rng.standard_normal((b, txt, TINY["joint_attention_dim"])) * 3)
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    t = [torch.from_numpy(np.array(a, np.float32)).bfloat16() for a in j]
    return (*j, jnp.full((b,), 0.73, jnp.float32)), (*t, torch.full((b,), 0.73))


def _rope(jcfg, tcfg, txt=TXT):
    return jqw.qwen_rope_cos_sin(jcfg, 1, HT, WT, txt), \
        tqw.qwen_rope_cos_sin(tcfg, 1, HT, WT, txt, device="cpu")


# ---------------------------------------------------------------- rope


@pytest.mark.parametrize("case", [dict(f=1, h=4, w=6, txt=5), dict(f=1, h=5, w=3, txt=2),
                                  dict(f=2, h=3, w=4, txt=3, scale_rope=False),
                                  dict(f=1, h=4, w=6, txt=5, extra=((1, 8, 2), (1, 3, 5))),
                                  dict(f=1, h=64, w=128, txt=512, full=True)])
def test_qwen_rope_cos_sin_bit_exact(case):
    """Text first from max(h//2, w//2) on, image positions centred (the first
    half negative) under scale_rope, extra entries after the main image with
    their frame axis from their index on; at Qwen-Image's axes the
    1024x2048 table with 512 text tokens."""
    kw = {} if case.get("full") else TINY
    cfgs = [m.QwenImageConfig(scale_rope=case.get("scale_rope", True), **kw)
            for m in (jqw, tqw)]
    extra = case.get("extra", ())
    jcos, jsin = jqw.qwen_rope_cos_sin(cfgs[0], case["f"], case["h"], case["w"], case["txt"],
                                       extra_shapes=extra)
    tcos, tsin = tqw.qwen_rope_cos_sin(cfgs[1], case["f"], case["h"], case["w"], case["txt"],
                                       extra_shapes=extra, device="cpu")
    assert tcos.dtype == torch.float32 and tuple(tcos.shape) == jcos.shape
    np.testing.assert_array_equal(_np(tcos), _np(jcos))
    np.testing.assert_array_equal(_np(tsin), _np(jsin))
    if case.get("scale_rope", True):  # the first image row's negative positions
        assert (tsin[case["txt"]] < 0).any()


# -------------------------------------------------------------- parameters


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tqw.QwenImageConfig()) == dataclasses.asdict(jqw.QwenImageConfig())


def test_converter_keeps_every_parameter(models):
    jcfg, jparams, tcfg, tparams, _ = models
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    blk = tparams.blocks[2]
    if tcfg.quant == "int4p":
        assert blk.attn.qkv.w4p is not None and blk.attn.qkv.w is None
        assert blk.txt_mod.w4p is not None  # quant_mods
    else:
        q = torch.int8 if tcfg.quant == "int8" else torch.bfloat16
        assert blk.img_mlp.proj.w.dtype == q
        assert blk.img_mod.w.dtype == (q if tcfg.quant_mods else torch.bfloat16)
    assert tparams.proj_out.w.dtype == tparams.norm_out.linear.w.dtype == torch.bfloat16


def test_qwen_load_matches_converted_jax_load(models):
    """The port's qwen_load equals JAX's qwen_load moved across by the
    converter bit for bit; for W4A4 every leaf but the SVDQuant split (w4p,
    scale, lora_u, lora_v: the port draws its random test matrix from
    another generator, tests/test_torch_int4.py holds that split), whose
    shapes and dtypes still agree."""
    _, _, tcfg, tparams, loaded = models
    got, want = loaded.state_dict(), tparams.state_dict()
    assert list(got) == list(want)
    split = (".w4p", ".scale", ".lora_u", ".lora_v") if tcfg.quant == "int4p" else ()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert (split and k.endswith(split)) or torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="never consumed"):
        tqw.qwen_load(TSource(dict(_state_dict(0), extra=np.zeros(3, np.float32)), "cpu"), tcfg)


def test_qwen_init_random_is_seeded_in_its_format():
    cfg = tqw.QwenImageConfig(quant="int4p", quant_mods=True, **TINY)
    a, b = (tqw.qwen_init_random(3, cfg, device="cpu") for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert a.blocks[0].img_mod.w4p is not None and a.blocks[0].attn.to_add_out.w4p is not None
    assert a.img_in.w.dtype == a.proj_out.w.dtype == torch.bfloat16
    cfg8 = tqw.QwenImageConfig(quant="int8", **TINY)
    loaded = tqw.qwen_load(TSource(_state_dict(1), device="cpu"), cfg8)
    assert {k: (v.shape, v.dtype) for k, v in
            tqw.qwen_init_random(4, cfg8, device="cpu").state_dict().items()} == \
        {k: (v.shape, v.dtype) for k, v in loaded.state_dict().items()}


# ----------------------------------------------------------------- forward


def test_qwen_block_matches_jax(models):
    jcfg, jparams, tcfg, tparams, _ = models
    (jcos, jsin), (tcos, tsin) = _rope(jcfg, tcfg)
    rng = np.random.default_rng(3)
    d = tcfg.inner_dim
    hj, ej, tj = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                  for s in ((1, HT * WT, d), (1, TXT, d), (1, d)))
    blk = jax.tree.map(lambda a: a[1], jparams["blocks"])
    want = jax.jit(lambda b, *a: jqw.qwen_block(b, *a, jcfg))(blk, hj, ej, tj, jcos, jsin)
    conv = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()  # noqa: E731
    with torch.inference_mode():
        got = tparams.blocks[1](conv(hj), conv(ej), conv(tj), tcos, tsin, tcfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and _rel_l2(g, w) <= _tol(tcfg)


def test_qwen_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams, _ = models
    j, t = _inputs(1)
    (jcos, jsin), (tcos, tsin) = _rope(jcfg, tcfg)
    want = jax.jit(lambda p, *a: jqw.qwen_forward(p, jcfg, *a))(jparams, *j, jcos, jsin)
    with torch.inference_mode():
        got = tqw.qwen_forward(tparams, tcfg, *t, tcos, tsin)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (
        1, HT * WT, 4 * TINY["out_channels"])
    assert np.isfinite(_np(got)).all() and _rel_l2(got, want) <= _tol(tcfg)


# ----------------------------------------------------------- step caches

# name: (config, expected skips over 4 steps); DiCache's probe runs blocks 0-1
CACHES = {
    "teacache": (dict(cache_algorithm="teacache", threshold=0.054, coefficients=(1.0, 0.0)), 2),
    "fbcache": (dict(cache_algorithm="fbcache", threshold=0.05, warmup_steps=1), 1),
    "dicache": (dict(cache_algorithm="dicache", threshold=0.05, probe_depth=2,
                     ret_ratio=0.25), 1),
}


@pytest.fixture(scope="module")
def int4_models():
    return _pair("int4p", quant_mods=True, seed=7, port_load=False)


def _cache_pair(name, **override):
    kw = dict(CACHES[name][0], enable_caching=True, **override)
    return jcc.CacheConfig.from_dict(kw), tcc.CacheConfig.from_dict(kw)


@pytest.mark.parametrize("name", sorted(CACHES))
def test_qwen_forward_cached_matches_jax(int4_models, name, margins):
    """Four steps through qwen_forward_cached on the int4p quant_mods model (the
    main path), a new latent each step: the skip counts equal JAX's. The
    TeaCache probe is block 0's text stream (txt_len tokens)."""
    jcfg, jparams, tcfg, tparams, _ = int4_models
    jc, tc = _cache_pair(name)
    j, t = _inputs(8)
    img = (1, HT * WT, tcfg.inner_dim)
    probe = (1, TXT, tcfg.inner_dim) if name == "teacache" else img
    jst, tst = j_init_state(jc, img, probe), xcaching.cache_init_state(tc, img, probe,
                                                                          device="cpu")
    (jcos, jsin), (tcos, tsin) = _rope(jcfg, tcfg)
    jfwd = jax.jit(jqw.qwen_forward_cached, static_argnums=(1, 2, 5))
    base = np.array(j[0], np.float32)
    for step in range(4):
        lat = base * (1 - 0.03 * step)
        s = 0.9 - 0.2 * step
        want, jst = jfwd(jparams, jcfg, jc, jst, jnp.int32(step), 4,
                         jnp.asarray(lat, jnp.bfloat16), j[1], jnp.full((1,), s, jnp.float32),
                         jcos, jsin)
        with torch.inference_mode():
            got, tst = tqw.qwen_forward_cached(tparams, tcfg, tc, tst, step, 4,
                                               torch.from_numpy(lat).bfloat16(), t[1],
                                               torch.full((1,), s), tcos, tsin)
        assert tst["skips"] == int(jst["skips"]), f"step {step}"
        assert _rel_l2(got, want) <= 2e-2
    assert tst["skips"] == CACHES[name][1]


@pytest.mark.parametrize("cache", [None, "teacache"])
def test_make_qwen_denoiser_matches_jax(int4_models, cache, margins):
    """True CFG 4.0 over 4 dynamic-shift steps: two forwards a step, each
    stream with its own cache state, the negative one rescaled by its own
    polynomial (negtive_coefficients); then true_cfg_scale 1.0 (the bench
    setting), the positive forward only."""
    jcfg, jparams, tcfg, tparams, _ = int4_models
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((1, HT * WT, TINY["in_channels"])).astype(np.float32)
    (_, pj, _), (_, pt, _) = _inputs(10)
    (_, nj, _), (_, nt, _) = _inputs(11)
    (jcos, jsin), (tcos, tsin) = _rope(jcfg, tcfg)
    jc = tc = None
    if cache:
        jc, tc = _cache_pair(cache, threshold=0.044, negtive_coefficients=(1.2, 0.0))
    mu = tsch.flow_match_shift_mu(HT * WT)
    jsc = jsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, mu=mu)
    tsc = tsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, mu=mu)
    np.testing.assert_array_equal(tsc.sigmas, jsc.sigmas)
    for scale in (4.0, 1.0):
        want, jskips = jden.make_qwen_denoiser(jcfg, jsc, 4, scale, jc)(
            jparams, jnp.asarray(lat), pj, nj, jcos, jsin)
        got, skips = make_qwen_denoiser(tcfg, tsc, 4, scale, tc)(
            tparams, torch.from_numpy(lat), pt, nt, tcos, tsin)
        assert got.dtype == torch.float32 and skips == int(jskips)
        assert (skips > 0) == (cache is not None)
        assert _rel_l2(got, want) <= 2e-2


# ------------------------------------------------------------------- engine


def _write_checkpoint(root: str, wan_vae: bool) -> None:
    """transformer/ (config.json with the tiny widths) and vae/: the Wan
    VAE with its config.json (base_dim), or an AutoencoderKL without one."""
    _write_st(os.path.join(root, "transformer", "model.safetensors"), _state_dict(12))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(dict(TINY, axes_dims_rope=list(TINY["axes_dims_rope"])), f)
    vae = os.path.join(root, "vae")
    if wan_vae:
        v = WAN_VAE_TINY
        assert v.z_dim == TINY["in_channels"] // 4
        _write_st(os.path.join(vae, "model.safetensors"), _mk_diffusers_state_dict(v))
        with open(os.path.join(vae, "config.json"), "w") as f:
            json.dump({"base_dim": v.base_dim, "z_dim": v.z_dim,
                       "num_res_blocks": v.num_res_blocks, "dim_mult": list(v.dim_mult),
                       "temperal_downsample": list(v.temporal_downsample),
                       "latents_mean": list(v.latents_mean),
                       "latents_std": list(v.latents_std)}, f)
    else:
        _write_st(os.path.join(vae, "model.safetensors"),
                  _vae_sd(np.random.default_rng(13), latent_channels=4))


@pytest.mark.parametrize("wan_vae", [True, False])
def test_engine_end_to_end(tmp_path, monkeypatch, wan_vae):
    """use_int4 + pack_int4 + quant_mods with teacache_qwenimage.json: a
    2-step true-CFG generate whose latents equal the denoiser's on the same
    seeded noise and padded embeddings, and the image their decode through
    the VAE route vae/config.json names (the Wan VAE decoder on a singleton
    frame, or the AutoencoderKL)."""
    import fastdm_tpu_torch.engine as engine_mod
    from fastdm_tpu_torch.engine import FastDMEngine

    root = str(tmp_path / "qwen-tiny")
    _write_checkpoint(root, wan_vae)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "qwen", tvae.VAEConfig(
        latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
        norm_num_groups=4, scaling_factor=1.0, shift_factor=0.0))
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "xcaching", "configs", "teacache_qwenimage.json")
    eng = FastDMEngine(root, architecture="qwen-image", use_int4=True, pack_int4=True,
                       quant_mods=True, cache_config=path, verbose=False, device="cpu")
    assert eng.cfg.num_layers == 3 and eng.cfg.quant == "int4p" and eng.cfg.quant_mods
    assert eng.params.blocks[0].txt_mod.w4p is not None
    assert isinstance(eng.vae_cfg, twvae.WanVAEConfig) == wan_vae
    rng = np.random.default_rng(14)
    pos = rng.standard_normal((1, TXT, 24)).astype(np.float32)
    neg = rng.standard_normal((1, TXT - 2, 24)).astype(np.float32)  # padded to TXT
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=96,
              num_inference_steps=2, true_cfg_scale=3.0, seed=5)
    img = eng.generate(**kw)
    assert img.shape == (1, 64, 96, 3) and img.dtype == np.uint8
    lat = eng.generate(output_type="latent", **kw)
    sched = tsch.FlowMatchEulerScheduler.create(2, use_dynamic_shifting=True,
                                                mu=tsch.flow_match_shift_mu(HT * WT))
    noise = torch.randn((1, HT * WT, 16), generator=torch.Generator().manual_seed(5))
    pt = torch.from_numpy(pos).bfloat16()
    nt = torch.nn.functional.pad(torch.from_numpy(neg).bfloat16(), (0, 0, 0, 2))
    cos, sin = tqw.qwen_rope_cos_sin(eng.cfg, 1, HT, WT, TXT, device="cpu")
    want, skips = make_qwen_denoiser(eng.cfg, sched, 2, 3.0, eng.cache_config)(
        eng.params, noise, pt, nt, cos, sin)
    np.testing.assert_array_equal(lat, want.numpy())
    assert eng.last_cache_skips == skips
    z = flux_unpack_latents(want, HT, WT)
    dec = (twvae.wan_vae_decode(eng.vae_params, eng.vae_cfg, z[:, :, None])[:, 0] if wan_vae
           else tvae.vae_decode(eng.vae_params, eng.vae_cfg, z))
    np.testing.assert_array_equal(img, eng._to_uint8(dec))
    with pytest.raises(NotImplementedError, match="t2i, i2i are"):
        eng.generate(task="v2v", image=np.zeros((64, 96, 3), np.uint8), **kw)
    # true CFG without negative_prompt_embeds encodes the negative " ": this
    # checkpoint has no tokenizer/ (nor text_encoder/)
    with pytest.raises(FileNotFoundError, match="tokenizer/"):
        eng.generate(prompt="a fox", prompt_embeds=pos, true_cfg_scale=3.0)
    eng.generate(prompt_embeds=pos, height=64, width=96, num_inference_steps=1,
                 guidance_scale=1.0, output_type="latent")  # no negative without CFG
    # wan2.1-i2v is in the port now (tests/test_torch_wan.py); a name that
    # neither package knows raises, naming it
    with pytest.raises(NotImplementedError, match="hunyuan-video"):
        FastDMEngine(root, architecture="hunyuan-video", device="cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """Without a GPU the entry points raise unless the caller asks for the
    CPU: no quiet CPU run."""
    from fastdm_tpu_torch.engine import FastDMEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    cfg = tqw.QwenImageConfig(**TINY)
    root = str(tmp_path / "qwen-tiny")
    _write_checkpoint(root, wan_vae=True)
    for call in (lambda: tqw.qwen_init_random(0, cfg),
                 lambda: tqw.qwen_rope_cos_sin(cfg, 1, HT, WT, TXT),
                 lambda: FastDMEngine(root, architecture="qwen-image", verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
