"""The port's W4A4 path (int4 / int4p QLinears, the SVDQuant low-rank branch)
and FLUX's FBCache / DiCache probes against the JAX package on the CPU,
mirroring tests/test_int4.py. Inputs come from numpy seeds; JAX random
params are moved across by the converter (jax.random cannot be reproduced by
a torch.Generator).

Tolerances: quantize_to_int4 (q, scale), int4_matmul (with and without
bias, in bf16, the model's dtype) and pack_int4 / unpack_int4 (packed in one
package and unpacked in the other, both ways) bit-exact: integer math,
correctly rounded divisions, the epilogue in the same order; int4_matmul
with a bias into f32 within one f32 spacing of the product plus one of the
result (XLA contracts the jitted epilogue's product and bias add into one
FMA, so JAX rounds once where the op's contract rounds twice). qlinear_apply on a JAX
tree: the int4 product is exact on both sides, so the outputs differ only
where the bf16 low-rank side path (two bf16 matmuls, f32 sums in another
order) rounds differently: within 2 bf16 ulp of |JAX|. The low-rank
approximation recovers a rank-8 matrix within 5e-3 (JAX's bound); the port's
own int4 quantize_weight reconstructs a weight within 0.12 of its max (JAX's
bound) and absorbs outliers: W4A4 at least 10x closer than plain int4 and
within 2.5x of int8 (JAX's claim). The tiny FLUX int4 / int4p quant_mods
forwards (bf16) within relative L2 2e-2 of JAX: the quantized GEMMs are
exact, but a one-ulp bf16 difference upstream (SiLU, GELU, the norms) can
move a per-token int4 step, a coarser step than int8's 1e-2 allows for. The
FBCache / DiCache cached forwards (3 steps): the same skip decisions as JAX on every
step (thresholds far from every accumulated error), outputs within 2e-2 +
2e-2*|x|. The tiny Wan int4p split-QKV forward within relative L2 2e-2 of
JAX's split form, and equal to the port's fused one bit for bit.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.caching.config import DiCacheConfig as JDiCache
from fastdm_tpu.caching.config import FBCacheConfig as JFBCache
from fastdm_tpu.caching.xcaching import cache_init_state as j_cache_init_state
from fastdm_tpu.kernels.jnp_backend import impl as jimpl
from fastdm_tpu.layers import qlinear as jql
from fastdm_tpu.models import flux as jflux
from fastdm_tpu.models import wan as jwan
from fastdm_tpu_torch.caching.config import DiCacheConfig as TDiCache
from fastdm_tpu_torch.caching.config import FBCacheConfig as TFBCache
from fastdm_tpu_torch.caching.xcaching import cache_init_state as t_cache_init_state
from fastdm_tpu_torch.kernels import int4_matmul, quantize_to_int4
from fastdm_tpu_torch.layers import qlinear as tql
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models import wan as twan
from fastdm_tpu_torch.models.convert import (
    _linear_converter,
    flux_params_from_numpy,
    wan_params_from_numpy,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_wan import TINY as WAN_TINY  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

FLUX_TINY = dict(num_layers=2, num_single_layers=2, attention_head_dim=32,
                 num_attention_heads=4, joint_attention_dim=64, pooled_projection_dim=48,
                 in_channels=16, out_channels=16, axes_dims_rope=(8, 12, 12),
                 guidance_embeds=True, patch_size=1)
HT, WT, TXT = 4, 4, 7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    """Exact bit patterns: bf16 as uint16, the rest as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_to_int4_bit_exact_with_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((33, 96)) * 3.0).astype(np.float32)
    x[4] = 0.0  # the 1e-12 scale floor
    x[7] *= 1e-30  # a row of subnormal-sized values
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, js = jimpl.quantize_to_int4_jnp(jnp.asarray(x, jd))
    tq, ts = quantize_to_int4(torch.from_numpy(x).to(td))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == (33, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert int(tq.min()) >= -8 and int(tq.max()) <= 7


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("bias", [True, False])
def test_int4_matmul_bit_exact_with_jax(out, bias):
    rng = np.random.default_rng(1)
    a = rng.integers(-8, 8, (19, 160)).astype(np.int8)
    b = rng.integers(-8, 8, (160, 40)).astype(np.int8)
    sa = (rng.random((19, 1)) * 0.1 + 1e-3).astype(np.float32)
    sb = (rng.random(40) * 0.01 + 1e-4).astype(np.float32)
    bb = (rng.standard_normal(40) * 0.5).astype(np.float32) if bias else None
    jd, td = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    want = jimpl.int4_matmul_jnp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                                 jnp.asarray(sb), jd,
                                 None if bb is None else jnp.asarray(bb, jnp.bfloat16))
    got = int4_matmul(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(sa),
                      torch.from_numpy(sb), td,
                      None if bb is None else torch.from_numpy(bb).bfloat16())
    assert got.dtype == td
    if out == "f32" and bias:
        # the jitted jnp epilogue is contracted by XLA into one FMA, f32(acc) *
        # (sa * sb) + bias rounded once; the port (and its kernel) rounds the
        # product and the sum apart, as the op's contract states: the two
        # differ by at most the product's rounding plus the sum's
        prod = np.abs((a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32) * (sa * sb))
        diff = np.abs(_np(got) - _np(want))
        assert (diff <= np.spacing(prod) + np.spacing(np.abs(_np(want)))).all()
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pack_unpack_int4_cross_bit_exact_with_jax():
    """Packed by JAX and unpacked by the port, packed by the port and unpacked
    by JAX, and the packed bytes themselves: identical; the port's packed
    weight is the (K/2, N) view of a K-contiguous buffer."""
    rng = np.random.default_rng(2)
    q = rng.integers(-8, 8, (3, 64, 48)).astype(np.int8)
    jp = np.array(jql.pack_int4(jnp.asarray(q)))
    tp = tql.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tql.unpack_int4(torch.from_numpy(jp)).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jql.unpack_int4(jnp.asarray(tp.numpy()))), q)
    w = tql.k_contiguous(torch.from_numpy(q[0]))
    p = tql.pack_int4(w)
    assert tuple(p.shape) == (32, 48) and p.stride(0) == 1
    np.testing.assert_array_equal(tql.unpack_int4(p).numpy(), q[0])
    with pytest.raises(ValueError, match="even K"):
        tql.pack_int4(torch.from_numpy(q[:, :63]))


# ----------------------------------------------------- SVDQuant weights


def test_lowrank_approx_recovers_low_rank_matrix():
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal((96, 8)) @ rng.standard_normal((8, 64)))
                         .astype(np.float32))
    u, v = tql._lowrank_approx(w, rank=8)
    assert u.dtype == v.dtype == torch.float32 and tuple(u.shape) == (96, 8)
    np.testing.assert_allclose(_np(u @ v), _np(w), atol=5e-3)


@pytest.mark.parametrize("quant", ["int4", "int4p"])
def test_quantize_weight_int4_reconstructs(quant):
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.standard_normal((128, 64)) * 0.02).astype(np.float32))
    lin = tql.quantize_weight(w, quant, torch.ones(64))
    q4 = lin.w4 if quant == "int4" else tql.unpack_int4(lin.w4p)
    recon = q4.float() * lin.scale[None, :] + lin.lora_u.float() @ lin.lora_v.float()
    err = float((recon - w).abs().max() / w.abs().max())
    assert err < 0.12, err
    assert lin.bias.dtype == torch.bfloat16
    if quant == "int4p":  # the same values as int4, packed
        np.testing.assert_array_equal(q4.numpy(), tql.quantize_weight(w, "int4").w4.numpy())


def test_lowrank_branch_absorbs_outliers():
    """The SVDQuant claim on the port's own quantize_weight: on an outlier
    column and row, W4A4 is at least 10x closer than plain int4 and within
    2.5x of int8."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((256, 128)) * 0.02).astype(np.float32)
    w[:, 7] *= 40.0
    w[3, :] *= 25.0
    w = torch.from_numpy(w)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32)).bfloat16()
    ref = x.float() @ w

    def rel_err(y):
        return float((y.float() - ref).abs().max() / ref.abs().max())

    e4 = rel_err(tql.quantize_weight(w, "int4")(x))
    e8 = rel_err(tql.quantize_weight(w, "int8")(x))
    s = (w.abs().amax(dim=0).clamp_min(1e-12) / 7.0)
    plain = tql.QLinear(None, None, s, w4=torch.round(w / s).clamp(-8, 7).to(torch.int8),
                        lora_u=torch.zeros(256, 1, dtype=torch.bfloat16),
                        lora_v=torch.zeros(1, 128, dtype=torch.bfloat16))
    ep = rel_err(plain(x))
    assert e4 < ep / 10, (e4, ep)
    assert e4 < e8 * 2.5, (e4, e8)


# ------------------------------------------------------------ QLinear


@pytest.fixture(scope="module", params=["int4", "int4p"])
def w4_pair(request):
    w = jax.random.normal(jax.random.key(13), (128, 64), jnp.float32) * 0.02
    w = w.at[:, 3].mul(30.0)
    jp = jql.quantize_weight(w, request.param, jnp.ones((64,), jnp.float32))
    tp = _linear_converter(torch.device("cpu"))(jax.device_get(jp))
    return request.param, jp, tp


def test_converter_carries_w4a4_leaves(w4_pair):
    quant, jp, tp = w4_pair
    key = "w4" if quant == "int4" else "w4p"
    w = getattr(tp, key)
    assert tp.w is None and w.dtype == torch.int8 and w.stride(0) == 1
    np.testing.assert_array_equal(w.numpy(), np.asarray(jp[key]))
    for k in ("scale", "lora_u", "lora_v", "bias"):
        np.testing.assert_array_equal(_bits(getattr(tp, k)), _bits(jp[k]))


@pytest.mark.parametrize("chunk_tokens", [0, 4])
def test_qlinear_apply_w4a4_matches_jax(w4_pair, chunk_tokens):
    _, jp, tp = w4_pair
    x = np.random.default_rng(6).standard_normal((2, 8, 128)).astype(np.float32)
    want = jql.qlinear_apply(jp, jnp.asarray(x, jnp.bfloat16), chunk_tokens)
    got = tql.qlinear_apply(tp, torch.from_numpy(x).bfloat16(), chunk_tokens)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 8, 64)
    assert (np.abs(_np(got) - _np(want)) <= 2 * _bf16_ulp(_np(want))).all()
    np.testing.assert_array_equal(_bits(got), _bits(tql.qlinear_apply(tp, torch.from_numpy(x)
                                                                     .bfloat16())))


def test_qlinear_slice_out_w4a4_is_exact(w4_pair):
    """Sliced columns of w4 / w4p (rows of the K-contiguous buffer, no copy),
    scale, bias and lora_v; lora_u passed through: exact."""
    quant, jp, tp = w4_pair
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 128))
                         .astype(np.float32)).bfloat16()
    part = tql.qlinear_slice_out(tp, 10, 40)
    w, pw = (tp.w4, part.w4) if quant == "int4" else (tp.w4p, part.w4p)
    assert pw.data_ptr() == w[:, 10:].data_ptr()
    assert part.lora_u.data_ptr() == tp.lora_u.data_ptr()
    np.testing.assert_array_equal(_bits(part(x)), _bits(tp(x)[:, 10:40]))
    jpart = jql.qlinear_slice_out(jp, 10, 40)
    np.testing.assert_array_equal(_bits(part.lora_v), _bits(jpart["lora_v"]))


# ---------------------------------------------------------------- FLUX


@functools.lru_cache(maxsize=None)
def _flux_models(quant: str):
    """The tiny FLUX in `quant` with quant_mods, JAX's random params and the
    port's converted copy."""
    jcfg = jflux.FluxConfig(quant=quant, quant_mods=True, **FLUX_TINY)
    tcfg = tflux.FluxConfig(quant=quant, quant_mods=True, **FLUX_TINY)
    jparams = jflux.flux_init_random(jax.random.key(8), jcfg)
    tparams = flux_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(params=["int4", "int4p"])
def flux_models(request):
    return _flux_models(request.param)


def _flux_inputs(seed: int, ts: float = 0.6):
    rng = np.random.default_rng(seed)
    arrs = dict(hidden=rng.standard_normal((1, HT * WT, FLUX_TINY["in_channels"])),
                encoder=rng.standard_normal((1, TXT, FLUX_TINY["joint_attention_dim"])),
                pooled=rng.standard_normal((1, FLUX_TINY["pooled_projection_dim"])))
    j = [jnp.asarray(arrs[k], jnp.bfloat16) for k in ("hidden", "encoder", "pooled")]
    t = [torch.from_numpy(arrs[k].astype(np.float32)).bfloat16()
         for k in ("hidden", "encoder", "pooled")]
    j += [jnp.asarray([ts], jnp.float32)]
    t += [torch.tensor([ts])]
    return j, t


def _flux_rope(jcfg, tcfg):
    return jflux.flux_rope_cache(jcfg, TXT, HT, WT), tflux.flux_rope_cache(tcfg, TXT, HT, WT,
                                                                           device="cpu")


def test_flux_w4a4_quant_mods_params(flux_models):
    """Block linears and AdaLN modulations in W4A4 (quant_mods), embedders
    and the output head in bf16; every JAX leaf carried across."""
    jcfg, jparams, _, tparams = flux_models
    assert sum(p.numel() for p in tparams.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))
    key = "w4" if jcfg.quant == "int4" else "w4p"
    for lin in (tparams.single_blocks[0].qkv_mlp, tparams.dual_blocks[1].norm1.linear,
                tparams.single_blocks[1].norm.linear):
        assert getattr(lin, key) is not None and lin.w is None
    assert tparams.proj_out.w.dtype == torch.bfloat16


def test_flux_forward_w4a4_matches_jax(flux_models):
    jcfg, jparams, tcfg, tparams = flux_models
    j, t = _flux_inputs(9)
    (jcos, jsin), (tcos, tsin) = _flux_rope(jcfg, tcfg)
    want = jax.jit(lambda p, a, c, s: jflux.flux_forward(p, jcfg, *a, c, s,
                                                         guidance=jnp.asarray([3.5])))(
        jparams, j, jcos, jsin)
    with torch.inference_mode():
        got = tflux.flux_forward(tparams, tcfg, *t, tcos, tsin, guidance=torch.tensor([3.5]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.isfinite(_np(got)).all()
    assert _rel_l2(got, want) <= 2e-2


# (config pair, steps): FBCache computes steps 0-1 (warmup 1), DiCache steps
# 0-1 (ret_ratio 0.34 of 3 steps), then a threshold far above every
# accumulated error skips the last; DiCache's third step replays the
# two-point extrapolation of its last two residuals
CACHES = {
    "fbcache": (dict(enable_caching=True, threshold=1e6, warmup_steps=1), JFBCache, TFBCache),
    "dicache": (dict(enable_caching=True, threshold=1e6, probe_depth=1, ret_ratio=0.34),
                JDiCache, TDiCache),
    "dicache-depth2": (dict(enable_caching=True, threshold=1e6, probe_depth=2, ret_ratio=0.34),
                       JDiCache, TDiCache),
}


@pytest.mark.parametrize("algo", sorted(CACHES))
def test_flux_forward_cached_fb_di_match_jax(algo):
    """flux_forward_cached under FBCache and DiCache over 3 steps on the int4p
    quant_mods model (the main path): the same compute / skip decisions as
    JAX, skips where expected, outputs and the accumulator within the stated
    bounds."""
    jcfg, jparams, tcfg, tparams = _flux_models("int4p")
    kw, jcls, tcls = CACHES[algo]
    jcc, tcc = jcls(**kw), tcls(**kw)
    shape = (1, HT * WT, tcfg.inner_dim)
    jstate = j_cache_init_state(jcc, shape, shape)
    tstate = t_cache_init_state(tcc, shape, shape, device="cpu")
    (jcos, jsin), (tcos, tsin) = _flux_rope(jcfg, tcfg)
    # one compile for the three steps (the step index is traced)
    jfwd = jax.jit(lambda p, st, i, a, c, s: jflux.flux_forward_cached(
        p, jcfg, jcc, st, i, 3, *a, c, s, guidance=jnp.asarray([3.5])))
    for step, ts in enumerate((1.0, 0.7, 0.4)):
        j, t = _flux_inputs(30 + step, ts)
        want, jstate = jfwd(jparams, jstate, jnp.int32(step), j, jcos, jsin)
        with torch.inference_mode():
            got, tstate = tflux.flux_forward_cached(tparams, tcfg, tcc, tstate, step, 3, *t,
                                                    tcos, tsin, guidance=torch.tensor([3.5]))
        assert tstate["skips"] == int(jstate["skips"]) == max(0, step - 1)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(float(tstate["accum"]), float(jstate["accum"]), rtol=2e-2)


def test_flux_cached_forced_skip_replays_the_residual():
    """A skipped FBCache step returns the embedded input plus the stored
    residual through the output head, bit for bit; a skipped DiCache step
    the probe blocks' output plus it."""
    _, _, tcfg, tparams = _flux_models("int4p")
    _, t = _flux_inputs(40)
    _, (tcos, tsin) = _flux_rope(tcfg, tcfg)
    g = torch.tensor([3.5])
    shape = (1, HT * WT, tcfg.inner_dim)
    with torch.inference_mode():
        for cc in (TFBCache(enable_caching=True, threshold=1e9, warmup_steps=0),
                   TDiCache(enable_caching=True, threshold=1e9, probe_depth=1, ret_ratio=0.0)):
            st0 = t_cache_init_state(cc, shape, shape, device="cpu")
            _, st1 = tflux.flux_forward_cached(tparams, tcfg, cc, st0, 0, 2, *t, tcos, tsin,
                                               guidance=g)
            out, st2 = tflux.flux_forward_cached(tparams, tcfg, cc, st1, 1, 2, *t, tcos, tsin,
                                                 guidance=g)
            hidden, temb, encoder = tflux._flux_embed(tparams, tcfg, t[0], t[1], t[2], t[3], g)
            if isinstance(cc, TDiCache):
                hidden, _ = tflux._run_dual(tparams, tcfg, hidden, encoder, temb, tcos, tsin,
                                            stop=1)
            replay = (hidden + st1["prev_residual"]).to(hidden.dtype)
            want = tparams.proj_out(tparams.norm_out(replay, temb))
            assert (st1["skips"], st2["skips"]) == (0, 1) and torch.equal(out, want)


# ---------------------------------------------------------------- Wan


def test_wan_int4p_forward_matches_jax():
    """The same QLinear serves Wan2.2-A14B's int4p default: the tiny Wan
    transformer in int4p with split QKV (column slices of the packed buffer,
    chunked FFN) against JAX's split form, and bit for bit equal to the
    port's fused form (per-row quantization, the same low-rank branch
    columns)."""
    common = dict(WAN_TINY, text_len=8, quant="int4p")
    jcfg, tcfg = jwan.WanConfig(**common), twan.WanConfig(**common)
    jparams = jax.jit(lambda k: jwan.wan_init_random(k, jcfg))(jax.random.key(0))
    tparams = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
    assert tparams.blocks[0].attn1.qkv.w4p is not None
    rng = np.random.default_rng(11)
    video = rng.standard_normal((1, WAN_TINY["in_channels"], 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((1, 8, WAN_TINY["text_dim"])).astype(np.float32)
    kw = dict(split_qkv_proj=True, ffn_chunk_tokens=64)
    split_cfg = dataclasses.replace(jcfg, **kw)
    want = jax.jit(lambda p, *a: jwan.wan_forward(p, split_cfg, *a))(
        jparams, jnp.asarray(video, jnp.bfloat16), jnp.full((1,), 500.0),
        jnp.asarray(text, jnp.bfloat16))
    args = (torch.from_numpy(video).bfloat16(), torch.full((1,), 500.0),
            torch.from_numpy(text).bfloat16())
    with torch.inference_mode():
        split = twan.wan_forward(tparams, dataclasses.replace(tcfg, **kw), *args)
        fused = twan.wan_forward(tparams, tcfg, *args)
    assert tuple(split.shape) == want.shape and np.isfinite(_np(split)).all()
    assert _rel_l2(split, want) <= 2e-2
    assert torch.equal(split, fused)


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("flags,match", [
    (dict(use_int8=True, use_int4=True), "mutually exclusive"),
    (dict(use_fp8=True, use_int4=True), "mutually exclusive"),
    (dict(pack_int4=True), "pack_int4 requires"),
    (dict(use_int8=True, pack_int4=True), "pack_int4 requires"),
])
def test_engine_int4_flag_checks_raise_as_jax(flags, match):
    from fastdm_tpu.engine import FastDMEngine as JEngine
    from fastdm_tpu_torch.engine import FastDMEngine as TEngine

    for engine in (JEngine, TEngine):
        with pytest.raises(ValueError, match=match):
            engine("/nonexistent", architecture="flux", **flags)
