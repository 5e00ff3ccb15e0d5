"""The port's FLUX transformer against the JAX package on a tiny config
(2 dual + 2 single blocks, 4 heads x 32), the JAX random params moved across
by the converter (jax.random cannot be reproduced by a torch.Generator).

Tolerances: float32 activations, relative L2 <= 1e-4 and max abs <= 1e-4
(the same bf16 weights; only f32 sum order differs); bfloat16 activations —
the denoiser's working dtype — relative L2 <= 1e-2 (bf16 rounds at the same
points, but a one-ulp flip anywhere propagates through eight residual adds);
weights loaded from one checkpoint by both loaders are bit-identical. W8A8
(int8 / fp8 block linears, the same quantized weights on both sides): bf16
forwards within relative L2 1e-2, as in bf16 — the int8 GEMMs are exact, but
a one-ulp bf16 difference upstream can move a per-token quantization step —
and the TeaCache forward within 2e-2 + 2e-2*|x|; the int8
and fp8 weights of flux_load bit-identical to quantize_weight of the JAX
package.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.caching.config import TeaCacheConfig as JTeaCache
from fastdm_tpu.caching.xcaching import cache_init_state as j_cache_init_state
from fastdm_tpu.models import flux as jflux
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu_torch.caching.config import TeaCacheConfig as TTeaCache
from fastdm_tpu_torch.caching.xcaching import cache_init_state as t_cache_init_state
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models.convert import flux_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_flux import _synthetic_state_dict  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

TINY = dict(num_layers=2, num_single_layers=2, attention_head_dim=32, num_attention_heads=4,
            joint_attention_dim=64, pooled_projection_dim=48, in_channels=16, out_channels=16,
            axes_dims_rope=(8, 12, 12), guidance_embeds=True, patch_size=1)
HT, WT, TXT = 4, 4, 7


@pytest.fixture(scope="module")
def models():
    jcfg = jflux.FluxConfig(quant=None, **TINY)
    tcfg = tflux.FluxConfig(quant=None, **TINY)
    jparams = jflux.flux_init_random(jax.random.key(0), jcfg)
    tparams = flux_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(seed: int, dtype: str):
    rng = np.random.default_rng(seed)
    arrs = dict(
        hidden=rng.standard_normal((1, HT * WT, TINY["in_channels"])),
        encoder=rng.standard_normal((1, TXT, TINY["joint_attention_dim"])),
        pooled=rng.standard_normal((1, TINY["pooled_projection_dim"])),
    )
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    j = {k: jnp.asarray(v, jd) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(td) for k, v in arrs.items()}
    return j, t


def _scalars(ts=0.7, guidance=3.5):
    return ((jnp.asarray([ts], jnp.float32), jnp.asarray([guidance], jnp.float32)),
            (torch.tensor([ts]), torch.tensor([guidance])))


def test_converter_keeps_every_parameter(models):
    jcfg, jparams, tcfg, tparams = models
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    assert len(tparams.dual_blocks) == 2 and len(tparams.single_blocks) == 2
    np.testing.assert_array_equal(
        _np(tparams.single_blocks[1].qkv_mlp.w),
        np.asarray(jax.device_get(jparams["single_blocks"]["qkv_mlp"]["w"][1]), np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flux_forward_matches_jax(models, dtype):
    jcfg, jparams, tcfg, tparams = models
    j, t = _inputs(1, dtype)
    (jt, jg), (tt, tg) = _scalars()
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    np.testing.assert_array_equal(_np(tcos), _np(jcos))
    want = jflux.flux_forward(jparams, jcfg, j["hidden"], j["encoder"], j["pooled"], jt,
                              jcos, jsin, guidance=jg)
    with torch.inference_mode():
        got = tflux.flux_forward(tparams, tcfg, t["hidden"], t["encoder"], t["pooled"], tt,
                                 tcos, tsin, guidance=tg)
    assert tuple(got.shape) == want.shape == (1, HT * WT, TINY["out_channels"])
    if dtype == "f32":
        assert _rel_l2(got, want) <= 1e-4
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-4)
    else:
        assert got.dtype == torch.bfloat16 and _rel_l2(got, want) <= 1e-2
    with pytest.raises(ValueError, match="guidance"):
        tflux.flux_forward(tparams, tcfg, t["hidden"], t["encoder"], t["pooled"], tt, tcos, tsin)


def test_flux_forward_cached_matches_jax(models):
    """TeaCache: step 0 computes (forced), a huge threshold then replays the
    residual; outputs, skip counts and the accumulator agree with JAX."""
    jcfg, jparams, tcfg, tparams = models
    coeffs = (4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01)
    jcc = JTeaCache(enable_caching=True, threshold=1e6, coefficients=coeffs)
    tcc = TTeaCache(enable_caching=True, threshold=1e6, coefficients=coeffs)
    shape = (1, HT * WT, tcfg.inner_dim)
    jstate = j_cache_init_state(jcc, shape, shape)
    tstate = t_cache_init_state(tcc, shape, shape, device="cpu")
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    for step, ts in enumerate((1.0, 0.8, 0.6)):
        j, t = _inputs(10 + step, "f32")
        (jt, jg), (tt, tg) = _scalars(ts)
        want, jstate = jflux.flux_forward_cached(
            jparams, jcfg, jcc, jstate, jnp.int32(step), 3, j["hidden"], j["encoder"],
            j["pooled"], jt, jcos, jsin, guidance=jg)
        with torch.inference_mode():
            got, tstate = tflux.flux_forward_cached(
                tparams, tcfg, tcc, tstate, step, 3, t["hidden"], t["encoder"], t["pooled"], tt,
                tcos, tsin, guidance=tg)
        assert tstate["skips"] == int(jstate["skips"]) == step
        # the replayed residual is stored in bf16 on both sides
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(float(tstate["accum"]), float(jstate["accum"]), rtol=1e-4)


def test_flux_load_matches_jax_loader():
    """One synthetic diffusers checkpoint through both loaders: identical
    weights, the same forward."""
    cfg_dict = {k: v for k, v in TINY.items()}
    sd = _synthetic_state_dict(cfg_dict, np.random.default_rng(3))
    jcfg = jflux.FluxConfig(quant=None, **TINY)
    tcfg = tflux.FluxConfig(quant=None, **TINY)
    jparams = jflux.flux_load(JSource(dict(sd)), jcfg)
    tparams = tflux.flux_load(TSource(dict(sd), device="cpu"), tcfg)
    via_jax = flux_params_from_numpy(jax.device_get(jparams), device="cpu")
    got_sd, want_sd = tparams.state_dict(), via_jax.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert got_sd[k].dtype == want_sd[k].dtype
        torch.testing.assert_close(got_sd[k], want_sd[k], rtol=0, atol=0, msg=k)
    # exhaustive consumption: a stray tensor is an error, as in JAX
    sd["stray.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="never consumed"):
        tflux.flux_load(TSource(dict(sd), device="cpu"), tcfg)


def test_w8a8_and_other_caches_wait_for_their_slices(models):
    """W8A8 has arrived (an int8 model builds and runs), and since the W4A4
    slice FLUX's FBCache and DiCache probes: a first step under each computes
    the uncached forward bit for bit and stores its residual; an unknown
    config raises."""
    _, _, tcfg, tparams = models
    import dataclasses

    params = tflux.flux_init_random(0, dataclasses.replace(tcfg, quant="int8"), device="cpu")
    assert params.single_blocks[0].qkv_mlp.w.dtype == torch.int8
    from fastdm_tpu_torch.caching.config import CacheConfig

    _, t = _inputs(5, "bf16")
    _, (tt, tg) = _scalars()
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    args = (t["hidden"], t["encoder"], t["pooled"], tt, tcos, tsin)
    shape = (1, HT * WT, tcfg.inner_dim)
    with torch.inference_mode():
        want = tflux.flux_forward(tparams, tcfg, *args, guidance=tg)
        for algo in ("fbcache", "dicache"):
            cfg = CacheConfig.from_dict({"cache_algorithm": algo, "enable_caching": True})
            state = t_cache_init_state(cfg, shape, shape, device="cpu")
            got, new = tflux.flux_forward_cached(tparams, tcfg, cfg, state, 0, 4, *args,
                                                 guidance=tg)
            assert torch.equal(got, want) and new["skips"] == 0
            assert new["prev_residual"].abs().sum() > 0
        with pytest.raises(ValueError, match="unsupported cache config"):
            tflux.flux_forward_cached(tparams, tcfg, object(), {}, 0, 1, *args, guidance=tg)


def test_flux_init_random_is_seeded_bf16(models):
    _, _, tcfg, _ = models
    a = tflux.flux_init_random(7, tcfg, device="cpu")
    b = tflux.flux_init_random(7, tcfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in a.parameters())
    for (ka, pa), (kb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(pa, pb)


# ------------------------------------------------------------------- W8A8


def test_flux_config_defaults_match_jax():
    """quant defaults to int8 and quant_mods to False, as in the JAX FluxConfig."""
    t, j = tflux.FluxConfig(), jflux.FluxConfig()
    assert (t.quant, t.quant_mods) == (j.quant, j.quant_mods) == ("int8", False)


@pytest.fixture(scope="module", params=["int8", "fp8"])
def w8a8_models(request):
    jcfg = jflux.FluxConfig(quant=request.param, **TINY)
    tcfg = tflux.FluxConfig(quant=request.param, **TINY)
    jparams = jflux.flux_init_random(jax.random.key(4), jcfg)
    tparams = flux_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_converter_carries_w8a8_qlinears(w8a8_models):
    jcfg, jparams, _, tparams = w8a8_models
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    lin = tparams.single_blocks[1].proj_out
    jw = np.asarray(jax.device_get(jparams["single_blocks"]["proj_out"]["w"][1]))
    dtype = torch.int8 if jcfg.quant == "int8" else torch.float8_e4m3fn
    assert lin.w.dtype == dtype and lin.w.stride(0) == 1  # K-contiguous storage
    np.testing.assert_array_equal(lin.w.view(torch.uint8).numpy(), jw.view(np.uint8))
    assert (lin.colsum is not None) == (jcfg.quant == "int8")
    assert tparams.dual_blocks[0].norm1.linear.w.dtype == torch.bfloat16  # quant_mods=False


def test_flux_forward_w8a8_matches_jax(w8a8_models):
    jcfg, jparams, tcfg, tparams = w8a8_models
    j, t = _inputs(2, "bf16")
    (jt, jg), (tt, tg) = _scalars(0.6)
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    want = jflux.flux_forward(jparams, jcfg, j["hidden"], j["encoder"], j["pooled"], jt,
                              jcos, jsin, guidance=jg)
    with torch.inference_mode():
        got = tflux.flux_forward(tparams, tcfg, t["hidden"], t["encoder"], t["pooled"], tt,
                                 tcos, tsin, guidance=tg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel_l2(got, want) <= 1e-2


def test_flux_forward_cached_w8a8_matches_jax(w8a8_models):
    """TeaCache over three steps on the W8A8 model: the same compute/replay
    decisions as JAX and outputs within the stated bound."""
    jcfg, jparams, tcfg, tparams = w8a8_models
    coeffs = (4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01)
    jcc = JTeaCache(enable_caching=True, threshold=1e6, coefficients=coeffs)
    tcc = TTeaCache(enable_caching=True, threshold=1e6, coefficients=coeffs)
    shape = (1, HT * WT, tcfg.inner_dim)
    jstate = j_cache_init_state(jcc, shape, shape)
    tstate = t_cache_init_state(tcc, shape, shape, device="cpu")
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    for step, ts in enumerate((1.0, 0.8, 0.6)):
        j, t = _inputs(20 + step, "bf16")
        (jt, jg), (tt, tg) = _scalars(ts)
        want, jstate = jflux.flux_forward_cached(
            jparams, jcfg, jcc, jstate, jnp.int32(step), 3, j["hidden"], j["encoder"],
            j["pooled"], jt, jcos, jsin, guidance=jg)
        with torch.inference_mode():
            got, tstate = tflux.flux_forward_cached(
                tparams, tcfg, tcc, tstate, step, 3, t["hidden"], t["encoder"], t["pooled"], tt,
                tcos, tsin, guidance=tg)
        assert tstate["skips"] == int(jstate["skips"]) == step
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def _jax_quantize_weight_path(monkeypatch):
    """Make the JAX loader quantize through quantize_weight (its jnp path)
    instead of its native host library."""
    from fastdm_tpu import native

    monkeypatch.setattr(native, "get_lib", lambda: None)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("quant_mods", [False, True])
def test_flux_load_w8a8_matches_quantize_weight(monkeypatch, quant, quant_mods):
    """One synthetic checkpoint: the port's load-time quantization gives the
    same int8 / fp8 weights, scales and colsums as the JAX package's
    quantize_weight; quant_mods decides whether the AdaLN linears are
    quantized, as in JAX."""
    sd = _synthetic_state_dict(dict(TINY), np.random.default_rng(5))
    jcfg = jflux.FluxConfig(quant=quant, quant_mods=quant_mods, **TINY)
    tcfg = tflux.FluxConfig(quant=quant, quant_mods=quant_mods, **TINY)
    tparams = tflux.flux_load(TSource(dict(sd), device="cpu"), tcfg)
    _jax_quantize_weight_path(monkeypatch)
    via_jax = flux_params_from_numpy(jax.device_get(jflux.flux_load(JSource(dict(sd)), jcfg)),
                                     device="cpu")
    got_sd, want_sd = tparams.state_dict(), via_jax.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert got_sd[k].dtype == want_sd[k].dtype, k
        assert torch.equal(got_sd[k].view(torch.uint8) if got_sd[k].dtype.itemsize == 1
                           else got_sd[k], want_sd[k].view(torch.uint8)
                           if want_sd[k].dtype.itemsize == 1 else want_sd[k]), k
    mod_dtype = tparams.dual_blocks[0].norm1.linear.w.dtype
    assert (mod_dtype != torch.bfloat16) == quant_mods
    assert tparams.proj_out.w.dtype == tparams.x_embedder.w.dtype == torch.bfloat16
