"""The port's pipeline (scheduler, TeaCache, VAE decoder, FLUX denoise loop,
engine) against the JAX package on tiny configs.

Tolerances: scheduler sigmas and steps, latent packing and the TeaCache skip
sequence are exact; the VAE's conv and GroupNorm layers within one bf16 ulp
and its spatial attention within 2e-2 + 1e-2*|x|; the whole bf16 VAE decoder,
relative L2 <= 6e-2 — XLA and PyTorch round bf16 SiLU differently on ~40% of
the elements (one ulp each, measured), and twenty random-weight convs with
residual adds amplify that to 3-4%; a wrong layout or weight mapping is off
by O(1). The bf16 denoise loop, relative L2 <= 2e-2 on the latents after
three steps. The VAE comparisons
set torch.backends.{cudnn,cuda.matmul}.allow_tf32 = False (inert on the CPU,
binding where the same test runs on a GPU).
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.caching import xcaching as jx
from fastdm_tpu.caching.config import TeaCacheConfig as JTeaCache
from fastdm_tpu.models import flux as jflux
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline import denoise as jden
from fastdm_tpu.pipeline import schedulers as jsch
from fastdm_tpu.pipeline import vae as jvae
from fastdm_tpu_torch.caching import xcaching as tx
from fastdm_tpu_torch.caching.config import TeaCacheConfig as TTeaCache
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models.convert import flux_params_from_numpy, vae_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import denoise as tden
from fastdm_tpu_torch.pipeline import schedulers as tsch
from fastdm_tpu_torch.pipeline import vae as tvae

sys.path.insert(0, os.path.dirname(__file__))
from test_engine_e2e import TINY, _flux_transformer_sd, _vae_sd, _write_st  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

FLUX_TEACACHE = (4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01)
VAE_TINY = dict(latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=4, scaling_factor=0.5, shift_factor=0.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def no_tf32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------- scheduler


@pytest.mark.parametrize("steps", [1, 4, 25])
@pytest.mark.parametrize("dynamic", [True, False])
def test_flow_match_sigmas_equal_jax(steps, dynamic):
    kw = dict(use_dynamic_shifting=True, mu=tsch.flow_match_shift_mu(64 * 128)) if dynamic \
        else dict(shift=3.0)
    assert tsch.flow_match_shift_mu(4096) == jsch.flow_match_shift_mu(4096)
    t = tsch.FlowMatchEulerScheduler.create(steps, **kw)
    j = jsch.FlowMatchEulerScheduler.create(steps, **kw)
    assert t.sigmas.dtype == np.float32
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    rng = np.random.default_rng(steps)
    x, v = rng.standard_normal((2, 3, 5)).astype(np.float32), rng.standard_normal((2, 3, 5))
    v = v.astype(np.float32)
    for i in range(steps):
        np.testing.assert_array_equal(
            _np(t.step(torch.from_numpy(v), i, torch.from_numpy(x))),
            _np(j.step(jnp.asarray(v), i, jnp.asarray(x), jnp.asarray(j.sigmas))))


def test_pack_unpack_latents_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 8, 6)).astype(np.float32)
    packed = tden.flux_pack_latents(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(packed), _np(jden.flux_pack_latents(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(tden.flux_unpack_latents(packed, 4, 3)), x)


# ----------------------------------------------------------------- teacache


@pytest.mark.parametrize("threshold", [0.1, 0.3, 1.0])
def test_teacache_skip_sequence_matches_jax(threshold):
    """Twelve steps of probes whose drift varies: the port decides to compute
    or replay on exactly the steps the JAX package does."""
    rng = np.random.default_rng(4)
    shape, n = (1, 16, 8), 12
    drift = rng.uniform(0.002, 0.2, n)
    probes = [rng.standard_normal(shape).astype(np.float32)]
    for i in range(1, n):
        probes.append(probes[-1] + drift[i] * rng.standard_normal(shape).astype(np.float32))
    hidden = rng.standard_normal(shape).astype(np.float32)
    jcfg = JTeaCache(enable_caching=True, threshold=threshold, coefficients=FLUX_TEACACHE)
    tcfg = TTeaCache(enable_caching=True, threshold=threshold, coefficients=FLUX_TEACACHE)
    js = jx.cache_init_state(jcfg, shape, shape)
    ts = tx.cache_init_state(tcfg, shape, shape, device="cpu")
    j_seq, t_seq = [], []
    for i in range(n):
        jp, tp = jnp.asarray(probes[i], jnp.bfloat16), torch.from_numpy(probes[i]).bfloat16()
        jh, th = jnp.asarray(hidden * (1 + i)), torch.from_numpy(hidden * (1 + i))
        j_skips, t_skips = int(js["skips"]), ts["skips"]
        jo, js = jx.cached_run(jcfg, js, jnp.int32(i), n, jh, None,
                               lambda h, e: (jp, (h, e)), lambda h, e: h * 0.5 + 1.0)
        to, ts = tx.cached_run(tcfg, ts, i, n, th, None,
                               lambda h, e: (tp, (h, e)), lambda h, e: h * 0.5 + 1.0)
        j_seq.append(int(js["skips"]) == j_skips)
        t_seq.append(ts["skips"] == t_skips)
        np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-6, atol=1e-6)
    assert t_seq == j_seq  # True = computed
    assert t_seq[0] and (threshold == 0.1 or not all(t_seq))


# ---------------------------------------------------------------------- vae


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_vae_layers_match_jax(no_tf32):
    """conv2d (3x3 and 1x1), GroupNorm, nearest upsample and the mid-block
    spatial attention on the same bf16 activations (NHWC in JAX, NCHW here)."""
    from fastdm_tpu.layers import conv2d as jc
    from fastdm_tpu_torch.layers import conv2d as tc

    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 6, 5, 8)).astype(np.float32)  # NHWC
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)
    nchw = lambda a: np.transpose(_np(a), (0, 3, 1, 2))  # noqa: E731
    ulp = lambda a: np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126))) - 7)  # noqa: E731
    for k in (3, 1):
        w = (rng.standard_normal((k, k, 8, 12)) * 0.1).astype(np.float32)
        b = (rng.standard_normal(12) * 0.1).astype(np.float32)
        jp = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)}
        tp = vae_params_from_numpy({"c": jax.device_get(jp)}, device="cpu")["c"]
        want, got = nchw(jc.conv2d(jp, xj)), _np(tc.conv2d(tp, xt))
        assert (np.abs(got - want) <= ulp(want)).all()
    g = {"gamma": rng.standard_normal(8).astype(np.float32),
         "beta": rng.standard_normal(8).astype(np.float32)}
    want = nchw(jc.group_norm({k: jnp.asarray(v) for k, v in g.items()}, xj, 4))
    got = _np(tc.group_norm({k: torch.from_numpy(v) for k, v in g.items()}, xt, 4))
    assert (np.abs(got - want) <= ulp(want)).all()
    np.testing.assert_array_equal(_np(tc.upsample_nearest2x(xt)),
                                  nchw(jc.upsample_nearest2x(xj)))
    attn = {n: {"w": jnp.asarray(rng.standard_normal((8, 8)) * 0.2, jnp.bfloat16),
                "b": jnp.asarray(rng.standard_normal(8) * 0.1, jnp.float32)}
            for n in ("q", "k", "v", "out")}
    attn["norm"] = {"gamma": jnp.ones(8), "beta": jnp.zeros(8)}
    tattn = vae_params_from_numpy(jax.device_get(attn), device="cpu")
    want = nchw(jvae._spatial_attention(attn, xj, 4))
    got = _np(tvae._spatial_attention(tattn, xt, 4))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-2)


def test_vae_decode_matches_jax(no_tf32):
    jcfg, tcfg = jvae.VAEConfig(**VAE_TINY), tvae.VAEConfig(**VAE_TINY)
    jparams = jax.jit(lambda k: jvae.vae_decoder_random(k, jcfg))(jax.random.key(2))
    tparams = vae_params_from_numpy(jax.device_get(jparams), device="cpu")
    z = np.random.default_rng(5).standard_normal((1, 4, 8, 6)).astype(np.float32)
    want = jax.jit(lambda p, x: jvae.vae_decode(p, jcfg, x))(jparams, jnp.asarray(z))
    got = tvae.vae_decode(tparams, tcfg, torch.from_numpy(z))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 64, 48, 3)
    assert _rel_l2(got, want) <= 6e-2


def test_vae_load_matches_jax_loader(no_tf32):
    """Full synthetic AutoencoderKL (encoder too) through both loaders."""
    sd = _vae_sd(np.random.default_rng(6))
    jcfg, tcfg = jvae.VAEConfig(**VAE_TINY), tvae.VAEConfig(**VAE_TINY)
    jparams = jvae.vae_load(JSource(dict(sd)), jcfg)
    tparams = tvae.vae_load(TSource(dict(sd), device="cpu"), tcfg)
    assert "encoder" in tparams and len(tparams["encoder"]["down"]) == 4
    via_jax = vae_params_from_numpy(jax.device_get(jparams), device="cpu")
    torch.testing.assert_close(tparams["up"][2]["upsample"]["w"], via_jax["up"][2]["upsample"]["w"],
                               rtol=0, atol=0)
    z = np.random.default_rng(7).standard_normal((1, 4, 4, 4)).astype(np.float32)
    want = jax.jit(lambda p, x: jvae.vae_decode(p, jcfg, x))(
        {k: v for k, v in jparams.items() if k != "encoder"}, jnp.asarray(z))
    assert _rel_l2(tvae.vae_decode(tparams, tcfg, torch.from_numpy(z)), want) <= 6e-2


def test_vae_decoder_random_is_seeded():
    cfg = tvae.VAEConfig(**VAE_TINY)
    a = tvae.vae_decoder_random(3, cfg, device="cpu")
    b = tvae.vae_decoder_random(3, cfg, device="cpu")
    assert torch.equal(a["conv_in"]["w"], b["conv_in"]["w"])
    assert a["conv_in"]["w"].shape == (8, 4, 3, 3) and a["conv_in"]["w"].dtype == torch.bfloat16


# ------------------------------------------------------------- denoise loop


@functools.lru_cache(maxsize=None)
def _flux_random_pair():
    """JAX's random bf16 FLUX at TINY (one init for both cases) and the
    port's converted copy."""
    jparams = jflux.flux_init_random(jax.random.key(1), jflux.FluxConfig(quant=None, **TINY))
    return jparams, flux_params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.mark.parametrize("cached", [False, True])
def test_make_flux_denoiser_matches_jax(cached):
    """Same params, same numpy latents and conditioning, three steps."""
    fcfg = {k: v for k, v in TINY.items()}
    jcfg, tcfg = jflux.FluxConfig(quant=None, **fcfg), tflux.FluxConfig(quant=None, **fcfg)
    jparams, tparams = _flux_random_pair()
    ht = wt = 4
    mu = tsch.flow_match_shift_mu(ht * wt)
    steps = 3
    jcc = tcc = None
    if cached:
        jcc = JTeaCache(enable_caching=True, threshold=0.3, coefficients=(1.0, 0.0))
        tcc = TTeaCache(enable_caching=True, threshold=0.3, coefficients=(1.0, 0.0))
    jrun = jden.make_flux_denoiser(
        jcfg, jsch.FlowMatchEulerScheduler.create(steps, use_dynamic_shifting=True, mu=mu),
        steps, jcc)
    trun = tden.make_flux_denoiser(
        tcfg, tsch.FlowMatchEulerScheduler.create(steps, use_dynamic_shifting=True, mu=mu),
        steps, tcc)
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((1, ht * wt, TINY["in_channels"])).astype(np.float32)
    enc = rng.standard_normal((1, 6, TINY["joint_attention_dim"])).astype(np.float32)
    pooled = rng.standard_normal((1, TINY["pooled_projection_dim"])).astype(np.float32)
    jcos, jsin = jflux.flux_rope_cache(jcfg, 6, ht, wt)
    tcos, tsin = tflux.flux_rope_cache(tcfg, 6, ht, wt, device="cpu")
    want, jskips = jrun(jparams, jnp.asarray(lat), jnp.asarray(enc, jnp.bfloat16),
                        jnp.asarray(pooled, jnp.bfloat16), jcos, jsin)
    got, tskips = trun(tparams, torch.from_numpy(lat), torch.from_numpy(enc).bfloat16(),
                       torch.from_numpy(pooled).bfloat16(), tcos, tsin)
    assert got.dtype == torch.float32
    assert tskips == int(jskips)
    rel = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want))
    assert rel <= 2e-2, rel


# ------------------------------------------------------------------- engine


def _tiny_checkpoint(tmp_path):
    rng = np.random.default_rng(0)
    root = str(tmp_path / "flux-tiny")
    _write_st(os.path.join(root, "transformer", "model.safetensors"), _flux_transformer_sd(rng))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(TINY, f)
    _write_st(os.path.join(root, "vae", "model.safetensors"), _vae_sd(rng))
    return root, rng


def test_engine_end_to_end(tmp_path, monkeypatch):
    """Ctor (config.json overrides -> loader -> VAE) + generate() with
    precomputed embeddings, as tests/test_engine_e2e.py drives the JAX engine."""
    import fastdm_tpu_torch.engine as engine_mod
    from fastdm_tpu_torch.engine import FastDMEngine

    root, rng = _tiny_checkpoint(tmp_path)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    eng = FastDMEngine(root, architecture="flux", verbose=False, device="cpu",
                       cache_config={"cache_algorithm": "teacache", "enable_caching": True,
                                     "threshold": 0.3, "coefficients": [1.0, 0.0]})
    assert eng.cfg.num_layers == 2 and eng.cfg.guidance_embeds  # overrides took
    embeds = rng.standard_normal((1, 12, TINY["joint_attention_dim"])).astype(np.float32)
    pooled = rng.standard_normal((1, TINY["pooled_projection_dim"])).astype(np.float32)
    kw = dict(prompt_embeds=embeds, pooled_prompt_embeds=pooled, height=64, width=64,
              num_inference_steps=2, seed=1)
    images = eng.generate(**kw)
    assert images.shape == (1, 64, 64, 3) and images.dtype == np.uint8
    assert 0 <= eng.last_cache_skips < 2
    np.testing.assert_array_equal(eng.generate(**kw), images)  # seeded torch.Generator
    lat = eng.generate(output_type="latent", **kw)
    assert lat.shape == (1, 16, TINY["in_channels"]) and np.isfinite(lat).all()


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("quant_mods", [False, True])
def test_engine_w8a8_end_to_end(tmp_path, monkeypatch, quant, quant_mods):
    """use_int8 / use_fp8: the engine quantizes the checkpoint at load exactly
    as flux_load does (quant_mods decides the AdaLN linears) and generates
    finite images; the W8A8 image stays close to the bf16 one (the same
    checkpoint and noise; mean absolute difference under 2 of 255 levels)."""
    import fastdm_tpu_torch.engine as engine_mod
    from fastdm_tpu_torch.engine import FastDMEngine

    root, rng = _tiny_checkpoint(tmp_path)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    eng = FastDMEngine(root, verbose=False, device="cpu", quant_mods=quant_mods,
                       use_int8=quant == "int8", use_fp8=quant == "fp8")
    assert (eng.cfg.quant, eng.cfg.quant_mods) == (quant, quant_mods)
    want = tflux.flux_load(TSource.from_path(os.path.join(root, "transformer"), "cpu"), eng.cfg)
    for (k, a), (_, b) in zip(eng.params.state_dict().items(), want.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1
                                                  else a, b.view(torch.uint8)
                                                  if b.dtype.itemsize == 1 else b), k
    dtype = torch.int8 if quant == "int8" else torch.float8_e4m3fn
    assert eng.params.single_blocks[0].qkv_mlp.w.dtype == dtype
    assert (eng.params.dual_blocks[0].norm1.linear.w.dtype == dtype) == quant_mods
    embeds = rng.standard_normal((1, 12, TINY["joint_attention_dim"])).astype(np.float32)
    pooled = rng.standard_normal((1, TINY["pooled_projection_dim"])).astype(np.float32)
    kw = dict(prompt_embeds=embeds, pooled_prompt_embeds=pooled, height=64, width=64,
              num_inference_steps=2, seed=1)
    images = eng.generate(**kw)
    assert images.shape == (1, 64, 64, 3) and images.dtype == np.uint8
    ref = FastDMEngine(root, verbose=False, device="cpu").generate(**kw)
    assert np.abs(images.astype(np.float32) - ref.astype(np.float32)).mean() < 2


@pytest.mark.parametrize("pack", [False, True])
def test_engine_w4a4_end_to_end(tmp_path, monkeypatch, pack):
    """use_int4 (pack_int4) with quant_mods, bench.py's FLUX default: the engine
    quantizes the checkpoint at load exactly as flux_load does (the SVDQuant
    split from the seeded generator: two loads agree bit for bit), block
    linears and modulations in W4A4, and generates finite images close to the
    bf16 ones (the same checkpoint and noise; mean absolute difference under
    2 of 255 levels, as W8A8)."""
    import fastdm_tpu_torch.engine as engine_mod
    from fastdm_tpu_torch.engine import FastDMEngine

    root, rng = _tiny_checkpoint(tmp_path)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    eng = FastDMEngine(root, verbose=False, device="cpu", quant_mods=True, use_int4=True,
                       pack_int4=pack)
    assert (eng.cfg.quant, eng.cfg.quant_mods) == ("int4p" if pack else "int4", True)
    want = tflux.flux_load(TSource.from_path(os.path.join(root, "transformer"), "cpu"), eng.cfg)
    for (k, a), (_, b) in zip(eng.params.state_dict().items(), want.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    key = "w4p" if pack else "w4"
    for lin in (eng.params.single_blocks[0].qkv_mlp, eng.params.dual_blocks[0].norm1.linear):
        assert lin.w is None and getattr(lin, key).dtype == torch.int8
    embeds = rng.standard_normal((1, 12, TINY["joint_attention_dim"])).astype(np.float32)
    pooled = rng.standard_normal((1, TINY["pooled_projection_dim"])).astype(np.float32)
    kw = dict(prompt_embeds=embeds, pooled_prompt_embeds=pooled, height=64, width=64,
              num_inference_steps=2, seed=1)
    images = eng.generate(**kw)
    assert images.shape == (1, 64, 64, 3) and images.dtype == np.uint8
    ref = FastDMEngine(root, verbose=False, device="cpu").generate(**kw)
    assert np.abs(images.astype(np.float32) - ref.astype(np.float32)).mean() < 2


def test_engine_rejects_what_later_slices_bring(tmp_path, monkeypatch):
    import fastdm_tpu_torch.engine as engine_mod
    from fastdm_tpu_torch.engine import FastDMEngine

    root, _ = _tiny_checkpoint(tmp_path)
    monkeypatch.setitem(engine_mod.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    with pytest.raises(ValueError, match="mutually exclusive"):
        FastDMEngine(root, use_int8=True, use_fp8=True, device="cpu")
    with pytest.raises(ValueError, match="pack_int4 requires use_int4"):
        FastDMEngine(root, pack_int4=True, device="cpu")  # int4 arrived; its flag checks hold
    # every architecture name of the JAX engine is in the port (wan2.1-i2v
    # since its image branch arrived); a name neither knows raises
    from fastdm_tpu_torch.engine import ARCHITECTURES

    assert ARCHITECTURES["wan2.1-i2v"] == ARCHITECTURES["wan-i2v"] == "wan"
    with pytest.raises(NotImplementedError, match="hunyuan-video"):
        FastDMEngine(root, architecture="hunyuan-video", device="cpu")
    eng = FastDMEngine(root, verbose=False, device="cpu")
    # the text encoders have arrived: a prompt on a checkpoint without their
    # directories names the missing one (tests/test_torch_text_engine.py
    # drives prompts end to end)
    with pytest.raises(FileNotFoundError, match="tokenizer/"):
        eng.generate(prompt="a cat")
    with pytest.raises(NotImplementedError, match="t2i, i2i are"):
        eng.generate(task="v2v", image=np.zeros((64, 64, 3), np.uint8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FastDMEngine(root)  # the default device is the GPU; no quiet CPU run
