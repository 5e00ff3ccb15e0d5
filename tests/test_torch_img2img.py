"""The port's image-conditioned generation against the JAX package: the
AutoencoderKL encoder (fastdm_tpu_torch/pipeline/vae.py vae_encode) and the
VAE's tiled / sliced forms, _resize_to_multiple, the Kontext rope ids,
make_flux_denoiser's start_step, make_flux_kontext_denoiser,
make_qwen_edit_denoiser, SD3.5's cached start_step, and the engine's i2i
paths (FLUX SDEdit, flux-kontext, SD3.5 and SDXL SDEdit, qwen-image-edit on
both VAE routes, the VAE tiling / slicing binding), on tiny configs. JAX
params come from JAX's loaders on synthetic diffusers state dicts; the JAX
VAE calls are jitted.

Tolerances:
- _resize_to_multiple, with and without PIL, and flux_rope_cache with
  reference ids: bit-exact.
- vae_encode (deterministic and sampled) and the tiled encode: relative L2
  <= 2e-2 against JAX, the decoder's 6e-2 (tests/test_torch_pipeline.py)
  tightened: measured 7.6e-3 (deterministic), 9.5e-4 (sampled), 4.9e-3 (odd
  sizes), 6.6e-3 (tiled). XLA and PyTorch round the bf16 SiLU one ulp apart
  on ~40% of the elements, as in the decoder. The tiled and the sliced
  decode keep the decoder's 6e-2 (measured 4.4e-2 and 3.8e-2: the decoder's
  own spread, which is 3-4% whole too).
- The denoisers' f32 latents within relative L2 2e-2 of JAX, the cached
  ones with JAX's skip counts, every cache decision at least 5% of its
  threshold away from it (the margins fixture).
- The engine: its latents equal the port's own denoiser on the same seeded
  noise and encoded image bit for bit; its SDEdit start (start_step, sigma,
  the blend of each family) is JAX's formula on JAX's encoded image and the
  same noise within the encoder's 2e-2.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu import engine as jeng
from fastdm_tpu.caching import config as jcc
from fastdm_tpu.models import flux as jflux
from fastdm_tpu.models import sd35 as jsd
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline import denoise as jden
from fastdm_tpu.pipeline import denoise_more as jdm
from fastdm_tpu.pipeline import schedulers as jsch
from fastdm_tpu.pipeline import vae as jvae
from fastdm_tpu_torch import engine as teng
from fastdm_tpu_torch.caching import config as tcc
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models import qwenimage as tqw
from fastdm_tpu_torch.models import sd35 as tsd
from fastdm_tpu_torch.models.convert import flux_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import denoise as tden
from fastdm_tpu_torch.pipeline import denoise_qwen as tdq
from fastdm_tpu_torch.pipeline import denoise_sd3 as tds
from fastdm_tpu_torch.pipeline import denoise_sdxl as tdx
from fastdm_tpu_torch.pipeline import schedulers as tsch
from fastdm_tpu_torch.pipeline import vae as tvae
from fastdm_tpu_torch.pipeline import wan_vae as twvae

sys.path.insert(0, os.path.dirname(__file__))
from test_engine_e2e import TINY as FLUX_TINY  # noqa: E402
from test_engine_e2e import _flux_transformer_sd, _vae_sd, _write_st  # noqa: E402
from test_torch_qwen import _pair as qwen_pair  # noqa: E402
from test_torch_qwen import _write_checkpoint as write_qwen_checkpoint  # noqa: E402
from test_torch_sd35 import _embeds as sd35_embeds  # noqa: E402
from test_torch_sd35 import _pair as sd35_pair  # noqa: E402
from test_torch_sd35 import margins, sd35_root  # noqa: E402,F401  (fixtures)
from test_torch_sdxl import _embeds as sdxl_embeds  # noqa: E402
from test_torch_sdxl import sdxl_engine_root  # noqa: E402,F401  (fixture)
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

# a shift as well as a scale, so that both enter the comparisons
VAE_TINY = dict(latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=4, scaling_factor=0.5, shift_factor=0.1)
VAE_TOL = 2e-2  # the encoder
DEC_TOL = 6e-2  # the decoder, as tests/test_torch_pipeline.py holds it
FLUX_TXT = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _uint8_image(seed: int, h: int, w: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _to_pm1(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 127.5 - 1.0


@pytest.fixture(scope="module")
def vae_pair():
    """(jcfg, JAX params, tcfg, the port's params) from one synthetic full
    AutoencoderKL state dict through both loaders."""
    sd = _vae_sd(np.random.default_rng(0))
    jcfg, tcfg = jvae.VAEConfig(**VAE_TINY), tvae.VAEConfig(**VAE_TINY)
    return (jcfg, jvae.vae_load(JSource(dict(sd)), jcfg), tcfg,
            tvae.vae_load(TSource(dict(sd), device="cpu"), tcfg))


def _jax_encode(vae_pair, image_pm1: np.ndarray) -> np.ndarray:
    jcfg, jparams, _, _ = vae_pair
    return np.asarray(jvae._vae_encode_jit(jparams["encoder"], jcfg, jnp.asarray(image_pm1)))


# ------------------------------------------------------- _resize_to_multiple


@pytest.mark.parametrize("pil", [True, False])
def test_resize_to_multiple_matches_jax(pil, monkeypatch):
    """Down to a multiple (a LANCZOS resize, or without PIL a center crop),
    up to the multiple where a side is below it (without PIL an edge pad),
    and an image already at a multiple unchanged."""
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` fails
    for i, (h, w, m) in enumerate(((37, 50, 16), (10, 70, 16), (70, 100, 32), (32, 48, 16))):
        img = _uint8_image(i, h, w)
        got, want = teng._resize_to_multiple(img, m), jeng._resize_to_multiple(img, m)
        assert got.shape == want.shape == (max(m, h // m * m), max(m, w // m * m), 3)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    if not pil:  # the crop is the center of the image
        img = _uint8_image(7, 37, 50)
        np.testing.assert_array_equal(teng._resize_to_multiple(img, 16), img[2:34, 1:49])


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("sampled", [False, True])
def test_vae_encode_matches_jax(vae_pair, sampled):
    """(B, H, W, 3) in [-1, 1] -> (B, C, H/8, W/8) scaled latents, the
    posterior mean or mean + std * noise (noise in JAX's NHWC layout)."""
    jcfg, jparams, tcfg, tparams = vae_pair
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 5, 7, 4)).astype(np.float32) if sampled else None
    want = jvae._vae_encode_jit(jparams["encoder"], jcfg, jnp.asarray(img),
                                None if noise is None else jnp.asarray(noise))
    got = tvae.vae_encode(tparams["encoder"], tcfg, torch.from_numpy(img),
                          None if noise is None else torch.from_numpy(noise))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 4, 5, 7)
    assert _rel_l2(got, want) <= VAE_TOL
    if sampled:  # the noise moved the latents off the mean by more than the tolerance
        mean = tvae.vae_encode(tparams["encoder"], tcfg, torch.from_numpy(img))
        assert _rel_l2(got, mean) > 10 * VAE_TOL


def test_vae_encode_downsample_geometry(vae_pair):
    """Each stride-2 downsample pads (0, 1, 0, 1) and runs a VALID conv
    (diffusers' geometry): at odd sizes that gives floor sizes, where XLA's
    "SAME" of the SDXL UNet (layers/conv2d.py same_padding) gives ceil sizes;
    the values follow JAX's."""
    from fastdm_tpu_torch.layers.conv2d import same_padding

    jcfg, jparams, tcfg, tparams = vae_pair
    img = np.random.default_rng(2).uniform(-1, 1, (1, 36, 44, 3)).astype(np.float32)
    want = _jax_encode(vae_pair, img)
    got = tvae.vae_encode(tparams["encoder"], tcfg, torch.from_numpy(img))
    # 36 -> 18 -> 9 -> 4 and 44 -> 22 -> 11 -> 5 (pad one after, VALID)
    assert tuple(got.shape) == want.shape == (1, 4, 4, 5)
    same = [36, 44]
    for _ in range(3):
        same = [(n + sum(same_padding(n, 3, 2)) - 3) // 2 + 1 for n in same]
    assert same == [5, 6]  # "SAME" would have kept ceil(n / 2)
    assert _rel_l2(got, want) <= VAE_TOL
    # one downsample alone, against the explicit pad-then-VALID conv of JAX
    x = np.random.default_rng(3).standard_normal((1, 9, 13, 8)).astype(np.float32)
    blk = tparams["encoder"]["down"][0]["downsample"]
    from fastdm_tpu.layers.conv2d import conv2d as jconv

    jw = jparams["encoder"]["down"][0]["downsample"]
    want = np.asarray(jconv(jw, jnp.pad(jnp.asarray(x, jnp.bfloat16),
                                        ((0, 0), (0, 1), (0, 1), (0, 0))), 2, "VALID"))
    from fastdm_tpu_torch.layers.conv2d import conv2d as tconv

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
    got = tconv(blk, torch.nn.functional.pad(xt, (0, 1, 0, 1)), stride=2, padding=0)
    assert tuple(got.shape) == (1, 8, 4, 6)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), want, rtol=1e-2, atol=1e-2)
    sym = tconv(blk, xt, stride=2, padding=1)  # diffusers' UNet padding: another grid
    assert tuple(sym.shape) == (1, 8, 5, 7)


def test_vae_tiled_and_sliced_match_jax(vae_pair):
    """vae_decode_tiled at 4-latent tiles on 7x7 latents (step 3: ragged
    1-latent edge tiles), vae_encode_tiled at 32-pixel tiles on a 56x56 image
    (step 24: 8-pixel edge tiles), vae_decode_sliced at batch 2; inputs of one
    tile take the untiled path."""
    jcfg, jparams, tcfg, tparams = vae_pair
    rng = np.random.default_rng(4)
    z = rng.standard_normal((1, 4, 7, 7)).astype(np.float32)
    want = jvae.vae_decode_tiled(jparams, jcfg, jnp.asarray(z), tile_latent_size=4)
    got = tvae.vae_decode_tiled(tparams, tcfg, torch.from_numpy(z), tile_latent_size=4)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 56, 56, 3)
    assert _rel_l2(got, want) <= DEC_TOL
    # the tiles differ from the whole decode (the seams, the tiles' own norms)
    assert _rel_l2(got, tvae.vae_decode(tparams, tcfg, torch.from_numpy(z))) > DEC_TOL

    img = rng.uniform(-1, 1, (1, 56, 56, 3)).astype(np.float32)
    want = jvae.vae_encode_tiled(jparams["encoder"], jcfg, jnp.asarray(img), tile_sample_size=32)
    got = tvae.vae_encode_tiled(tparams["encoder"], tcfg, torch.from_numpy(img),
                                tile_sample_size=32)
    assert tuple(got.shape) == want.shape == (1, 4, 7, 7)
    assert _rel_l2(got, want) <= VAE_TOL

    zb = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    want = jvae.vae_decode_sliced(jparams, jcfg, jnp.asarray(zb))
    got = tvae.vae_decode_sliced(tparams, tcfg, torch.from_numpy(zb))
    assert tuple(got.shape) == want.shape == (2, 32, 48, 3)
    assert _rel_l2(got, want) <= DEC_TOL
    assert torch.equal(got[1:], tvae.vae_decode(tparams, tcfg, torch.from_numpy(zb[1:])))

    small = torch.from_numpy(zb[:1])
    assert torch.equal(tvae.vae_decode_tiled(tparams, tcfg, small),
                       tvae.vae_decode(tparams, tcfg, small))
    small_img = torch.from_numpy(img[:, :24, :32])
    assert torch.equal(tvae.vae_encode_tiled(tparams["encoder"], tcfg, small_img),
                       tvae.vae_encode(tparams["encoder"], tcfg, small_img))


def test_vae_encoder_random_loads_the_layout_vae_load_makes(vae_pair):
    """vae_encoder_random (for runs without a checkpoint) draws the tree that
    vae_load puts under "encoder", seeded."""
    _, _, tcfg, tparams = vae_pair
    a = tvae.vae_encoder_random(5, tcfg, device="cpu")
    b = tvae.vae_encoder_random(5, tcfg, device="cpu")
    flat = lambda t: {k: v for k, v in _flatten(t)}  # noqa: E731
    fa, fl = flat(a), flat(tparams["encoder"])
    assert fa.keys() == fl.keys()
    assert all(fa[k].shape == fl[k].shape and fa[k].dtype == fl[k].dtype for k in fa)
    assert all(torch.equal(v, flat(b)[k]) for k, v in fa.items())
    img = torch.zeros(1, 16, 16, 3)
    assert tuple(tvae.vae_encode(a, tcfg, img).shape) == (1, 4, 2, 2)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


# -------------------------------------------------------------- FLUX loops


@pytest.mark.parametrize("refs", [(3, 5), ((3, 5), (2, 4))])
def test_flux_rope_cache_reference_ids_bit_exact(refs):
    """One (h, w) pair or a sequence: reference i on id-plane i + 1."""
    jcfg, tcfg = jflux.FluxConfig(**FLUX_TINY), tflux.FluxConfig(**FLUX_TINY)
    jcos, jsin = jflux.flux_rope_cache(jcfg, 5, 4, 6, ref_tokens_hw=refs)
    tcos, tsin = tflux.flux_rope_cache(tcfg, 5, 4, 6, ref_tokens_hw=refs, device="cpu")
    n_ref = 15 if refs == (3, 5) else 15 + 8
    assert tuple(tcos.shape) == jcos.shape == (5 + 24 + n_ref, sum(jcfg.axes_dims_rope) // 2)
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))
    plain, _ = tflux.flux_rope_cache(tcfg, 5, 4, 6, device="cpu")
    assert torch.equal(tcos[:29], plain) and not torch.equal(tcos[29:44], plain[5:20])


@pytest.fixture(scope="module")
def flux_pair():
    sd = _flux_transformer_sd(np.random.default_rng(20))
    jcfg = jflux.FluxConfig(quant=None, **FLUX_TINY)
    tcfg = tflux.FluxConfig(quant=None, **FLUX_TINY)
    jparams = jflux.flux_load(JSource(dict(sd)), jcfg)
    return jcfg, jparams, tcfg, flux_params_from_numpy(jax.device_get(jparams), device="cpu")


def _flux_inputs(seed: int, s: int):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, s, FLUX_TINY["in_channels"])).astype(np.float32)
    enc = rng.standard_normal((1, FLUX_TXT, FLUX_TINY["joint_attention_dim"])).astype(np.float32)
    pooled = rng.standard_normal((1, FLUX_TINY["pooled_projection_dim"])).astype(np.float32)
    j = (jnp.asarray(lat), jnp.asarray(enc, jnp.bfloat16), jnp.asarray(pooled, jnp.bfloat16))
    t = (torch.from_numpy(lat), torch.from_numpy(enc).bfloat16(),
         torch.from_numpy(pooled).bfloat16())
    return j, t


# name: (config, start_step, JAX's skips over steps start..3); thresholds
# picked from a calibration run (threshold 1e9) so that every decision lies
# >= 5% from its threshold
FLUX_CACHES = {
    "none": (None, 1, 0),
    "teacache": (dict(cache_algorithm="teacache", threshold=0.25,
                      coefficients=(1.0, 0.0)), 1, 1),
    "fbcache": (dict(cache_algorithm="fbcache", threshold=0.25, warmup_steps=1), 1, 1),
}


@pytest.mark.parametrize("name", sorted(FLUX_CACHES))
def test_make_flux_denoiser_start_step_matches_jax(flux_pair, name, margins):
    """SDEdit's truncated loop (steps start..3 of 4) uncached and under
    TeaCache / FBCache: the cache counts steps from the loop's start
    (TeaCache's forced step and FBCache's warmup fire there), the skips are
    JAX's."""
    jcfg, jparams, tcfg, tparams = flux_pair
    kw, start, skips = FLUX_CACHES[name]
    jc = tc = None
    if kw is not None:
        jc = jcc.CacheConfig.from_dict(dict(kw, enable_caching=True))
        tc = tcc.CacheConfig.from_dict(dict(kw, enable_caching=True))
    mu = tsch.flow_match_shift_mu(16)
    jsc = jsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, mu=mu)
    tsc = tsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, mu=mu)
    j, t = _flux_inputs(21, 16)
    jcos, jsin = jflux.flux_rope_cache(jcfg, FLUX_TXT, 4, 4)
    tcos, tsin = tflux.flux_rope_cache(tcfg, FLUX_TXT, 4, 4, device="cpu")
    want, jskips = jden.make_flux_denoiser(jcfg, jsc, 4, jc, 3.5, start)(jparams, *j, jcos, jsin)
    got, tskips = tden.make_flux_denoiser(tcfg, tsc, 4, tc, 3.5, start)(tparams, *t, tcos, tsin)
    assert got.dtype == torch.float32 and tskips == int(jskips) == skips
    assert _rel_l2(got, want) <= 2e-2


def test_cache_step_is_loop_relative_on_flux_and_absolute_on_sd35(flux_pair, sd35_int8, margins):
    """The reference behaviour each family keeps: a TeaCache whose
    polynomial is negative (-100 x) skips every step it is not forced to
    compute. FLUX counts from the loop's start, so its first SDEdit step is
    forced (2 skips of 3); SD3.5 passes the absolute step, so with
    start_step 1 no step is forced and all 3 skip, as in JAX
    (fastdm_tpu/pipeline/denoise.py:65-77, denoise_more.py:82-85)."""
    kw = dict(cache_algorithm="teacache", enable_caching=True, threshold=0.05,
              coefficients=(-100.0, 0.0))
    jc, tc = jcc.CacheConfig.from_dict(kw), tcc.CacheConfig.from_dict(kw)
    jcfg, jparams, tcfg, tparams = flux_pair
    jsc = jsch.FlowMatchEulerScheduler.create(4, shift=1.0)
    tsc = tsch.FlowMatchEulerScheduler.create(4, shift=1.0)
    j, t = _flux_inputs(22, 16)
    jcos, jsin = jflux.flux_rope_cache(jcfg, FLUX_TXT, 4, 4)
    tcos, tsin = tflux.flux_rope_cache(tcfg, FLUX_TXT, 4, 4, device="cpu")
    _, jskips = jden.make_flux_denoiser(jcfg, jsc, 4, jc, 3.5, 1)(jparams, *j, jcos, jsin)
    got, tskips = tden.make_flux_denoiser(tcfg, tsc, 4, tc, 3.5, 1)(tparams, *t, tcos, tsin)
    assert tskips == int(jskips) == 2 and torch.isfinite(got).all()

    got, tskips, want, jskips = _sd35_run(sd35_int8, kw, 1, 23)
    assert tskips == jskips == 3
    # every step replayed the zero residual: the latents moved by the
    # scheduler alone, as in JAX
    assert _rel_l2(got, want) <= 2e-2


@pytest.fixture(scope="module")
def sd35_int8():
    return sd35_pair("int8", seed=7)


def _sd35_run(models, cc, start: int, seed: int):
    """JAX's and the port's batched-CFG loop over 4 steps from start."""
    jcfg, jparams, tcfg, tparams, _ = models
    jc = tc = None
    if cc is not None:
        jc, tc = jcc.CacheConfig.from_dict(cc), tcc.CacheConfig.from_dict(cc)
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 4, 16, 24)).astype(np.float32)
    emb = [rng.standard_normal(s).astype(np.float32) for s in ((2, 7, 32), (2, 24))]
    jpos = jsd.sd3_cropped_pos_embed(jcfg, None, 16, 24)
    tpos = tsd.sd3_cropped_pos_embed(tcfg, None, 16, 24, device="cpu")
    jsc, tsc = (m.FlowMatchEulerScheduler.create(4, shift=3.0) for m in (jsch, tsch))
    want, jskips = jdm.make_sd3_denoiser(jcfg, jsc, 4, 7.0, jc, start)(
        jparams, jnp.asarray(lat), *(jnp.asarray(e, jnp.bfloat16) for e in emb), jpos)
    got, tskips = tds.make_sd3_denoiser(tcfg, tsc, 4, 7.0, tc, start)(
        tparams, torch.from_numpy(lat), *(torch.from_numpy(e).bfloat16() for e in emb), tpos)
    return got, tskips, want, int(jskips)


# SD3.5 from step 1 of 4: thresholds picked from a calibration run
# (threshold 1e9: accumulated errors 0.0128 / 0.0336 FBCache, 0.0286 / 0.0604
# TeaCache at steps 2 / 3), each decision >= 5% from its threshold
SD35_CACHES = {
    "teacache": (dict(cache_algorithm="teacache", threshold=0.045, coefficients=(1.0, 0.0)), 1),
    "fbcache": (dict(cache_algorithm="fbcache", threshold=0.02, warmup_steps=1), 1),
}


@pytest.mark.parametrize("name", sorted(SD35_CACHES))
def test_make_sd3_denoiser_cached_start_step_matches_jax(sd35_int8, name, margins):
    """The batched-CFG loop from step 1 of 4 under a cache: the step the
    cache sees is the absolute one, as JAX's, so FBCache's warmup of 1 forces
    step 1 only; the skip counts are JAX's."""
    kw, skips = SD35_CACHES[name]
    got, tskips, want, jskips = _sd35_run(sd35_int8, dict(kw, enable_caching=True), 1, 24)
    assert tskips == jskips == skips
    assert _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("n_refs", [1, 2])
def test_make_flux_kontext_denoiser_matches_jax(flux_pair, n_refs):
    """The clean reference tokens follow the noise tokens each step, on
    id-planes 1 (and 2); only the noise part is denoised."""
    jcfg, jparams, tcfg, tparams = flux_pair
    shapes = ((4, 4), (2, 3))[:n_refs]
    n_ref = sum(h * w for h, w in shapes)
    j, t = _flux_inputs(25, 16)
    ref = np.random.default_rng(26).standard_normal(
        (1, n_ref, FLUX_TINY["in_channels"])).astype(np.float32)
    jcos, jsin = jflux.flux_rope_cache(jcfg, FLUX_TXT, 4, 4, ref_tokens_hw=shapes)
    tcos, tsin = tflux.flux_rope_cache(tcfg, FLUX_TXT, 4, 4, ref_tokens_hw=shapes, device="cpu")
    mu = tsch.flow_match_shift_mu(16)
    jsc = jsch.FlowMatchEulerScheduler.create(3, use_dynamic_shifting=True, mu=mu)
    tsc = tsch.FlowMatchEulerScheduler.create(3, use_dynamic_shifting=True, mu=mu)
    want, _ = jden.make_flux_kontext_denoiser(jcfg, jsc, 3, None, 2.5)(
        jparams, j[0], jnp.asarray(ref), j[1], j[2], jcos, jsin)
    got, skips = tden.make_flux_kontext_denoiser(tcfg, tsc, 3, None, 2.5)(
        tparams, t[0], torch.from_numpy(ref), t[1], t[2], tcos, tsin)
    assert skips == 0 and tuple(got.shape) == (1, 16, FLUX_TINY["in_channels"])
    assert _rel_l2(got, want) <= 2e-2


# ------------------------------------------------------------ Qwen edit loop


@pytest.fixture(scope="module")
def qwen_bf16():
    return qwen_pair(None, seed=7, port_load=False)


QWEN_EDIT_TEACACHE = dict(cache_algorithm="teacache", enable_caching=True, threshold=0.044,
                          coefficients=(1.0, 0.0), negtive_coefficients=(1.2, 0.0))


@pytest.mark.parametrize("cache", [None, "teacache"])
def test_make_qwen_edit_denoiser_matches_jax(qwen_bf16, cache, margins):
    """True CFG 4.0 over 4 steps with 6 source tokens (one 2x3 extra rope
    entry) after 24 noise tokens, uncached and under TeaCache on two streams
    (the text-stream probe; the negative stream on negtive_coefficients):
    JAX's skip counts; a rope that does not cover the source raises."""
    jcfg, jparams, tcfg, tparams, _ = qwen_bf16
    from fastdm_tpu.models import qwenimage as jqw

    rng = np.random.default_rng(27)
    lat = rng.standard_normal((1, 24, 16)).astype(np.float32)
    src = rng.standard_normal((1, 6, 16)).astype(np.float32)
    pos, neg = (rng.standard_normal((1, 5, 24)) * 3 for _ in range(2))
    jpos, jneg = jnp.asarray(pos, jnp.bfloat16), jnp.asarray(neg, jnp.bfloat16)
    tpos, tneg = (torch.from_numpy(np.array(a, np.float32)).bfloat16() for a in (jpos, jneg))
    extra = ((1, 2, 3),)
    jcos, jsin = jqw.qwen_rope_cos_sin(jcfg, 1, 4, 6, 5, extra_shapes=extra)
    tcos, tsin = tqw.qwen_rope_cos_sin(tcfg, 1, 4, 6, 5, extra_shapes=extra, device="cpu")
    jc = tc = None
    if cache:
        jc = jcc.CacheConfig.from_dict(QWEN_EDIT_TEACACHE)
        tc = tcc.CacheConfig.from_dict(QWEN_EDIT_TEACACHE)
    mu = tsch.flow_match_shift_mu(24)
    jsc = jsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, mu=mu)
    tsc = tsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True, mu=mu)
    want, jskips = jdm.make_qwen_edit_denoiser(jcfg, jsc, 4, 4.0, jc)(
        jparams, jnp.asarray(lat), jnp.asarray(src), jpos, jneg, jcos, jsin)
    run = tdq.make_qwen_edit_denoiser(tcfg, tsc, 4, 4.0, tc)
    got, skips = run(tparams, torch.from_numpy(lat), torch.from_numpy(src), tpos, tneg,
                     tcos, tsin)
    assert got.dtype == torch.float32 and tuple(got.shape) == lat.shape
    assert skips == int(jskips) and (skips > 0) == (cache is not None)
    assert _rel_l2(got, want) <= 2e-2
    short = tqw.qwen_rope_cos_sin(tcfg, 1, 4, 6, 5, device="cpu")
    with pytest.raises(ValueError, match="extra_shapes"):
        run(tparams, torch.from_numpy(lat), torch.from_numpy(src), tpos, tneg, *short)


# ------------------------------------------------------------------- engine


def _capture(monkeypatch, module, name):
    """Wrap module.name (a denoiser factory) so that each run records the
    arguments it was called with."""
    calls, make = [], getattr(module, name)

    def factory(*a, **k):
        run = make(*a, **k)

        def recorded(*args):
            calls.append(args)
            return run(*args)

        return recorded

    monkeypatch.setattr(module, name, factory)
    return calls


def _flux_root(tmp_path, name: str = "flux-tiny", encoder: bool = True) -> str:
    root = str(tmp_path / name)
    rng = np.random.default_rng(0)
    _write_st(os.path.join(root, "transformer", "model.safetensors"), _flux_transformer_sd(rng))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(FLUX_TINY, f)
    sd = _vae_sd(np.random.default_rng(0))
    if not encoder:  # a decoder-only AutoencoderKL
        sd = {k: v for k, v in sd.items() if not k.startswith(("encoder.", "quant_conv."))}
    _write_st(os.path.join(root, "vae", "model.safetensors"), sd)
    return root


@pytest.fixture
def flux_engine(tmp_path, monkeypatch):
    monkeypatch.setitem(teng.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    root = _flux_root(tmp_path)

    def make(arch="flux", **kw):
        return teng.FastDMEngine(root, architecture=arch, verbose=False, device="cpu", **kw)

    return root, make


def _flux_embeds(seed: int):
    rng = np.random.default_rng(seed)
    return dict(prompt_embeds=rng.standard_normal((1, FLUX_TXT, 64)).astype(np.float32),
                pooled_prompt_embeds=rng.standard_normal((1, 48)).astype(np.float32))


def _jax_vae(root: str, cfg_kw: dict):
    """JAX's AutoencoderKL from the checkpoint's vae/ state dict."""
    from safetensors.numpy import load_file

    jcfg = jvae.VAEConfig(**cfg_kw)
    sd = load_file(os.path.join(root, "vae", "model.safetensors"))
    return jcfg, jvae.vae_load(JSource(dict(sd)), jcfg)


def test_engine_flux_sdedit(flux_engine, monkeypatch):
    """FLUX i2i on a 70x100 image (resized to 64x96): strength 0.5 of 4 steps
    starts at step 2, the packed encoded image blended with the seeded noise
    at sigmas[2] (JAX's formula on JAX's encoded image within the encoder's
    tolerance), then the loop's last two steps; an image with no task means
    i2i."""
    root, make = flux_engine
    eng = make(cache_config={"cache_algorithm": "teacache", "enable_caching": True,
                             "threshold": 0.3, "coefficients": [1.0, 0.0]})
    calls = _capture(monkeypatch, tden, "make_flux_denoiser")
    src = _uint8_image(30, 70, 100)
    kw = dict(_flux_embeds(31), num_inference_steps=4, seed=3, strength=0.5)
    lat = eng.generate(task="i2i", image=src, output_type="latent", **kw)
    assert lat.shape == (1, 24, 16)
    init = calls[0][1]
    resized = jeng._resize_to_multiple(src, 16)
    jcfg, jparams = _jax_vae(root, VAE_TINY)
    jz = jvae._vae_encode_jit(jparams["encoder"], jcfg, jnp.asarray(_to_pm1(resized))[None])
    jpacked = np.asarray(jden.flux_pack_latents(jz))
    start = min(int(4 * (1 - 0.5)), 3)
    sched = jsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True,
                                                mu=jsch.flow_match_shift_mu(24))
    sig = float(sched.sigmas[start])
    noise = torch.randn((1, 24, 16), generator=torch.Generator().manual_seed(3))
    assert _rel_l2(init, (1 - sig) * jpacked + sig * noise.numpy()) <= VAE_TOL
    # the engine's latents are the port's loop from that start on its own blend
    z = tvae.vae_encode(eng.vae_params["encoder"], eng.vae_cfg,
                        torch.from_numpy(_to_pm1(resized))[None])
    mine = (1 - sig) * tden.flux_pack_latents(z) + sig * noise
    assert torch.equal(init, mine)
    tsc = tsch.FlowMatchEulerScheduler.create(4, use_dynamic_shifting=True,
                                              mu=tsch.flow_match_shift_mu(24))
    e = {k: torch.from_numpy(v).bfloat16() for k, v in _flux_embeds(31).items()}
    cos, sin = tflux.flux_rope_cache(eng.cfg, FLUX_TXT, 4, 6, device="cpu")
    want, skips = tden.make_flux_denoiser(eng.cfg, tsc, 4, eng.cache_config, 3.5, start)(
        eng.params, mine, e["prompt_embeds"], e["pooled_prompt_embeds"], cos, sin)
    np.testing.assert_array_equal(lat, want.numpy())
    assert eng.last_cache_skips == skips
    img = eng.generate(image=src, **kw)  # no task: i2i
    assert img.shape == (1, 64, 96, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, eng._to_uint8(tvae.vae_decode(
        eng.vae_params, eng.vae_cfg, tden.flux_unpack_latents(want, 4, 6))))
    # i2i without an image runs t2i, as JAX
    t2i = eng.generate(task="i2i", output_type="latent", **dict(kw, height=64, width=64))
    assert t2i.shape == (1, 16, 16)


def test_engine_flux_kontext(flux_engine, monkeypatch):
    """flux-kontext with two references (70x100 -> 64x96 and 40x56 -> 32x48):
    the output takes the first one's size, the references' packed tokens
    follow the noise on id-planes 1 and 2."""
    root, make = flux_engine
    eng = make("flux-kontext")
    calls = _capture(monkeypatch, tden, "make_flux_kontext_denoiser")
    refs = [_uint8_image(32, 70, 100), _uint8_image(33, 40, 56)]
    kw = dict(_flux_embeds(34), num_inference_steps=2, seed=4, guidance_scale=2.5)
    lat = eng.generate(task="i2i", image=refs, output_type="latent", **kw)
    assert lat.shape == (1, 24, 16)
    _, noise, ref, _, _, cos, sin = calls[0]
    assert tuple(ref.shape) == (1, 24 + 6, 16) and tuple(cos.shape) == (FLUX_TXT + 24 + 30, 16)
    jcfg, jparams = _jax_vae(root, VAE_TINY)
    jref = np.concatenate([np.asarray(jden.flux_pack_latents(jvae._vae_encode_jit(
        jparams["encoder"], jcfg, jnp.asarray(_to_pm1(jeng._resize_to_multiple(im, 16)))[None])))
        for im in refs], axis=1)
    assert _rel_l2(ref, jref) <= VAE_TOL
    jcos, _ = jflux.flux_rope_cache(jflux.FluxConfig(**FLUX_TINY), FLUX_TXT, 4, 6,
                                    ref_tokens_hw=((4, 6), (2, 3)))
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    assert torch.equal(noise, torch.randn((1, 24, 16), generator=torch.Generator().manual_seed(4)))
    tsc = tsch.FlowMatchEulerScheduler.create(2, use_dynamic_shifting=True,
                                              mu=tsch.flow_match_shift_mu(24))
    e = {k: torch.from_numpy(v).bfloat16() for k, v in _flux_embeds(34).items()}
    want, _ = tden.make_flux_kontext_denoiser(eng.cfg, tsc, 2, None, 2.5)(
        eng.params, noise, ref, e["prompt_embeds"], e["pooled_prompt_embeds"], cos, sin)
    np.testing.assert_array_equal(lat, want.numpy())
    img = eng.generate(image=refs, **kw)
    assert img.shape == (1, 64, 96, 3) and img.dtype == np.uint8


def test_engine_vae_binding(flux_engine, tmp_path):
    """vae_tiling / vae_slicing and the enable / disable calls pick the tiled,
    sliced or whole decode and encode; a decoder-only vae/ refuses i2i."""
    root, make = flux_engine
    eng = make(vae_tiling=True)
    p, cfg = eng.vae_params, eng.vae_cfg
    z = torch.from_numpy(np.random.default_rng(35).standard_normal((2, 4, 72, 8)).astype(
        np.float32))
    img = torch.from_numpy(np.random.default_rng(36).uniform(-1, 1, (1, 528, 16, 3)).astype(
        np.float32))
    assert torch.equal(eng._decode(p, z), tvae.vae_decode_tiled(p, cfg, z))
    assert torch.equal(eng._encode(p, img), tvae.vae_encode_tiled(p["encoder"], cfg, img))
    eng.disable_vae_tiling()
    assert torch.equal(eng._decode(p, z), tvae.vae_decode(p, cfg, z))
    assert torch.equal(eng._encode(p, img), tvae.vae_encode(p["encoder"], cfg, img))
    eng.enable_vae_slicing()
    assert torch.equal(eng._decode(p, z), tvae.vae_decode_sliced(p, cfg, z))
    eng.enable_vae_tiling()  # tiling takes precedence, as in JAX
    assert torch.equal(eng._decode(p, z), tvae.vae_decode_tiled(p, cfg, z))

    eng = teng.FastDMEngine(_flux_root(tmp_path, "decoder-only", encoder=False), verbose=False,
                            device="cpu")
    assert "encoder" not in eng.vae_params
    with pytest.raises(ValueError, match="no encoder weights"):
        eng.generate(task="i2i", image=_uint8_image(37, 64, 64), num_inference_steps=2,
                     **_flux_embeds(38))


def test_engine_sd35_and_sdxl_sdedit(sd35_root, sdxl_engine_root, monkeypatch):
    """SD3.5 i2i (flow match: (1 - sigma) z + sigma noise at shift 3.0's
    sigmas[start]) and SDXL i2i (epsilon Euler: z + noise sigmas[start]) on a
    70x100 image, resized to 8 x the patch (SD3.5, 64x96) and to the UNet's
    granularity (SDXL, 32: 64x96); the start and the blend are JAX's formula
    on JAX's encoded image; the latents the port's loop from that start."""
    calls = _capture(monkeypatch, tds, "make_sd3_denoiser")
    src = _uint8_image(40, 70, 100)
    eng = teng.FastDMEngine(sd35_root, architecture="sd35", use_int8=True, verbose=False,
                            device="cpu", cache_config={"cache_algorithm": "teacache",
                                                        "enable_caching": True,
                                                        "threshold": 0.3,
                                                        "coefficients": [1.0, 0.0]})
    kw = dict(sd35_embeds(41), num_inference_steps=4, seed=5, strength=0.6)
    lat = eng.generate(task="i2i", image=src, output_type="latent", **kw)
    assert lat.shape == (1, 4, 8, 12)
    start = min(int(4 * (1 - 0.6)), 3)
    assert start == 1
    init = calls[0][1]
    from test_torch_sd35 import VAE_TINY as SD35_VAE

    jcfg, jparams = _jax_vae(sd35_root, SD35_VAE)
    resized = jeng._resize_to_multiple(src, 16)
    jz = np.asarray(jvae._vae_encode_jit(jparams["encoder"], jcfg,
                                         jnp.asarray(_to_pm1(resized))[None]))
    sig = float(jsch.FlowMatchEulerScheduler.create(4, shift=3.0).sigmas[start])
    noise = torch.randn((1, 4, 8, 12), generator=torch.Generator().manual_seed(5))
    assert _rel_l2(init, (1 - sig) * jz + sig * noise.numpy()) <= VAE_TOL
    e = {k: torch.from_numpy(v).bfloat16() for k, v in sd35_embeds(41).items()}
    tsc = tsch.FlowMatchEulerScheduler.create(4, shift=3.0)
    want, skips = tds.make_sd3_denoiser(eng.cfg, tsc, 4, 7.0, eng.cache_config, start)(
        eng.params, init, torch.cat([e["negative_prompt_embeds"], e["prompt_embeds"]]),
        torch.cat([e["negative_pooled_prompt_embeds"], e["pooled_prompt_embeds"]]),
        tsd.sd3_cropped_pos_embed(eng.cfg, eng.params.pos_embed_table, 8, 12, device="cpu"))
    np.testing.assert_array_equal(lat, want.numpy())
    assert eng.last_cache_skips == skips
    assert eng.generate(image=src, **kw).shape == (1, 64, 96, 3)

    calls = _capture(monkeypatch, tdx, "make_sdxl_denoiser")
    eng = teng.FastDMEngine(sdxl_engine_root, architecture="sdxl", use_int8=True,
                            verbose=False, device="cpu")
    kw = dict(sdxl_embeds(42), num_inference_steps=4, seed=6, strength=0.6,
              guidance_scale=5.0)
    lat = eng.generate(task="i2i", image=src, output_type="latent", **kw)
    assert lat.shape == (1, 4, 8, 12)
    init = calls[0][1]
    from test_torch_sdxl import VAE_TINY as SDXL_VAE

    jcfg, jparams = _jax_vae(sdxl_engine_root, SDXL_VAE)
    resized = jeng._resize_to_multiple(src, 32)
    jz = np.asarray(jvae._vae_encode_jit(jparams["encoder"], jcfg,
                                         jnp.asarray(_to_pm1(resized))[None]))
    sig = float(jsch.EulerDiscreteScheduler.create(4).sigmas[start])
    noise = torch.randn((1, 4, 8, 12), generator=torch.Generator().manual_seed(6))
    assert _rel_l2(init, jz + noise.numpy() * sig) <= VAE_TOL
    e = {k: torch.from_numpy(v).bfloat16() for k, v in sdxl_embeds(42).items()}
    want, _ = tdx.make_sdxl_denoiser(eng.cfg, tsch.EulerDiscreteScheduler.create(4), 4, 5.0,
                                     start)(
        eng.params, init, torch.cat([e["negative_prompt_embeds"], e["prompt_embeds"]]),
        torch.cat([e["negative_pooled_prompt_embeds"], e["pooled_prompt_embeds"]]),
        torch.tensor([[64.0, 96, 0, 0, 64, 96]] * 2))
    np.testing.assert_array_equal(lat, want.numpy())
    assert eng.generate(image=src, **kw).shape == (1, 64, 96, 3)


@pytest.mark.parametrize("wan_vae", [True, False])
def test_engine_qwen_image_edit(tmp_path, monkeypatch, wan_vae):
    """qwen-image-edit on a 70x100 source (resized to 64x96: 24 source
    tokens on the rope's extra entry (1, 4, 6)) through the Wan-layout VAE
    (one frame) or the AutoencoderKL; true CFG 3.0 under TeaCache: the
    latents are make_qwen_edit_denoiser's on the seeded noise and the
    encoded source; without an image the engine runs Qwen-Image t2i."""
    root = str(tmp_path / "qwen-tiny")
    write_qwen_checkpoint(root, wan_vae)
    monkeypatch.setitem(teng.VAE_CONFIGS, "qwen", tvae.VAEConfig(
        latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
        norm_num_groups=4, scaling_factor=1.0, shift_factor=0.0))
    calls = _capture(monkeypatch, tdq, "make_qwen_edit_denoiser")
    eng = teng.FastDMEngine(root, architecture="qwen-image-edit", verbose=False, device="cpu",
                            cache_config={"cache_algorithm": "teacache", "enable_caching": True,
                                          "threshold": 0.3, "coefficients": [1.0, 0.0]},
                            vae_tiling=True)  # ignored on the Wan-layout route
    assert isinstance(eng.vae_cfg, twvae.WanVAEConfig) == wan_vae
    rng = np.random.default_rng(43)
    pos = rng.standard_normal((1, 5, 24)).astype(np.float32)
    neg = rng.standard_normal((1, 3, 24)).astype(np.float32)
    src = _uint8_image(44, 70, 100)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, num_inference_steps=2,
              true_cfg_scale=3.0, seed=7)
    lat = eng.generate(image=src, output_type="latent", **kw)
    assert lat.shape == (1, 24, 16)
    _, noise, srct, pt, nt, cos, sin = calls[0]
    x = torch.from_numpy(_to_pm1(jeng._resize_to_multiple(src, 16)))[None]
    if wan_vae:
        z = twvae.wan_vae_encode(eng.vae_params, eng.vae_cfg, x[:, None])[:, :, 0]
    else:
        z = tvae.vae_encode(eng.vae_params["encoder"], eng.vae_cfg, x)
    assert torch.equal(srct, tden.flux_pack_latents(z))
    want_cos, _ = tqw.qwen_rope_cos_sin(eng.cfg, 1, 4, 6, 5, extra_shapes=((1, 4, 6),),
                                        device="cpu")
    assert torch.equal(cos, want_cos) and pt.shape == nt.shape == (1, 5, 24)
    assert torch.equal(noise, torch.randn((1, 24, 16), generator=torch.Generator().manual_seed(7)))
    tsc = tsch.FlowMatchEulerScheduler.create(2, use_dynamic_shifting=True,
                                              mu=tsch.flow_match_shift_mu(24))
    want, skips = tdq.make_qwen_edit_denoiser(eng.cfg, tsc, 2, 3.0, eng.cache_config)(
        eng.params, noise, srct, pt, nt, cos, sin)
    np.testing.assert_array_equal(lat, want.numpy())
    assert eng.last_cache_skips == skips
    img = eng.generate(task="i2i", image=[src], **kw)
    assert img.shape == (1, 64, 96, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, eng._to_uint8(eng._decode(
        eng.vae_params, tden.flux_unpack_latents(want, 4, 6))))
    n = len(calls)
    t2i = eng.generate(output_type="latent", height=32, width=48, **kw)
    assert t2i.shape == (1, 6, 16) and len(calls) == n


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a GPU the new entry points raise unless the caller asks for
    the CPU: no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    monkeypatch.setitem(teng.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    root = _flux_root(tmp_path)
    for call in (lambda: tvae.vae_encoder_random(0, tvae.VAEConfig(**VAE_TINY)),
                 lambda: tflux.flux_rope_cache(tflux.FluxConfig(**FLUX_TINY), 4, 2, 2,
                                               ref_tokens_hw=(2, 2)),
                 lambda: teng.FastDMEngine(root, architecture="flux-kontext", verbose=False),
                 lambda: teng.FastDMEngine(root, architecture="flux-dev", vae_tiling=True,
                                           verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
