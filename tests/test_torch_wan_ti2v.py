"""The port's Wan2.2-TI2V-5B and Wan i2v paths against the JAX package: the
per-token timestep forward (plain and cached), the compact timestep on a
per-token config, the Wan2.2 VAE's rearrangements, the residual patchified
decode (full and chunked) and the encoder in both layouts, the residual
loader, the TI2V denoiser (uncached, FBCache, DiCache), the dual-phase loop
with i2v conditioning channels, and the engine on tiny checkpoints (t2v and
ti2v on a per-token config with the residual patchified VAE, i2v on an
in_channels 36 dual expert); tiny configs (2 heads x 24, 2 layers), inputs
from numpy seeds, JAX random params moved across by the converter.

Tolerances: the forwards run in bfloat16 and are held to relative L2 1e-2
of JAX, the denoisers' latents to 2e-2 (as tests/test_torch_wan.py holds the
t2v ones: XLA and PyTorch round some bf16 GELU/SiLU elements one ulp apart);
the compact timestep on a per-token config equals the plain config's forward
bit for bit in the port; the VAE rearrangements are exact (integer-valued
inputs, so AvgDown3D's means are exact in any summation order); in float32
(JAX's _DTYPE monkeypatched) the residual decode, full and chunked, and the
encode of either layout lie within 1e-4 + 1e-4*|x| of JAX (the same convs,
norms and attention summed in another order); loaded weights equal JAX's bit
for bit. The cached loops compare skip counts exactly, with every decision
>= 5% of its threshold away from it (the `margins` fixture of
tests/test_torch_wan_cache.py).
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdm_tpu.pipeline.wan_vae as jvae
from fastdm_tpu.caching.config import CacheConfig as JCacheConfig
from fastdm_tpu.caching.xcaching import cache_init_state as j_init_state
from fastdm_tpu.engine import FastDMEngine as JEngine
from fastdm_tpu.models import wan as jwan
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline.denoise_more import make_wan_denoiser as j_one_expert
from fastdm_tpu.pipeline.denoise_more import make_wan_dual_phase_denoiser as j_dual_phase
from fastdm_tpu.pipeline.denoise_more import make_wan_ti2v_denoiser as j_ti2v
from fastdm_tpu.pipeline.schedulers import FlowMatchEulerScheduler as JEuler
from fastdm_tpu.pipeline.schedulers import UniPCMultistepScheduler as JUniPC
from fastdm_tpu_torch.caching.config import CacheConfig
from fastdm_tpu_torch.caching import xcaching
from fastdm_tpu_torch.models import wan as twan
from fastdm_tpu_torch.models.convert import wan_params_from_numpy, wan_vae_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import wan_vae as tvae
from fastdm_tpu_torch.pipeline.denoise_wan import (
    make_wan_cached_denoiser,
    make_wan_dual_phase_denoiser,
    make_wan_ti2v_denoiser,
)
from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler as TEuler
from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler as TUniPC

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_wan import TINY, _state_dict  # noqa: E402
from test_torch_wan_cache import margins  # noqa: E402,F401  (the fixture)
from test_wan_vae import RES_TINY, _mk_diffusers_state_dict, _mk_residual_state_dict  # noqa: E402
from test_wan_vae import TINY as VAE_TINY  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

TEXT = 8
FHW = (3, 8, 8)  # 3 latent frames of 4x4 patches: 48 tokens, 16 a frame
# the Wan2.2-TI2V VAE layout at a tiny width: residual, 2x2 pixel patches
RES_P2 = dataclasses.replace(RES_TINY, patch_size=2)
VAE_FIELDS = ("base_dim", "z_dim", "dim_mult", "num_res_blocks", "temporal_downsample",
              "latents_mean", "latents_std", "patch_size", "is_residual")
# thresholds picked from a calibration over 0.01..0.1, each >= 5% from every
# decision of the tests that use it
CACHES = {
    "fbcache": dict(cache_algorithm="fbcache", threshold=0.04, warmup_steps=1),
    "dicache": dict(cache_algorithm="dicache", threshold=0.04, probe_depth=2, ret_ratio=0.2),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfgs(**kw):
    common = dict(TINY, text_len=TEXT, **kw)
    return jwan.WanConfig(**common), twan.WanConfig(**common)


def _tvcfg(jcfg):
    return tvae.WanVAEConfig(**{f: getattr(jcfg, f) for f in VAE_FIELDS})


def _wan_sd(seed, in_channels=TINY["in_channels"], out_channels=TINY["out_channels"]):
    """A tiny diffusers-layout Wan transformer state dict with the given
    channels (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    sd = _state_dict(rng)
    d = TINY["num_attention_heads"] * TINY["attention_head_dim"]
    sd["patch_embedding.weight"] = (rng.standard_normal((d, in_channels, 1, 2, 2)) * 0.05) \
        .astype(np.float32)
    sd["proj_out.weight"] = (rng.standard_normal((out_channels * 4, d)) * 0.05).astype(np.float32)
    sd["proj_out.bias"] = np.zeros(out_channels * 4, np.float32)
    return sd


def _jax_params(jcfg, sd):
    """JAX's tree from JAX's loader (the JAX random init runs op by op here,
    ~10 s at this size) and the port's from it through the converter."""
    jparams = jwan.wan_load(JSource(dict(sd)), jcfg)
    return jparams, wan_params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module", params=[None, "int8"])
def models(request):
    jcfg, tcfg = _cfgs(quant=request.param, per_token_timestep=True)
    jparams, tparams = _jax_params(jcfg, _wan_sd(0))
    return jcfg, jparams, tcfg, tparams


def _inputs(seed, fhw=FHW, channels=TINY["in_channels"]):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((1, channels, *fhw)).astype(np.float32)
    text = rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
    return video, text


def _token_t(sigma_t: float, fhw=FHW) -> np.ndarray:
    """The TI2V timestep: sigma_t on every token, 0 on frame 0's."""
    f, h, w = fhw
    per_frame = (h // 2) * (w // 2)
    t = np.full((1, f * per_frame), sigma_t, np.float32)
    t[:, :per_frame] = 0.0
    return t


# ------------------------------------------------------------ the model


def test_per_token_block_matches_jax(models):
    """One block on a (B, S, 6, D) modulation, every token its own."""
    jcfg, jparams, tcfg, tparams = models
    f, h, w = FHW
    s, d = f * (h // 2) * (w // 2), tcfg.inner_dim
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((1, s, d)).astype(np.float32)
    encoder = rng.standard_normal((1, TEXT, d)).astype(np.float32)
    t6 = (0.3 * rng.standard_normal((1, s, 6, d))).astype(np.float32)
    jc, js = jwan.wan_rope_cos_sin(jcfg, f, h, w)
    blk = jax.tree.map(lambda x: x[0], jparams["blocks"])
    want = jax.jit(jwan.wan_block, static_argnums=(6,))(
        blk, jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(encoder, jnp.bfloat16),
        jnp.asarray(t6, jnp.bfloat16), jc, js, jcfg, None)
    tc, ts = twan.wan_rope_cos_sin(tcfg, f, h, w, device="cpu")
    got = twan.wan_block(tparams.blocks[0], torch.from_numpy(hidden).bfloat16(),
                         torch.from_numpy(encoder).bfloat16(), torch.from_numpy(t6).bfloat16(),
                         tc, ts, tcfg, None)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, s, d)
    assert _rel_l2(got, want) <= 1e-2


def test_per_token_forward_matches_jax(models):
    """The TI2V forward: frame-0 tokens at timestep 0, the rest at 700."""
    jcfg, jparams, tcfg, tparams = models
    video, text = _inputs(1)
    t = _token_t(700.0)
    want = jwan.wan_forward(jparams, jcfg, jnp.asarray(video, jnp.bfloat16), jnp.asarray(t),
                            jnp.asarray(text, jnp.bfloat16))
    got = twan.wan_forward(tparams, tcfg, torch.from_numpy(video).bfloat16(),
                           torch.from_numpy(t), torch.from_numpy(text).bfloat16())
    assert tuple(got.shape) == want.shape == (1, TINY["out_channels"], *FHW)
    assert _rel_l2(got, want) <= 1e-2
    # frame 0's tokens take their own timestep: the output differs from a
    # forward with every token at 700
    flat = twan.wan_forward(tparams, tcfg, torch.from_numpy(video).bfloat16(),
                            torch.full((1,), 700.0), torch.from_numpy(text).bfloat16())
    assert _rel_l2(got[:, :, 0], flat[:, :, 0]) > 2e-3


def test_compact_timestep_on_a_per_token_config(models):
    """A (B,) timestep on a per-token config (the t2v loops' and bench.py's
    wan5b form) broadcasts as (B, 1, D): against JAX, and bit for bit the
    port's forward on the same config without per-token timesteps."""
    jcfg, jparams, tcfg, tparams = models
    video, text = _inputs(2)
    want = jwan.wan_forward(jparams, jcfg, jnp.asarray(video, jnp.bfloat16),
                            jnp.full((1,), 600.0, jnp.float32), jnp.asarray(text, jnp.bfloat16))
    args = (torch.from_numpy(video).bfloat16(), torch.full((1,), 600.0),
            torch.from_numpy(text).bfloat16())
    got = twan.wan_forward(tparams, tcfg, *args)
    assert _rel_l2(got, want) <= 1e-2
    plain = twan.wan_forward(tparams, dataclasses.replace(tcfg, per_token_timestep=False), *args)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("name", sorted(CACHES))
def test_per_token_forward_cached_matches_jax(models, name, margins):  # noqa: F811
    """Four steps of one stream through wan_forward_cached with per-token
    timesteps, a new latent each step: outputs and skip counts agree."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(CACHES[name], enable_caching=True, negtive_cache=True, threshold=0.025)
    jc, tc = JCacheConfig.from_dict(kw), CacheConfig.from_dict(kw)
    f, h, w = FHW
    shape = (1, f * (h // 2) * (w // 2), tcfg.inner_dim)
    base, text = _inputs(6)
    jst = j_init_state(jc, shape, shape)
    tst = xcaching.cache_init_state(tc, shape, shape, device="cpu")
    jforward = jax.jit(jwan.wan_forward_cached, static_argnums=(1, 2, 5))
    for step in range(4):
        video = base * (1 - 0.01 * step)
        t = _token_t(900.0 - 10 * step)
        want, jst = jforward(jparams, jcfg, jc, jst, jnp.int32(step), 4,
                             jnp.asarray(video, jnp.bfloat16), jnp.asarray(t),
                             jnp.asarray(text, jnp.bfloat16))
        got, tst = twan.wan_forward_cached(tparams, tcfg, tc, tst, step, 4,
                                           torch.from_numpy(video).bfloat16(),
                                           torch.from_numpy(t), torch.from_numpy(text).bfloat16())
        assert tst["skips"] == int(jst["skips"])
        assert _rel_l2(got, want) <= 1e-2
    assert tst["skips"] > 0


# ------------------------------------------------------------------ VAE


def test_vae_rearrangements_are_exact():
    """AvgDown3D, DupUp3D, patchify and unpatchify (NCDHW in the port, NDHWC
    in JAX) on integer-valued inputs, in every form the codec uses."""
    rng = np.random.default_rng(0)
    ncdhw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))  # noqa
    back = lambda t: t.permute(0, 2, 3, 4, 1).numpy()  # noqa: E731
    for t, c, out_c, ft, fs in ((5, 8, 16, 2, 2), (1, 8, 16, 2, 2), (4, 16, 16, 1, 2),
                                (3, 16, 16, 1, 1), (6, 4, 8, 2, 1)):
        x = rng.integers(-8, 8, (1, t, 4, 6, c)).astype(np.float32)
        want = np.asarray(jvae._avg_down3d(jnp.asarray(x), out_c, ft, fs))
        got = back(tvae._avg_down3d(ncdhw(x), out_c, ft, fs))
        assert got.shape == want.shape and np.array_equal(got, want), (t, c, out_c, ft, fs)
    for t, c, out_c, ft, fs in ((3, 16, 8, 2, 2), (1, 16, 8, 2, 2), (2, 16, 16, 1, 2),
                                (2, 32, 16, 2, 2)):
        x = rng.integers(-8, 8, (1, t, 3, 5, c)).astype(np.float32)
        for drop in (True, False):
            want = np.asarray(jvae._dup_up3d(jnp.asarray(x), out_c, ft, fs, drop))
            got = back(tvae._dup_up3d(ncdhw(x), out_c, ft, fs, drop))
            assert got.shape == want.shape and np.array_equal(got, want), (t, c, ft, drop)
    for p in (1, 2):
        x = rng.integers(-8, 8, (2, 3, 8, 12, 3)).astype(np.float32)
        want = np.asarray(jvae._patchify_frames(jnp.asarray(x), p))
        got = tvae._patchify_frames(torch.from_numpy(x), p).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(tvae._unpatchify_frames(torch.from_numpy(got), p).numpy(), x)
        assert np.array_equal(np.asarray(jvae._unpatchify_frames(jnp.asarray(want), p)), x)


def _vae_pair(monkeypatch, jcfg):
    """f32 JAX params loaded from a synthetic state dict of jcfg's layout
    (JAX's random init runs op by op here, ~45 s), and the port's from them
    through the converter."""
    monkeypatch.setattr(jvae, "_DTYPE", jnp.float32)
    sd = (_mk_residual_state_dict if jcfg.is_residual else _mk_diffusers_state_dict)(jcfg)
    jparams = jvae.wan_vae_load(JSource(sd), jcfg)
    return jparams, wan_vae_params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.mark.parametrize("jcfg", [RES_TINY, RES_P2], ids=["residual", "residual-p2"])
def test_residual_decode_matches_jax_f32(monkeypatch, jcfg):
    """The Wan2.2 decoder (DupUp3D shortcuts, channel-keeping upsample convs,
    the unpatchify), full and chunked, each against JAX's in float32."""
    jparams, tparams = _vae_pair(monkeypatch, jcfg)
    z = np.random.default_rng(17).standard_normal((1, jcfg.z_dim, 3, 2, 3)).astype(np.float32)
    s = 8 * jcfg.patch_size
    for jfn, tfn in ((jvae.wan_vae_decode, tvae.wan_vae_decode),
                     (jvae.wan_vae_decode_chunked, tvae.wan_vae_decode_chunked)):
        want = np.asarray(jax.jit(jfn, static_argnums=(1,))(jparams, jcfg, jnp.asarray(z)))
        got = tfn(tparams, _tvcfg(jcfg), torch.from_numpy(z), dtype=torch.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == (1, 9, 2 * s, 3 * s, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("jcfg,frames", [(VAE_TINY, 5), (RES_P2, 1), (RES_P2, 5)],
                         ids=["wan2.1-5f", "residual-p2-image", "residual-p2-5f"])
def test_encode_matches_jax_f32(monkeypatch, jcfg, frames):
    """wan_vae_encode in the Wan2.1 layout (latents_mean / latents_std) and
    the Wan2.2 one (AvgDown3D, patchify), a single image and a clip."""
    jparams, tparams = _vae_pair(monkeypatch, jcfg)
    s = 8 * jcfg.patch_size
    video = np.random.default_rng(frames).uniform(-1, 1, (1, frames, 2 * s, 3 * s, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(jvae.wan_vae_encode, static_argnums=(1,))(
        jparams, jcfg, jnp.asarray(video)))
    got = tvae.wan_vae_encode(tparams, _tvcfg(jcfg), torch.from_numpy(video), dtype=torch.float32)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (1, jcfg.z_dim, 1 + (frames - 1) // 4, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, node


def test_residual_load_matches_jax_loader(monkeypatch):
    """The nested Wan2.2 layout (encoder and decoder), loaded by both
    loaders from one synthetic state dict, bit for bit; and the random
    encoder + decoder have the loaded layout."""
    monkeypatch.setattr(jvae, "_DTYPE", jnp.float32)
    sd = _mk_residual_state_dict(RES_P2)
    jparams = jvae.wan_vae_load(JSource(dict(sd)), RES_P2)
    tparams = tvae.wan_vae_load(TSource(dict(sd), device="cpu"), _tvcfg(RES_P2),
                                dtype=torch.float32)
    got = dict(_leaves(tparams))
    want = dict(_leaves(wan_vae_params_from_numpy(jax.device_get(jparams), device="cpu")))
    assert got.keys() == want.keys() and any(k.startswith(".encoder") for k in got)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    up0 = tparams["decoder"]["up"][0]["upsample"]["w"]
    assert up0.shape[0] == up0.shape[1]  # the residual upsample conv keeps its channels
    cfg = _tvcfg(RES_P2)
    rand = {**tvae.wan_vae_decoder_random(0, cfg, device="cpu", dtype=torch.float32),
            **tvae.wan_vae_encoder_random(1, cfg, device="cpu", dtype=torch.float32)}
    rand = dict(_leaves(rand))
    assert rand.keys() == got.keys()
    for k in got:
        assert rand[k].shape == got[k].shape and rand[k].dtype == got[k].dtype, k


# ------------------------------------------------------------- denoisers


def _loop_inputs(jcfg, tcfg, seed, fhw=FHW, cond_channels=None):
    f, h, w = fhw
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, TINY["out_channels"], f, h, w)).astype(np.float32)
    cond = rng.standard_normal((1, cond_channels or TINY["out_channels"],
                                f if cond_channels else 1, h, w)).astype(np.float32)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    return ((jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(pos, jnp.bfloat16),
             jnp.asarray(neg, jnp.bfloat16), *jwan.wan_rope_cos_sin(jcfg, f, h, w)),
            (torch.from_numpy(lat), torch.from_numpy(cond), torch.from_numpy(pos).bfloat16(),
             torch.from_numpy(neg).bfloat16(), *twan.wan_rope_cos_sin(tcfg, f, h, w,
                                                                      device="cpu")))


def _ti2v_pair(jcfg, jparams, tcfg, tparams, jsched, tsched):
    """3 steps, CFG 5.0 on both sides: the clean first frame pinned every step
    and kept in the output, its tokens at timestep 0."""
    assert np.array_equal(jsched.sigmas, tsched.sigmas)
    jin, tin = _loop_inputs(jcfg, tcfg, 8)
    want, _ = j_ti2v(jcfg, jsched, 3, 5.0)(jparams, *jin)
    got, skips = make_wan_ti2v_denoiser(tcfg, tsched, 3, 5.0)(tparams, *tin)
    assert skips == 0 and got.dtype == torch.float32 and tuple(got.shape) == jin[0].shape
    assert torch.equal(got[:, :, :1], tin[1])
    assert _rel_l2(got, want) <= 2e-2


def test_ti2v_denoiser_matches_jax(models):
    _ti2v_pair(*models, JUniPC.create(3, shift=5.0), TUniPC.create(3, shift=5.0))


def test_ti2v_denoiser_with_euler_matches_jax():
    """The same loop on FlowMatch-Euler (shift 5, the engine's
    scheduler="euler"), in int8."""
    jcfg, tcfg = _cfgs(quant="int8", per_token_timestep=True)
    jparams, tparams = _jax_params(jcfg, _wan_sd(0))
    _ti2v_pair(jcfg, jparams, tcfg, tparams, JEuler.create(3, shift=5.0),
               TEuler.create(3, shift=5.0))


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cached_ti2v_denoiser_matches_jax(name, margins):  # noqa: F811
    """6 UniPC steps, CFG 5.0, both streams cached, in int8 (the engine's
    format): latents and skip counts."""
    jcfg, tcfg = _cfgs(quant="int8", per_token_timestep=True)
    jparams, tparams = _jax_params(jcfg, _wan_sd(0))
    kw = dict(CACHES[name], enable_caching=True, negtive_cache=True)
    jin, tin = _loop_inputs(jcfg, tcfg, 9)
    want, jskips = j_ti2v(jcfg, JUniPC.create(6, shift=5.0), 6, 5.0,
                          JCacheConfig.from_dict(kw))(jparams, *jin)
    got, skips = make_wan_ti2v_denoiser(tcfg, TUniPC.create(6, shift=5.0), 6, 5.0,
                                        CacheConfig.from_dict(kw))(tparams, *tin)
    assert skips == int(jskips) and skips > 0
    assert _rel_l2(got, want) <= 2e-2


def test_dual_phase_denoiser_with_cond_matches_jax():
    """Two experts taking 4 conditioning channels beside the 4 latent ones
    (in_channels 8), 4 UniPC steps, CFG 4.0 / 3.0, boundary 0.875."""
    jcfg, tcfg = _cfgs(quant="int8", in_channels=2 * TINY["out_channels"])
    (jp1, tp1), (jp2, tp2) = (_jax_params(jcfg, _wan_sd(s, 2 * TINY["out_channels"]))
                              for s in (1, 2))
    jin, tin = _loop_inputs(jcfg, tcfg, 10, cond_channels=TINY["out_channels"])
    jl, jc_, *jrest = jin
    tl, tc_, *trest = tin
    want, _ = j_dual_phase(jcfg, JUniPC.create(4, shift=5.0), 4, None, 4.0, 3.0, 0.875)(
        jp1, jp2, jl, *jrest, None, jc_)
    run = make_wan_dual_phase_denoiser(tcfg, TUniPC.create(4, shift=5.0), 4, 4.0, 3.0, 0.875)
    got, _ = run(tp1, tp2, tl, *trest, None, tc_)
    assert run.phase_steps == (2, 2) and tuple(got.shape) == jl.shape
    assert _rel_l2(got, want) <= 2e-2


# ---------------------------------------------------------------- engine


def _write_transformer(root, sub, seed, in_channels, out_channels, extra=None):
    """A tiny diffusers-layout Wan transformer with the given channels."""
    from safetensors.torch import save_file

    sd = _wan_sd(seed, in_channels, out_channels)
    os.makedirs(os.path.join(root, sub))
    save_file({k: torch.from_numpy(v) for k, v in sd.items()},
              os.path.join(root, sub, "model.safetensors"))
    with open(os.path.join(root, sub, "config.json"), "w") as f:
        json.dump(dict(TINY, in_channels=in_channels, out_channels=out_channels,
                       patch_size=[1, 2, 2], **(extra or {})), f)
    return sd


def _write_vae(root, jcfg, sd):
    from safetensors.torch import save_file

    os.makedirs(os.path.join(root, "vae"))
    save_file({k: torch.from_numpy(v) for k, v in sd.items()},
              os.path.join(root, "vae", "model.safetensors"))
    cj = {"base_dim": jcfg.base_dim, "z_dim": jcfg.z_dim, "dim_mult": list(jcfg.dim_mult),
          "num_res_blocks": jcfg.num_res_blocks,
          "temperal_downsample": list(jcfg.temporal_downsample),
          "patch_size": jcfg.patch_size, "is_residual": jcfg.is_residual}
    if jcfg.latents_mean is not None:
        cj.update(latents_mean=list(jcfg.latents_mean), latents_std=list(jcfg.latents_std))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump(cj, f)


def _embeds(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
            for _ in range(2)]


def _noise(seed, shape):
    """The engine's seeded noise (a torch.Generator on the CPU)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_engine_ti2v_checkpoint(tmp_path):
    """A tiny Wan2.2-TI2V-5B layout: pos_embed_seq_len in the transformer's
    config.json (per-token timesteps), the residual patchified VAE (spatial
    stride 16). t2v against JAX's one-expert loop on the same noise (the
    compact timestep on the per-token config) and with scheduler="euler";
    ti2v: frame 0 of the latents is the encoded image, the rest is the
    port's TI2V loop on the engine's noise, and the video decodes (1 + 4(F-1)
    frames at 16x the latents)."""
    from fastdm_tpu_torch.engine import FastDMEngine

    root = str(tmp_path)
    sd = _write_transformer(root, "transformer", 0, 4, 4, {"pos_embed_seq_len": 16})
    _write_vae(root, RES_P2, _mk_residual_state_dict(RES_P2))
    eng = FastDMEngine(root, architecture="wan2.2-ti2v", use_int8=True, verbose=False,
                       device="cpu")
    assert eng.cfg.per_token_timestep and eng.vae_cfg.patch_size == 2
    assert eng.vae_cfg.is_residual and "encoder" in eng.vae_params
    pos, neg = _embeds(3)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=96,
              num_frames=9, num_inference_steps=3, guidance_scale=5.0, seed=4)
    lat = eng.generate(**kw, output_type="latent")
    assert lat.shape == (1, 4, 3, 4, 6)
    jcfg = jwan.WanConfig(**dict(TINY, text_len=TEXT, per_token_timestep=True, quant="int8"))
    jparams = jwan.wan_load(JSource(dict(sd)), jcfg)
    noise = _noise(4, (1, 4, 3, 4, 6)).numpy()
    want, _ = j_one_expert(jcfg, JUniPC.create(3, shift=5.0), 3, 5.0)(
        jparams, None, jnp.asarray(noise), jnp.asarray(pos, jnp.bfloat16),
        jnp.asarray(neg, jnp.bfloat16), *jwan.wan_rope_cos_sin(jcfg, 3, 4, 6), None)
    assert _rel_l2(lat, want) <= 2e-2
    euler = FastDMEngine(root, architecture="wan2.2-ti2v", use_int8=True, verbose=False,
                         device="cpu", scheduler="euler")
    lat_e = euler.generate(**kw, output_type="latent")
    ref, _ = make_wan_cached_denoiser(eng.cfg, TEuler.create(3, shift=5.0), 3, None, 5.0)(
        eng.params, _noise(4, (1, 4, 3, 4, 6)), torch.from_numpy(pos).bfloat16(),
        torch.from_numpy(neg).bfloat16(), *twan.wan_rope_cos_sin(eng.cfg, 3, 4, 6, device="cpu"))
    np.testing.assert_array_equal(lat_e, ref.numpy())

    image = np.random.default_rng(5).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for task in ("ti2v", "i2v"):
        lat_i = eng.generate(task=task, image=image, **kw, output_type="latent")
        cond = tvae.wan_vae_encode(eng.vae_params, eng.vae_cfg,
                                   torch.from_numpy(image).float()[None, None] / 127.5 - 1.0)
        assert np.array_equal(lat_i[:, :, :1], cond.numpy())
        ref, _ = make_wan_ti2v_denoiser(eng.cfg, TUniPC.create(3, shift=5.0), 3, 5.0)(
            eng.params, _noise(4, (1, 4, 3, 4, 6)), cond, torch.from_numpy(pos).bfloat16(),
            torch.from_numpy(neg).bfloat16(),
            *twan.wan_rope_cos_sin(eng.cfg, 3, 4, 6, device="cpu"))
        np.testing.assert_array_equal(lat_i, ref.numpy())
    video = eng.generate(task="ti2v", image=image, **kw)
    assert video.dtype == np.uint8 and video.shape == (1, 9, 64, 96, 3)
    with pytest.raises(ValueError, match="per_token_timestep"):
        make_wan_ti2v_denoiser(dataclasses.replace(eng.cfg, per_token_timestep=False),
                               TUniPC.create(3, shift=5.0), 3)
    with pytest.raises(ValueError, match="'unipc' or 'euler'"):
        FastDMEngine(root, architecture="wan2.2-ti2v", device="cpu", scheduler="ddim")


def test_engine_i2v_dual_expert_checkpoint(tmp_path):
    """A tiny Wan2.2-I2V-A14B layout: two experts with in_channels 36 (16
    latent + 4 mask + 16 encoded channels), the Wan2.1-layout VAE with z_dim
    16. The conditioning channels equal the JAX engine's _wan_i2v_latents
    (the mask exactly; the encoding, bf16 on both sides, within relative L2
    2e-2), and the latents are the dual-phase loop's with them."""
    from fastdm_tpu_torch.engine import FastDMEngine

    root = str(tmp_path)
    for sub, seed in (("transformer", 0), ("transformer_2", 1)):
        _write_transformer(root, sub, seed, 36, 16)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"boundary_ratio": 0.875}, f)
    vcfg = dataclasses.replace(VAE_TINY, z_dim=16, latents_mean=tuple(0.05 * i for i in range(16)),
                               latents_std=tuple(1.0 + 0.05 * i for i in range(16)))
    vsd = _mk_diffusers_state_dict(vcfg)
    _write_vae(root, vcfg, vsd)
    eng = FastDMEngine(root, architecture="wan2.2-i2v", verbose=False, device="cpu")
    assert eng.params_2 is not None and eng.cfg.in_channels == 36
    pos, neg = _embeds(6)
    image = np.random.default_rng(7).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=32, width=48,
              num_frames=9, num_inference_steps=4, guidance_scale=4.0, guidance_scale_2=3.0,
              seed=2)
    lat = eng.generate(image=image, **kw, output_type="latent")  # no task: i2v
    assert lat.shape == (1, 16, 3, 4, 6) and eng.last_phase_steps == (2, 2)
    cond = eng._wan_i2v_latents(image, 3, 4, 6, 9)
    assert tuple(cond.shape) == (1, 20, 3, 4, 6)
    jeng = types.SimpleNamespace(vae_params=jvae.wan_vae_load(JSource(dict(vsd)), vcfg),
                                 vae_cfg=vcfg)
    want = np.asarray(jax.jit(lambda img: JEngine._wan_i2v_latents(jeng, img, 3, 4, 6, 9))(
        image))
    assert np.array_equal(cond[:, :4].numpy(), want[:, :4])
    assert _rel_l2(cond[:, 4:], want[:, 4:]) <= 2e-2
    run = make_wan_dual_phase_denoiser(eng.cfg, TUniPC.create(4, shift=5.0), 4, 4.0, 3.0, 0.875)
    ref, _ = run(eng.params, eng.params_2, _noise(2, (1, 16, 3, 4, 6)),
                 torch.from_numpy(pos).bfloat16(), torch.from_numpy(neg).bfloat16(),
                 *twan.wan_rope_cos_sin(eng.cfg, 3, 4, 6, device="cpu"), None, cond)
    np.testing.assert_array_equal(lat, ref.numpy())
    with pytest.raises(NotImplementedError, match="t2v, i2v, ti2v"):
        eng.generate(task="v2v", **kw)


def test_entry_points_default_to_the_card(tmp_path):
    """Without a GPU the new entry points raise unless the caller asks for
    the CPU: no quiet CPU run."""
    from fastdm_tpu_torch.engine import FastDMEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    root = str(tmp_path)
    _write_transformer(root, "transformer", 0, 4, 4, {"pos_embed_seq_len": 16})
    _write_vae(root, RES_P2, _mk_residual_state_dict(RES_P2))
    cfg = _tvcfg(RES_P2)
    for call in (lambda: tvae.wan_vae_encoder_random(0, cfg),
                 lambda: tvae.wan_vae_decoder_random(0, cfg),
                 lambda: FastDMEngine(root, architecture="wan2.2-ti2v", verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
