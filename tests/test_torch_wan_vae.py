"""The port's Wan 3D causal VAE decoder (fastdm_tpu_torch.pipeline.wan_vae)
against the JAX package: full and chunked decode, loader, random init.

The JAX module's compute dtype is a global (_DTYPE); its f32 comparisons
monkeypatch it, as tests/test_wan_vae.py does, and the port takes the same
dtype as an argument. Tolerances: in float32 both decodes are the same
convs, norms and attention on the same weights, summed in another order:
within 1e-4 + 1e-4*|x| of JAX; in bfloat16 (the production dtype) relative
L2 1e-1 of JAX: both round at the same points, but XLA and PyTorch round
the bf16 SiLU differently on many elements and each one-ulp flip passes
through ~20 random convolutions
(measured 4.0e-2 and 4.9e-2 on two seeds; JAX's own full and chunked bf16
decodes differ by 1.6e-2, from sum order alone); the chunked walk equals the
full decode to 1e-4 + 1e-4*|x| in float32 (the same windows); weights loaded
by both loaders, bit for bit.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdm_tpu.pipeline.wan_vae as jvae
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu_torch.models.convert import wan_vae_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import wan_vae as tvae

sys.path.insert(0, os.path.dirname(__file__))
from test_wan_vae import TINY, _mk_diffusers_state_dict  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

# the published Wan2.1/2.2-A14B channel law (base 96, z 16, mult (1,2,4,4),
# 2 res blocks) at a tiny spatial size
REAL = jvae.WanVAEConfig(base_dim=96, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2,
                         temporal_downsample=(False, True, True))
FIELDS = ("base_dim", "z_dim", "dim_mult", "num_res_blocks", "temporal_downsample",
          "latents_mean", "latents_std")


def _tcfg(jcfg):
    return tvae.WanVAEConfig(**{f: getattr(jcfg, f) for f in FIELDS})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _decode_pair(monkeypatch, jcfg, lat_shape, seed, dtype):
    if dtype == "f32":
        monkeypatch.setattr(jvae, "_DTYPE", jnp.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jparams = jvae.wan_vae_random(jax.random.key(seed), jcfg)
    tparams = wan_vae_params_from_numpy(jax.device_get(jparams), device="cpu")
    z = np.random.default_rng(seed).standard_normal(lat_shape).astype(np.float32)
    out = {}
    for name, jfn, tfn in (("full", jvae.wan_vae_decode, tvae.wan_vae_decode),
                           ("chunked", jvae.wan_vae_decode_chunked,
                            tvae.wan_vae_decode_chunked)):
        want = jfn(jparams, jcfg, jnp.asarray(z))
        got = tfn(tparams, _tcfg(jcfg), torch.from_numpy(z), dtype=tdt)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        out[name] = (_np(got), _np(want))
    return out


@pytest.mark.parametrize("cfg,lat_shape", [(TINY, (1, 4, 4, 4, 4)), (REAL, (1, 16, 3, 2, 2))],
                         ids=["tiny", "a14b-channels"])
def test_wan_vae_decode_matches_jax_f32(monkeypatch, cfg, lat_shape):
    out = _decode_pair(monkeypatch, cfg, lat_shape, 23, "f32")
    frames = 1 + 4 * (lat_shape[2] - 1)
    for got, want in out.values():
        assert got.shape == (1, frames, 8 * lat_shape[3], 8 * lat_shape[4], 3)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["chunked"][0], out["full"][0], rtol=1e-4, atol=1e-4)


def test_wan_vae_decode_matches_jax_bf16(monkeypatch):
    out = _decode_pair(monkeypatch, TINY, (1, 4, 3, 4, 4), 5, "bf16")
    for got, want in out.values():
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-1


def test_wan_vae_load_matches_jax_loader(monkeypatch):
    monkeypatch.setattr(jvae, "_DTYPE", jnp.float32)
    sd = _mk_diffusers_state_dict(TINY)
    jparams = jvae.wan_vae_load(JSource(dict(sd)), TINY)
    tparams = tvae.wan_vae_load(TSource(dict(sd), device="cpu"), _tcfg(TINY),
                                dtype=torch.float32)
    via_jax = wan_vae_params_from_numpy(jax.device_get(jparams), device="cpu")
    flat = lambda t: dict(_leaves(t))  # noqa: E731
    got, want = flat(tparams), flat(via_jax)
    assert got.keys() == want.keys() and "encoder" in tparams
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, node


def _random_vae(seed, cfg):
    return {**tvae.wan_vae_decoder_random(seed, cfg, device="cpu"),
            **tvae.wan_vae_encoder_random(seed + 1, cfg, device="cpu")}


def test_wan_vae_decoder_random_has_the_loader_layout():
    """Seeded, and with the random encoder the same tree, shapes and dtypes
    as a loaded VAE."""
    cfg = _tcfg(TINY)
    a, b = (_random_vae(3, cfg) for _ in range(2))
    loaded = tvae.wan_vae_load(TSource(_mk_diffusers_state_dict(TINY), device="cpu"), cfg)
    la, lb, ll = dict(_leaves(a)), dict(_leaves(b)), dict(_leaves(loaded))
    assert la.keys() == ll.keys()
    for k in la:
        assert torch.equal(la[k], lb[k])
        assert la[k].shape == ll[k].shape and la[k].dtype == ll[k].dtype, k


def test_wan_vae_decode_frame_layout():
    cfg = _tcfg(TINY)
    params = tvae.wan_vae_decoder_random(1, cfg, device="cpu")
    for f in (1, 2, 5):
        z = torch.zeros(1, cfg.z_dim, f, 2, 3)
        assert tuple(tvae.wan_vae_decode_chunked(params, cfg, z).shape) == \
            (1, 1 + 4 * (f - 1), 16, 24, 3)


def test_residual_vae_decoder_random_has_the_loader_layout():
    """The Wan2.2 layout (residual, 2x2 pixel patches): the random decoder and
    encoder have a loaded VAE's tree, shapes and dtypes; the upsample convs
    keep their channels and conv_out gives 3 * 2 * 2 channels."""
    from test_wan_vae import RES_TINY, _mk_residual_state_dict

    jcfg = dataclasses.replace(RES_TINY, patch_size=2)
    cfg = tvae.WanVAEConfig(**{f: getattr(jcfg, f) for f in FIELDS},
                            patch_size=2, is_residual=True)
    rand = dict(_leaves(_random_vae(4, cfg)))
    loaded = dict(_leaves(tvae.wan_vae_load(TSource(_mk_residual_state_dict(jcfg),
                                                    device="cpu"), cfg)))
    assert rand.keys() == loaded.keys()
    for k in rand:
        assert rand[k].shape == loaded[k].shape and rand[k].dtype == loaded[k].dtype, k
    assert rand[".decoder.up.0.upsample.w"].shape[:2] == (cfg.decoder_dims[1],) * 2
    assert rand[".decoder.conv_out.w"].shape[0] == 12
