"""The port's ComfyUI forward wrappers (fastdm_tpu_torch/comfyui_entry.py)
against the JAX package's (fastdm_tpu/comfyui_entry.py), on the same torch
CPU inputs, with the JAX params carried across by models/convert.py.

Tolerances (relative L2 of each output to JAX's), those of the family's own
forward test: FLUX, SD3.5, Qwen-Image and the FLUX ControlNet 1e-2 in bf16
(tests/test_torch_flux.py, test_torch_sd35.py, test_torch_qwen.py,
test_torch_controlnet.py); the SDXL UNet and ControlNet 5e-2
(tests/test_torch_sdxl.py, test_torch_controlnet.py, whose tiny UNet these
use: one-ulp attention
differences grow through the GroupNorm resnets; the reference's SiLU
patched to f32 as there). HostStepCache's slot choices and resets are
compared with JAX's on scripted option sequences, and the cached FLUX /
SD3.5 / Qwen wrappers skip exactly the steps JAX's skip, on inputs that
move along a flow-matching path; every threshold lies >= 5% from every
decision the port takes (the `margins` fixture)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from fastdm_tpu import comfyui_entry as jce
from fastdm_tpu.caching.xcaching import AutoCache as JAutoCache
from fastdm_tpu.models import controlnets as jcn
from fastdm_tpu.models import flux as jflux
from fastdm_tpu.models import sdxl as jsdxl
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu_torch import comfyui_entry as tce
from fastdm_tpu_torch.caching import AutoCache as TAutoCache
from fastdm_tpu_torch.caching import config as tcc
from fastdm_tpu_torch.models import controlnets as tcn
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models import sdxl as tsdxl
from fastdm_tpu_torch.models.convert import flux_controlnet_params_from_numpy, \
    flux_params_from_numpy, sdxl_controlnet_params_from_numpy, sdxl_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
from test_engine_e2e import _flux_cn_sd  # noqa: E402
from test_torch_controlnet import CN_TINY, _raw_hint_sd, _unet_sd  # noqa: E402
from test_golden_flux import _synthetic_state_dict  # noqa: E402
from test_torch_qwen import _pair as qwen_pair  # noqa: E402
from test_torch_sd35 import _pair as sd35_pair  # noqa: E402
from test_torch_sd35 import margins  # noqa: E402,F401  (fixture)
from test_torch_sdxl import correctly_rounded_silu  # noqa: E402,F401
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

FLUX = dict(num_layers=2, num_single_layers=1, attention_head_dim=32, num_attention_heads=2,
            joint_attention_dim=24, pooled_projection_dim=16, in_channels=8, out_channels=8,
            axes_dims_rope=(8, 12, 12), guidance_embeds=True, patch_size=1)
FLUX_CN = dict(num_layers=1, num_single_layers=1, attention_head_dim=32, num_attention_heads=4,
               joint_attention_dim=64, pooled_projection_dim=48, in_channels=16,
               out_channels=16, axes_dims_rope=(8, 12, 12), guidance_embeds=True)
TOL = {"flux": 1e-2, "sd3": 1e-2, "qwen": 1e-2, "flux_cn": 1e-2, "sdxl": 5e-2, "sdxl_cn": 5e-2}


def _sdxl_sd_ip(seed: int) -> dict:
    """The tiny SDXL UNet of tests/test_torch_controlnet.py (one transformer
    layer at levels 2 and mid) with IP-Adapter k and v on every
    cross-attention."""
    rng = np.random.default_rng(seed)
    sd = _unet_sd(rng)
    for name in [n for n in sd if n.endswith("attn2.to_k.weight")]:
        p = name[:-len("to_k.weight")] + "processor"
        for kv in ("to_k_ip", "to_v_ip"):
            sd[f"{p}.{kv}.0.weight"] = rng.standard_normal(sd[name].shape).astype(
                np.float32) * 0.05
    return sd


def _t(shape, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32) * scale)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


_MODELS = {}


def _models(name):
    """(JAX params, JAX cfg, port params, port cfg), built once a name."""
    if name in _MODELS:
        return _MODELS[name]
    if name == "flux":
        jc, tc = jflux.FluxConfig(quant=None, **FLUX), tflux.FluxConfig(quant=None, **FLUX)
        jp = jflux.flux_load(JSource(_synthetic_state_dict(FLUX, np.random.default_rng(0))), jc)
        tp = flux_params_from_numpy(jax.device_get(jp), device="cpu")
    elif name == "sd3":
        jc, jp, tc, tp, _ = sd35_pair(None)
    elif name == "qwen":
        jc, jp, tc, tp, _ = qwen_pair(None, port_load=False)
    elif name == "sdxl":
        jc = jsdxl.SDXLConfig(quant=None, ip_adapter=True, **CN_TINY)
        tc = tsdxl.SDXLConfig(quant=None, ip_adapter=True, **CN_TINY)
        jp = jsdxl.sdxl_load(JSource(_sdxl_sd_ip(6)), jc)
        tp = sdxl_params_from_numpy(jax.device_get(jp), device="cpu")
    elif name == "sdxl_cn":
        jc, tc = jsdxl.SDXLConfig(quant=None, **CN_TINY), tsdxl.SDXLConfig(quant=None, **CN_TINY)
        jp = jcn.sdxl_controlnet_load(JSource(dict(_unet_sd(np.random.default_rng(1), True))),
                                      jc)
        tp = sdxl_controlnet_params_from_numpy(jax.device_get(jp), device="cpu")
    else:
        jc = jcn.FluxControlNetConfig(quant=None, **FLUX_CN)
        tc = tcn.FluxControlNetConfig(quant=None, **FLUX_CN)
        jp = jcn.flux_controlnet_load(
            JSource(dict(_flux_cn_sd(np.random.default_rng(1), FLUX_CN))), jc)
        tp = flux_controlnet_params_from_numpy(jax.device_get(jp), device="cpu")
    _MODELS[name] = (jp, jc, tp, tc)
    return _MODELS[name]


def _calls(name):
    """(wrapper class name, list of ComfyUI keyword calls) of one family;
    the FLUX and Qwen latents have an odd side (edge padding)."""
    if name == "flux":
        return "ComfyUIFluxForwardWrapper", [
            dict(x=_t((1, 2, 7, 8), 1), timestep=torch.tensor([0.6]), context=_t((1, 5, 24), 3),
                 y=_t((1, 16), 4), guidance=torch.tensor([3.5])),
            dict(x=_t((1, 2, 7, 8), 5), timestep=torch.tensor([0.3]), context=_t((1, 5, 24), 6),
                 y=_t((1, 16), 7))]   # no guidance: 3.5 as in JAX
    if name == "sd3":
        return "ComfyUISD3ForwardWrapper", [
            dict(x=_t((1, 4, 16, 16), 1), timestep=torch.tensor([0.5]),
                 context=_t((1, 6, 32), 2), y=_t((1, 24), 3))]
    if name == "qwen":
        return "ComfyUIQwenForwardWrapper", [
            dict(x=_t((1, 4, 6, 7), 1), timestep=torch.tensor([0.7]), context=_t((1, 5, 24), 2))]
    if name == "sdxl":
        return "ComfyUISDXLForwardWrapper", [
            dict(x=_t((2, 4, 8, 8), 1), timesteps=torch.tensor([500.0, 500.0]),
                 context=_t((2, 6, 16), 3), y=_t((2, 8 + 24), 4))]
    if name == "sdxl_cn":
        return "ComfyUISDXLControlnetForwardWrapper", [
            dict(x=_t((1, 4, 8, 8), 1), hint=torch.from_numpy(
                np.random.default_rng(2).random((1, 3, 64, 64)).astype(np.float32)),
                 timesteps=torch.tensor([400.0]), context=_t((1, 6, 16), 3),
                 y=_t((1, 32), 4))]
    return "ComfyUIFluxControlnetForwardWrapper", [
        dict(x=_t((1, 4, 8, 7), 1), hint=_t((1, 4, 8, 7), 2), timesteps=torch.tensor([0.4]),
             context=_t((1, 6, 64), 3), y=_t((1, 48), 4), guidance=torch.tensor([3.5]))]


def _flat(out):
    if isinstance(out, dict):
        return [(f"{k}[{i}]", o) for k in sorted(out) for i, o in enumerate(out[k])]
    return [("out", out)]


_JAX_WRAPPERS = {}


def _jax_wrapper(name, monkeypatch):
    """The JAX wrapper of a family, one instance a name (its jitted forward
    compiles once). JAX's ControlNet wrappers call their forward eagerly,
    op by op; here it runs jitted, the same function traced once."""
    if name == "sdxl_cn":
        monkeypatch.setattr(jcn, "sdxl_controlnet_forward",
                            jax.jit(jcn.sdxl_controlnet_forward, static_argnums=(1,)))
    if name not in _JAX_WRAPPERS:
        jp, jc, _, _ = _models(name)
        _JAX_WRAPPERS[name] = getattr(jce, _calls(name)[0])(jp, jc)
    return _JAX_WRAPPERS[name]


@pytest.mark.parametrize("name", ["flux", "sd3", "qwen", "sdxl", "sdxl_cn", "flux_cn"])
def test_wrapper_matches_jax(name, correctly_rounded_silu, monkeypatch):
    jp, jc, tp, tc = _models(name)
    cls, calls = _calls(name)
    jw, tw = _jax_wrapper(name, monkeypatch), getattr(tce, cls)(tp, tc)
    for kw in calls:
        want, got = jw(**kw), tw(**kw)
        assert [k for k, _ in _flat(got)] == [k for k, _ in _flat(want)]
        for (k, g), (_, w) in zip(_flat(got), _flat(want)):
            assert g.dtype == kw["x"].dtype and g.device == kw["x"].device, k
            assert g.shape == w.shape, (k, g.shape, w.shape)
            assert torch.isfinite(g).all(), k
            assert _rel_l2(g, w) <= TOL[name], (k, _rel_l2(g, w))
    if name == "flux":
        assert len(tw._rope_cache) == 1  # one shape: one table
        # a bf16 x comes back in bf16
        kw = dict(calls[0], x=calls[0]["x"].to(torch.bfloat16))
        assert tw(**kw).dtype == torch.bfloat16
    if name == "sd3":
        assert len(tw._pos_cache) == 1


def test_pad_to_patch_size_repeats_the_edge_as_jax():
    x = _t((1, 3, 5, 7), 9)
    got, hw = tce.pad_to_patch_size(x)
    want, jhw = jce.pad_to_patch_size(x.numpy())
    assert hw == jhw == (5, 7) and tuple(got.shape) == (1, 3, 6, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    same, _ = tce.pad_to_patch_size(_t((1, 3, 4, 6)))
    assert tuple(same.shape) == (1, 3, 4, 6)


# (step, total, marker) scripts: a new run, CFG repeats, a third chunk, a jump,
# another schedule length, a backward move, labels in either order
SCRIPTS = {
    "cfg_pairs": [(0, 10, None), (0, 10, None), (0, 10, None), (1, 10, None), (1, 10, None),
                  (2, 10, None)],
    "jump": [(0, 10, None), (1, 10, None), (5, 10, None), (6, 10, None)],
    "schedule": [(0, 10, None), (1, 10, None), (2, 25, None), (3, 25, None)],
    "backward": [(0, 10, None), (1, 10, None), (2, 10, None), (0, 10, None), (1, 10, None)],
    "markers": [(0, 10, 1), (0, 10, 0), (1, 10, 1), (1, 10, 0), (1, 10, None), (0, 10, 1),
                (1, 10, 0)],
    "no_total": [(0, None, None), (0, None, None), (1, None, None), (3, None, None)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_host_step_cache_slots_match_jax(script):
    from fastdm_tpu.caching.config import DiCacheConfig as JDi

    kw = dict(cache_algorithm="dicache", enable_caching=True, threshold=0.2, probe_depth=1,
              ret_ratio=0.2)
    j, t = jce.HostStepCache(JDi(**kw)), tce.HostStepCache(tcc.DiCacheConfig(**kw))
    for step, total, marker in SCRIPTS[script]:
        slots = (j.begin(step, total, marker=marker), t.begin(step, total, marker=marker))
        assert slots[0] == slots[1], (script, step, total, marker)
        # a reset drops the states: mark the chosen slot and compare
        for c in (j, t):
            c.states[slots[0]] = {"skips": 1}
        assert [s is None for s in t.states] == [s is None for s in j.states]
        assert t.skips == j.skips


@pytest.mark.parametrize("opts", [{"cond_or_uncond": [0]}, {"cond_or_uncond": [1]},
                                  {"cond_or_uncond": [torch.tensor(1)]},
                                  {"cond_or_uncond": [0, 1]}, {"cond_or_uncond": [1, 0]}, {},
                                  {"cond_or_uncond": []}, {"cond_or_uncond": ["x"]},
                                  {"cond_or_uncond": [2]}])
def test_marker_from_options_matches_jax(opts):
    assert tce.HostStepCache.marker_from_options(opts) == \
        jce.HostStepCache.marker_from_options(opts)


def test_step_from_options_matches_jax():
    sigmas = torch.linspace(1.0, 0.0, 9)
    for i in range(9):
        opts = {"sample_sigmas": sigmas, "sigmas": sigmas[i:i + 1]}
        assert tce.HostStepCache.step_from_options(opts) == \
            jce.HostStepCache.step_from_options(opts) == (i, 9)
    for opts in ({}, {"sample_sigmas": sigmas}, {"sample_sigmas": sigmas,
                                                 "sigmas": torch.tensor([0.123])}):
        assert tce.HostStepCache.step_from_options(opts) is None
        assert jce.HostStepCache.step_from_options(opts) is None


def _path(x0, noise, sigma):
    """A flow-matching sampler's input at sigma: (1 - sigma) x0 + sigma noise."""
    return (1.0 - sigma) * x0 + sigma * noise


# name: (cache JSON, ComfyUI keyword inputs but x, latent shape); thresholds
# picked from the accumulated errors of a run at a threshold no step reaches,
# so that steps both skip and compute, each >= 5% from every decision
STEPS = 6
CACHED = {
    "flux": (dict(cache_algorithm="dicache", threshold=0.3, probe_depth=1, ret_ratio=0.2),
             lambda: dict(context=_t((1, 5, 24), 3), y=_t((1, 16), 4),
                          guidance=torch.tensor([3.5])), (1, 2, 8, 8)),
    "sd3": (dict(cache_algorithm="fbcache", threshold=0.1, warmup_steps=1),
            lambda: dict(context=_t((1, 6, 32), 2), y=_t((1, 24), 3)), (1, 4, 16, 16)),
    "qwen": (dict(cache_algorithm="teacache", threshold=0.045, coefficients=[1.0, 0.0]),
             lambda: dict(context=_t((1, 5, 24), 2)), (1, 4, 6, 8)),
}


@pytest.mark.parametrize("name", sorted(CACHED))
def test_cached_wrappers_skip_as_jax(name, margins):
    """STEPS sampler steps, each a CFG pair (cond then uncond, labelled by
    cond_or_uncond) with another context for the negative stream; the
    inputs move along a flow path. Equal skip counts, states on both
    slots, and outputs within the family's tolerance."""
    cache_json, extra, shape = CACHED[name]
    jp, jc, tp, tc = _models(name)
    cls, _ = _calls(name)
    cache_json = dict(cache_json, enable_caching=True)
    jw = getattr(jce, cls)(jp, jc, cache=JAutoCache.from_dict(cache_json))
    tw = getattr(tce, cls)(tp, tc, cache=TAutoCache.from_dict(cache_json))
    sigmas = torch.linspace(1.0, 0.0, STEPS + 1)
    x0, noise = _t(shape, 11), _t(shape, 12)
    pos = extra()
    neg = {k: (v + 0.5 * _t(v.shape, 13)) if k == "context" else v for k, v in pos.items()}
    t_name = "timestep"
    for i in range(STEPS):
        x = _path(x0, noise, float(sigmas[i]))
        for marker, kw in ((0, pos), (1, neg)):
            opts = {"sample_sigmas": sigmas, "sigmas": sigmas[i:i + 1],
                    "cond_or_uncond": [marker]}
            call = dict(kw, x=x, transformer_options=opts, **{t_name: sigmas[i:i + 1]})
            want, got = jw(**call), tw(**call)
            assert _rel_l2(got, want) <= TOL[name] * 2, (i, marker, _rel_l2(got, want))
    assert all(st is not None for st in tw.cache.states)
    assert tw.cache.skips == jw.cache.skips
    assert 0 < tw.cache.skips < 2 * STEPS  # some steps skip, some compute
    assert margins  # the port took threshold decisions


def test_cached_wrapper_without_sigmas_runs_uncached():
    jp, jc, tp, tc = _models("flux")
    cache = TAutoCache.from_dict(dict(cache_algorithm="dicache", enable_caching=True,
                                      threshold=0.2, probe_depth=1, ret_ratio=0.2))
    cached = tce.ComfyUIFluxForwardWrapper(tp, tc, cache=cache)
    plain = tce.ComfyUIFluxForwardWrapper(tp, tc)
    kw = _calls("flux")[1][0]
    got = cached(**kw)
    assert all(st is None for st in cached.cache.states)
    assert torch.equal(got, plain(**kw))
    # a sigma that is not in the schedule runs uncached too
    opts = {"sample_sigmas": torch.linspace(1.0, 0.0, 5), "sigmas": torch.tensor([0.123])}
    assert torch.equal(cached(**kw, transformer_options=opts), got)
    assert all(st is None for st in cached.cache.states)
    # caching off in the config: no host cache at all
    off = TAutoCache.from_dict(dict(cache_algorithm="dicache", enable_caching=False))
    assert tce.ComfyUIFluxForwardWrapper(tp, tc, cache=off).cache is None


class _Patch:
    def __init__(self, cond, uncond):
        self.kwargs = [{"cond": cond, "uncond": uncond, "weight": 0.8,
                        "sigma_start": 999.0, "sigma_end": 1.0}]


def test_sdxl_ip_patch_is_sigma_gated_and_routed_as_jax(correctly_rounded_silu, monkeypatch):
    """In the sigma window the IP tokens change the output (as JAX's, within
    the SDXL tolerance); outside it the output equals the no-patch output
    bit for bit; flipping cond_or_uncond swaps the halves' tokens."""
    jp, jc, tp, tc = _models("sdxl")
    jw, tw = _jax_wrapper("sdxl", monkeypatch), tce.ComfyUISDXLForwardWrapper(tp, tc)
    kw = _calls("sdxl")[1][0]
    base = {"patches_replace": {"attn2": {("input", 4, 0): _Patch(_t((1, 4, 16), 5),
                                                                   _t((1, 4, 16), 6))}},
            "cond_or_uncond": [0, 1]}
    plain = tw(**kw)
    outs = {}
    for label, opts in (("in", dict(base, sigmas=torch.tensor([10.0]))),
                        ("out", dict(base, sigmas=torch.tensor([0.5]))),
                        ("flip", dict(base, sigmas=torch.tensor([10.0]), cond_or_uncond=[1, 0]))):
        outs[label] = tw(**kw, transformer_options=opts)
        want = jw(**kw, transformer_options=opts)
        assert _rel_l2(outs[label], want) <= TOL["sdxl"], (label, _rel_l2(outs[label], want))
    assert torch.equal(outs["out"], plain)
    assert (outs["in"] - plain).abs().max().item() > 1e-3
    assert (outs["flip"] - outs["in"]).abs().max().item() > 1e-3
    embeds, scale = tw._ip_from_options(dict(base, sigmas=torch.tensor([10.0])), 2)
    assert tuple(embeds.shape) == (2, 4, 16) and scale == 0.8


def test_raw_hint_flux_controlnet_wrapper_takes_the_image():
    """A raw-hint FLUX ControlNet (input_hint_block) gets the hint image as
    it is, NCHW (the JAX wrapper packs every hint, which only a latent-hint
    ControlNet takes): the wrapper equals flux_controlnet_forward on the
    image, bit for bit."""
    from fastdm_tpu_torch.models.flux import flux_rope_cache
    from fastdm_tpu_torch.models.loader import TensorSource
    from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents

    rng = np.random.default_rng(3)
    sd = _raw_hint_sd(rng, _flux_cn_sd(rng, FLUX_CN))
    tc = tcn.FluxControlNetConfig(quant=None, **FLUX_CN)
    tp = tcn.flux_controlnet_load(TensorSource(dict(sd), "cpu"), tc)
    x, hint = _t((1, 4, 8, 8), 1), torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    ctx, y = _t((1, 6, 64), 3), _t((1, 48), 4)
    t, g = torch.tensor([0.4]), torch.tensor([3.5])
    got = tce.ComfyUIFluxControlnetForwardWrapper(tp, tc)(x, hint=hint, timesteps=t,
                                                          context=ctx, y=y, guidance=g)
    cos, sin = flux_rope_cache(tc, 6, 4, 4, device="cpu")
    with torch.inference_mode():
        bs, sbs = tcn.flux_controlnet_forward(tp, tc, flux_pack_latents(x.bfloat16()),
                                              hint.bfloat16(), ctx.bfloat16(), y.bfloat16(), t,
                                              cos, sin, guidance=g)
    assert torch.equal(got["input"][0], bs[0].float()) and torch.equal(got["output"][0],
                                                                       sbs[0].float())
