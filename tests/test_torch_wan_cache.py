"""FBCache and DiCache on the port's Wan path against the JAX package: the
cache configs, the skip decisions and states of cached_run over a step
sequence, wan_forward_cached, the cached one-expert and phase-split
dual-expert denoisers, and the engine with the published cache JSONs, on
tiny configs (2 heads x 24, 3 layers), inputs from numpy seeds, JAX random
params moved across by the converter.

The decisions are threshold comparisons on bfloat16 forwards, where XLA and
PyTorch round about 40% of GELU/SiLU elements one ulp apart. So the inputs
and thresholds are chosen so that no decision is borderline -- every
accumulated error a test meets lies at least 5% of the threshold away from
it, which the tests assert -- and the decision sequences (skip counts) are
compared exactly. Tolerances: cached_run on given tensors within one bf16
ulp of JAX (the DiCache extrapolation's gamma is a ratio of f32 means summed
in another order; everything else rounds at the same points); the Wan
outputs and the denoisers' latents within relative L2 1e-2 and 2e-2 of JAX,
as tests/test_torch_wan.py holds the uncached ones.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.caching.config import CacheConfig as JCacheConfig
from fastdm_tpu.caching.xcaching import cache_init_state as j_init_state
from fastdm_tpu.caching.xcaching import cached_run as j_cached_run
from fastdm_tpu.models import wan as jwan
from fastdm_tpu.pipeline.denoise_more import make_wan_cached_denoiser as j_cached
from fastdm_tpu.pipeline.denoise_more import make_wan_dual_phase_denoiser as j_dual_phase
from fastdm_tpu.pipeline.schedulers import UniPCMultistepScheduler as JUniPC
from fastdm_tpu_torch.caching import xcaching
from fastdm_tpu_torch.caching.config import CacheConfig, DiCacheConfig, FBCacheConfig
from fastdm_tpu_torch.models import wan as twan
from fastdm_tpu_torch.models.convert import wan_params_from_numpy
from fastdm_tpu_torch.pipeline.denoise_wan import (
    make_wan_cached_denoiser,
    make_wan_dual_phase_denoiser,
)
from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler as TUniPC

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_wan import TINY  # noqa: E402
from test_torch_wan import _write_wan_checkpoint  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "examples", "xcaching", "configs")
TEXT = 8
FHW = (4, 8, 8)  # 4 latent frames of 4x4 patches: 64 tokens

# name: config keys (thresholds chosen away from every accumulated error)
CACHES = {
    "fbcache": dict(cache_algorithm="fbcache", threshold=0.03, warmup_steps=1),
    "dicache-delta_y": dict(cache_algorithm="dicache", threshold=0.03, probe_depth=2,
                            ret_ratio=0.2),
    "dicache-delta_minus": dict(cache_algorithm="dicache", threshold=0.1, probe_depth=1,
                                ret_ratio=0.2, rel_l1_distance_algo="delta_minus"),
}


def _configs(name, **override):
    kw = dict(CACHES[name], enable_caching=True, negtive_cache=True, **override)
    return JCacheConfig.from_dict(kw), CacheConfig.from_dict(kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.fixture
def margins(monkeypatch):
    """Records, for every decision the port takes that is not forced, how
    far the accumulated error lies from the threshold, relative to it."""
    seen = []
    decide = xcaching._decide

    def spy(cfg, state, error, step, total_steps):
        should, accum = decide(cfg, state, error, step, total_steps)
        forced = step <= (cfg.warmup_steps if isinstance(cfg, FBCacheConfig)
                          else int(cfg.ret_ratio * total_steps))
        if not forced:
            seen.append(abs(float(state["accum"] + error) / cfg.threshold - 1.0))
        return should, accum

    monkeypatch.setattr(xcaching, "_decide", spy)
    yield seen
    assert not seen or min(seen) > 0.05, f"a decision lies within 5% of its threshold: {seen}"


@pytest.fixture(scope="module")
def model():
    common = dict(TINY, text_len=TEXT, num_layers=3, quant="int8")
    jcfg, tcfg = jwan.WanConfig(**common), twan.WanConfig(**common)
    jparams = jwan.wan_init_random(jax.random.key(0), jcfg)
    return jcfg, jparams, tcfg, wan_params_from_numpy(jax.device_get(jparams), device="cpu")


def test_cache_configs_read_the_reference_jsons():
    """examples/xcaching/configs/{fbcache,dicache}_wan.json load unchanged,
    field for field as the JAX package reads them."""
    for name, cls in (("fbcache_wan.json", FBCacheConfig), ("dicache_wan.json", DiCacheConfig)):
        path = os.path.join(CONFIGS, name)
        mine, theirs = CacheConfig.from_json(path), JCacheConfig.from_json(path)
        assert isinstance(mine, cls) and mine.negtive_cache and mine.enable_caching
        assert {f.name: getattr(mine, f.name) for f in dataclasses.fields(mine)} == \
            {f.name: getattr(theirs, f.name) for f in dataclasses.fields(theirs)}
    tea = CacheConfig.from_dict({"cache_algorithm": "teacache", "coefficients": [1.0, 0.0],
                                 "negtive_coefficients": [2.0, 0.0]})
    assert xcaching.negative_stream_config(tea).coefficients == (2.0, 0.0)
    fb = CacheConfig.from_json(os.path.join(CONFIGS, "fbcache_wan.json"))
    assert xcaching.negative_stream_config(fb) is fb


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cached_run_matches_jax(name, margins):
    """Eight steps on given tensors: the probe scales a fixed tensor by a
    per-step factor, so each step's error is known in advance and the
    threshold sits away from it; the decisions, outputs and states of every
    step equal JAX's."""
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(5)
    shape = (1, 16, 8)
    base = rng.standard_normal(shape).astype(np.float32)
    factors = [1.0, 1.01, 1.02, 1.06, 1.065, 1.07, 1.2, 1.21]
    jst = j_init_state(jcfg, shape, shape)
    tst = xcaching.cache_init_state(tcfg, shape, shape, device="cpu")
    decisions = []
    for step, fac in enumerate(factors):
        hidden = (base + 0.01 * step).astype(np.float32)
        probe = (base * fac).astype(np.float32)
        out = (base * fac + rng.standard_normal(shape) * 0.1).astype(np.float32)
        pair = [(jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16())
                for a in (hidden, probe, out)]
        (jh, th), (jp, tp), (jo, to) = pair
        jout, jst = j_cached_run(jcfg, jst, jnp.int32(step), len(factors), jh, jh,
                                 lambda h, e, p=jp: (p, (p, e)), lambda h, e, o=jo: o)
        skips = tst["skips"]
        tout, tst = xcaching.cached_run(tcfg, tst, step, len(factors), th, th,
                                        lambda h, e, p=tp: (p, (p, e)), lambda h, e, o=to: o)
        decisions.append(tst["skips"] == skips)
        assert tst["skips"] == int(jst["skips"]), f"step {step}: skip decisions differ"
        want = _np(jout)
        assert (np.abs(_np(tout) - want) <= _bf16_ulp(want)).all()
        for key in ("prev_residual", "prev_probe", "residual_m1", "residual_m2", "prev_input"):
            if key in jst:
                ref = _np(jst[key])
                assert (np.abs(_np(tst[key]) - ref) <= _bf16_ulp(ref)).all(), key
        assert abs(float(tst["accum"]) - float(jst["accum"])) <= 1e-6 + 1e-5 * float(jst["accum"])
        if "window_count" in jst:
            assert tst["window_count"] == int(jst["window_count"])
    assert any(decisions[2:]) and not all(decisions), "the sequence should compute and skip"


@pytest.mark.parametrize("name", ["fbcache", "dicache-delta_y"])
def test_wan_forward_cached_matches_jax(model, name, margins):
    """Four steps of one stream through wan_forward_cached on both sides, a
    new latent each step; the outputs and the skip counts agree."""
    jcfg, jparams, tcfg, tparams = model
    jc, tc = _configs(name, threshold=0.025)
    f, h, w = FHW
    shape = (1, f * (h // 2) * (w // 2), tcfg.inner_dim)
    rng = np.random.default_rng(6)
    base = rng.standard_normal((1, TINY["in_channels"], f, h, w)).astype(np.float32)
    text = rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
    jst = j_init_state(jc, shape, shape)
    tst = xcaching.cache_init_state(tc, shape, shape, device="cpu")
    jforward = jax.jit(jwan.wan_forward_cached, static_argnums=(1, 2, 5))
    for step in range(4):
        video = base * (1 - 0.01 * step)
        t = 900.0 - 10 * step
        want, jst = jforward(
            jparams, jcfg, jc, jst, jnp.int32(step), 4, jnp.asarray(video, jnp.bfloat16),
            jnp.full((1,), t, jnp.float32), jnp.asarray(text, jnp.bfloat16))
        got, tst = twan.wan_forward_cached(
            tparams, tcfg, tc, tst, step, 4, torch.from_numpy(video).bfloat16(),
            torch.full((1,), t), torch.from_numpy(text).bfloat16())
        assert tst["skips"] == int(jst["skips"])
        assert _rel_l2(got, want) <= 1e-2
    assert tst["skips"] > 0


def _denoiser_inputs(jcfg, tcfg, seed):
    f, h, w = FHW
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, TINY["out_channels"], f, h, w)).astype(np.float32)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    jrope = jwan.wan_rope_cos_sin(jcfg, f, h, w)
    trope = twan.wan_rope_cos_sin(tcfg, f, h, w, device="cpu")
    jin = (jnp.asarray(lat), jnp.asarray(pos, jnp.bfloat16), jnp.asarray(neg, jnp.bfloat16),
           *jrope)
    tin = (torch.from_numpy(lat), torch.from_numpy(pos).bfloat16(),
           torch.from_numpy(neg).bfloat16(), *trope)
    return jin, tin


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cached_denoiser_matches_jax(model, name, margins):
    """One expert, 6 UniPC steps, CFG 5.0: both streams cached (the negative
    one on negative_stream_config); latents and skip counts against JAX's
    make_wan_cached_denoiser."""
    jcfg, jparams, tcfg, tparams = model
    jc, tc = _configs(name)
    jin, tin = _denoiser_inputs(jcfg, tcfg, 11)
    want, jskips = j_cached(jcfg, JUniPC.create(6, shift=5.0), 6, jc, 5.0)(jparams, *jin, None)
    got, skips = make_wan_cached_denoiser(tcfg, TUniPC.create(6, shift=5.0), 6, tc, 5.0)(
        tparams, *tin)
    assert skips == int(jskips) and skips > 0
    assert got.dtype == torch.float32 and _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("name", ["fbcache", "dicache-delta_y"])
def test_cached_denoiser_with_image_tokens_matches_jax(name, margins):
    """Wan2.1-I2V's image branch under FBCache / DiCache: one expert, 6 UniPC
    steps, CFG 5.0, the same CLIP tokens for both streams (the probe and
    the rest carry them in the context); latents and skip counts against
    JAX's make_wan_cached_denoiser(encoder_image=...)."""
    from test_torch_wan import IMG_DIM, IMG_TOKENS, INNER

    common = dict(TINY, text_len=TEXT, num_layers=3, quant="int8", image_dim=IMG_DIM,
                  added_kv_proj_dim=INNER)
    jcfg, tcfg = jwan.WanConfig(**common), twan.WanConfig(**common)
    jparams = jwan.wan_init_random(jax.random.key(5), jcfg)
    tparams = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
    assert tparams.image_embedder is not None and tparams.blocks[2].attn2.add_k is not None
    jc, tc = _configs(name)
    jin, tin = _denoiser_inputs(jcfg, tcfg, 13)
    img = np.random.default_rng(14).standard_normal((1, IMG_TOKENS, IMG_DIM)).astype(np.float32)
    want, jskips = j_cached(jcfg, JUniPC.create(6, shift=5.0), 6, jc, 5.0)(
        jparams, *jin, None, None, jnp.asarray(img, jnp.bfloat16))
    got, skips = make_wan_cached_denoiser(tcfg, TUniPC.create(6, shift=5.0), 6, tc, 5.0)(
        tparams, *tin, None, None, torch.from_numpy(img).bfloat16())
    assert skips == int(jskips) and skips > 0
    assert got.dtype == torch.float32 and _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("name", ["fbcache", "dicache-delta_y"])
def test_dual_phase_cached_denoiser_matches_jax(name, margins):
    """Two experts, 8 UniPC steps (boundary 0.875), CFG 4.0 / 3.0, the radial
    superblock tables with one dense layer and one dense warmup step; each
    phase starts from fresh (pos, neg) cache states while the steps keep
    their global index (the FBCache warmup compares it)."""
    from test_torch_wan import SPARSE_BLOCKS, SPARSE_FHW, _super_tables

    common = dict(TINY, text_len=TEXT, num_layers=3, quant="int8", dense_layers=1,
                  **SPARSE_BLOCKS)
    jcfg, tcfg = jwan.WanConfig(**common), twan.WanConfig(**common)
    jp1, jp2 = (jwan.wan_init_random(jax.random.key(s), jcfg) for s in (1, 2))
    tp1, tp2 = (wan_params_from_numpy(jax.device_get(p), device="cpu") for p in (jp1, jp2))
    jc, tc = _configs(name, threshold=0.035)
    f, h, w = SPARSE_FHW
    rng = np.random.default_rng(12)
    lat = rng.standard_normal((1, TINY["out_channels"], f, h, w)).astype(np.float32)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    tables = _super_tables(f, h, w)
    n = 8
    jrun = j_dual_phase(jcfg, JUniPC.create(n, shift=5.0), n, jc, 4.0, 3.0, 0.875, 1)
    want, jskips = jrun(jp1, jp2, jnp.asarray(lat), jnp.asarray(pos, jnp.bfloat16),
                        jnp.asarray(neg, jnp.bfloat16), *jwan.wan_rope_cos_sin(jcfg, f, h, w),
                        tuple(jnp.asarray(a) for a in tables))
    trun = make_wan_dual_phase_denoiser(tcfg, TUniPC.create(n, shift=5.0), n, 4.0, 3.0, 0.875,
                                        1, cache_cfg=tc)
    got, skips = trun(tp1, tp2, torch.from_numpy(lat), torch.from_numpy(pos).bfloat16(),
                      torch.from_numpy(neg).bfloat16(),
                      *twan.wan_rope_cos_sin(tcfg, f, h, w, device="cpu"),
                      tuple(torch.from_numpy(a) for a in tables))
    assert trun.phase_steps[0] > 1 and trun.phase_steps[1] > 1
    assert skips == int(jskips) and skips > 0
    assert _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("dual", [True, False])
def test_engine_with_step_caches(tmp_path, dual):
    """The engine with fbcache_wan.json and dicache_wan.json as published (the
    4-step request is all warmup for FBCache: no skip; DiCache's warmup is
    step 0), then with every step skippable (threshold 1e9, no warmup): each
    expert phase computes its first step (its fresh states have no previous
    probe) and skips the next, on both CFG streams -- 4 skips for the dual
    expert's 2 + 2 steps, 6 for one expert's 4 steps."""
    from fastdm_tpu_torch.engine import FastDMEngine

    _write_wan_checkpoint(str(tmp_path), vae=False)
    if not dual:
        shutil.rmtree(tmp_path / "transformer_2")
    rng = np.random.default_rng(7)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=64,
              num_frames=9, num_inference_steps=4, guidance_scale=4.0, seed=3)
    for name in ("fbcache_wan.json", "dicache_wan.json"):
        eng = FastDMEngine(str(tmp_path), architecture="wan2.2-t2v",
                           cache_config=os.path.join(CONFIGS, name), verbose=False,
                           device="cpu")
        assert (eng.params_2 is not None) == dual
        out = eng.generate(**kw)
        assert out.shape == (1, TINY["out_channels"], 3, 8, 8) and np.isfinite(out).all()
        if name.startswith("fbcache"):
            assert eng.last_cache_skips == 0
        every = dict(json.load(open(os.path.join(CONFIGS, name))), threshold=1e9,
                     warmup_steps=0, ret_ratio=0.0)
        eng = FastDMEngine(str(tmp_path), architecture="wan", cache_config=every,
                           verbose=False, device="cpu")
        eng.generate(**kw)
        assert eng.last_cache_skips == (4 if dual else 6)
