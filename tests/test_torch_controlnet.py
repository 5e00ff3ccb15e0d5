"""The port's ControlNet and IP-Adapter conditioning against the JAX package:
the SDXL ControlNet's embedding variants (fastdm_tpu_torch/layers/
embeddings.py), the hint encoder and the SDXL and FLUX ControlNets
(fastdm_tpu_torch/models/controlnets.py) with their loaders and converters,
the FLUX blocks' residual injection, expand_cn_samples and both ControlNet
denoise loops, the IP-Adapter projections (layers/ip_adapter.py) and
sdxl_attach_ip_adapter, and the engine's controlnet_path / ip_adapter_path,
on tiny configs. JAX params come from JAX's loaders on synthetic diffusers
state dicts; JAX's forwards are jitted, and each JAX loop is compiled once
and shared by the loop test and the engine test that run it (the same
config, steps and shapes), so that the file stays near its time budget.

Tolerances:
- The raw hint's packed tokens, the union ControlNet's cos / sin tables,
  expand_cn_samples' indices and every loader's weights: bit-exact.
- The embedding variants (text_image_proj, attention pooling, text,
  text_image) and the IP-Adapter projections: relative L2 <= 1e-2 (bf16
  rounds at the same points; XLA's bf16 GELU / einsum sums one ulp apart).
- The hint encoder within 1e-3 of JAX with the reference's SiLU computed in
  f32 and rounded once (tests/test_torch_sdxl.py correctly_rounded_silu).
- The SDXL ControlNet: each of its 10 residuals within relative L2 5e-2, the
  SDXL forward's tolerance (one-ulp attention differences grown through the
  GroupNorm resnets), in bf16 and int8, under guess mode and with
  global_pool_conditions; the other variants at the emb / ctx they give,
  within 1e-2.
- The FLUX ControlNet's residuals and the FLUX forward with residuals
  (cached too): relative L2 <= 1e-2, the port's bf16 FLUX tolerance.
- The denoisers' f32 latents within relative L2 5e-2 (SDXL's) and 2e-2
  (FLUX's) of JAX, and so the engine's: its generate on the engine's seeded
  noise against JAX's loop on JAX's loads of the same checkpoints, fed the
  hint (or the IP-Adapter tokens) the JAX engine's own preprocessing gives.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.caching import config as jcc
from fastdm_tpu.layers import embeddings as jemb
from fastdm_tpu.layers import ip_adapter as jip
from fastdm_tpu.models import controlnets as jcn
from fastdm_tpu.models import flux as jflux
from fastdm_tpu.models import sdxl as jsdxl
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline import denoise as jden
from fastdm_tpu.pipeline import denoise_more as jdm
from fastdm_tpu.pipeline import schedulers as jsch
from fastdm_tpu.pipeline import vae as jvae
from fastdm_tpu_torch import engine as teng
from fastdm_tpu_torch.caching import config as tcc
from fastdm_tpu_torch.caching.xcaching import cache_init_state as t_cache_init_state
from fastdm_tpu_torch.layers import embeddings as temb
from fastdm_tpu_torch.layers.qlinear import quantize_weight
from fastdm_tpu_torch.models import controlnets as tcn
from fastdm_tpu_torch.models import flux as tflux
from fastdm_tpu_torch.models import sdxl as tsdxl
from fastdm_tpu_torch.models.convert import (
    flux_controlnet_params_from_numpy,
    flux_params_from_numpy,
    ip_adapter_proj_from_numpy,
    sdxl_controlnet_params_from_numpy,
    sdxl_params_from_numpy,
)
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline import denoise as tden
from fastdm_tpu_torch.pipeline import denoise_sdxl as tdx
from fastdm_tpu_torch.pipeline import schedulers as tsch
from fastdm_tpu_torch.pipeline import vae as tvae

sys.path.insert(0, os.path.dirname(__file__))
from test_engine_e2e import TINY as FLUX_TINY  # noqa: E402
from test_engine_e2e import _flux_cn_sd, _flux_transformer_sd, _sdxl_sd, _vae_sd, \
    _write_st  # noqa: E402
from test_torch_sdxl import TINY, VAE_TINY  # noqa: E402
from test_torch_sdxl import _embeds as sdxl_embeds  # noqa: E402
from test_torch_sdxl import correctly_rounded_silu, sdxl_engine_root  # noqa: E402,F401
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

# the SDXL UNet and ControlNet here: TINY with one transformer layer in the
# level-2 and mid Transformer2Ds (TINY has two), fewer ops for XLA to compile
CN_TINY = dict(TINY, attn_layers=(0, 1, 1))
H = W = 8           # SDXL latents (a 64x64 hint), as the engine tests' 64x64 requests
CTX = 6             # SDXL text tokens
HT, WT, TXT = 4, 4, 6   # FLUX latent tokens and text tokens
FLUX_TOL = 1e-2
SDXL_TOL = 5e-2
STEPS = 2           # every loop and engine request


def _unet_sd(rng, cn: bool = False) -> dict:
    """A synthetic diffusers SDXL UNet (or ControlNet) state dict at CN_TINY."""
    return _sdxl_sd(rng, n1=CN_TINY["attn_layers"][1], n2=CN_TINY["attn_layers"][2], cn=cn)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair(a, dtype="bf16"):
    """One numpy draw on both sides: (jax array, torch tensor), the torch
    one from the JAX one's rounded values."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _nchw(a) -> np.ndarray:
    return np.transpose(_np(a), (0, 3, 1, 2))


def _same_state(got: torch.nn.Module, want: torch.nn.Module) -> None:
    """Two modules hold the same tensors under the same names, bit for bit."""
    g, w = got.state_dict(), want.state_dict()
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


# ------------------------------------------------------ embedding variants


def _lin(rng, name, k, n, sd, bias=True, std=0.2):
    sd[f"{name}.weight"] = (rng.standard_normal((n, k)) * std).astype(np.float32)
    if bias:
        sd[f"{name}.bias"] = (rng.standard_normal(n) * 0.1).astype(np.float32)


def _ln(rng, name, c, sd):
    sd[f"{name}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)


def _variant_sd(rng, kind: str) -> dict:
    """The keys of one addition / class / encoder-projection variant of an
    SDXL ControlNet at TINY (time embed 16, context 16)."""
    sd, te, ctx = {}, TINY["time_embed_dim"], TINY["cross_attention_dim"]
    if kind == "text":
        _ln(rng, "add_embedding.norm1", ctx, sd)
        sd["add_embedding.pool.positional_embedding"] = rng.standard_normal(
            (1, ctx)).astype(np.float32) * 0.25
        for n in ("q_proj", "k_proj", "v_proj"):
            _lin(rng, f"add_embedding.pool.{n}", ctx, ctx, sd)
        _lin(rng, "add_embedding.proj", ctx, te, sd)
        _ln(rng, "add_embedding.norm2", te, sd)
    elif kind == "text_image":
        _lin(rng, "add_embedding.text_proj", ctx, te, sd)
        _ln(rng, "add_embedding.text_norm", te, sd)
        _lin(rng, "add_embedding.image_proj", 12, te, sd)
    elif kind == "text_image_proj":
        _lin(rng, "encoder_hid_proj.image_embeds", 12, 10 * ctx, sd)
        _lin(rng, "encoder_hid_proj.text_proj", ctx, ctx, sd)
    elif kind == "text_proj":
        _lin(rng, "encoder_hid_proj", ctx, ctx, sd)
    elif kind == "class_table":
        sd["class_embedding.weight"] = rng.standard_normal((5, te)).astype(np.float32)
    elif kind == "class_mlp":
        _lin(rng, "class_embedding.linear_1", TINY["block_channels"][0], te, sd)
        _lin(rng, "class_embedding.linear_2", te, te, sd)
    return sd


def test_embedding_variants_match_jax():
    """TextImageProjection, AttentionPooling, TextTimeEmbedding and
    TextImageTimeEmbedding on the same loaded weights and inputs as
    text_image_projection_apply, attention_pooling_apply,
    text_time_embedding_apply and text_image_time_embedding_apply."""
    rng = np.random.default_rng(0)
    sd = {**_variant_sd(rng, "text"), **_variant_sd(rng, "text_image"),
          **_variant_sd(rng, "text_image_proj")}
    jsrc, tsrc = JSource(dict(sd)), TSource(dict(sd), device="cpu")
    jp = {k: f(jsrc) for k, f in (("add", jcn._cn_add_embedding_p),
                                   ("ehp", jcn._cn_encoder_hid_p))}
    tp = {k: f(tsrc) for k, f in (("add", tcn._cn_add_embedding),
                                   ("ehp", tcn._cn_encoder_hid))}
    # "text" wins the add_embedding slot; load the text_image pair on its own
    jti = jcn._cn_add_embedding_p(JSource({k: v for k, v in sd.items()
                                           if k.startswith("add_embedding.text_")
                                           or k.startswith("add_embedding.image_")}))
    tti = tcn._cn_add_embedding(TSource({k: v for k, v in sd.items()
                                         if k.startswith("add_embedding.text_")
                                         or k.startswith("add_embedding.image_")}, device="cpu"))
    assert isinstance(tp["add"], temb.TextTimeEmbedding)
    assert isinstance(tti, temb.TextImageTimeEmbedding)
    assert isinstance(tp["ehp"], temb.TextImageProjection)
    jx, tx = _pair(rng.standard_normal((2, 7, 16)))
    ji, ti = _pair(rng.standard_normal((2, 12)))
    wants = jax.jit(lambda p, ti_p, x, i: (
        jemb.text_image_projection_apply(p["ehp"], x, i),
        jemb.attention_pooling_apply(p["add"]["pool"], x, 4),
        jemb.text_time_embedding_apply(p["add"], x, 4),
        jemb.text_image_time_embedding_apply(ti_p, x[:, 0], i)))(jp, jti, jx, ji)
    with torch.inference_mode():
        gots = (tp["ehp"](tx, ti), tp["add"].pool(tx, 4), tp["add"](tx, 4), tti(tx[:, 0], ti))
    cases = list(zip(gots, wants))
    for i, (got, want) in enumerate(cases):
        assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16, i
        assert _rel_l2(got, want) <= 1e-2, i
    assert tuple(cases[0][0].shape) == (2, 10 + 7, 16)


# ----------------------------------------------------------- SDXL ControlNet


def _cn_inputs(seed: int, b: int = 2):
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for k, shape, dt in (("sample", (b, 4, H, W), "f32"), ("ctx", (b, CTX, 16), "bf16"),
                         ("pooled", (b, 8), "bf16")):
        j[k], t[k] = _pair(rng.standard_normal(shape), dt)
    hint = rng.random((b, 8 * H, 8 * W, 3)).astype(np.float32)
    j["hint"], t["hint"] = jnp.asarray(hint), torch.from_numpy(hint).permute(0, 3, 1, 2)
    tt = np.asarray([901.0, 741.0][:b], np.float32)
    ids = np.tile(np.asarray([8 * H, 8 * W, 0, 0, 8 * H, 8 * W], np.float32), (b, 1))
    j.update(t=jnp.asarray(tt), ids=jnp.asarray(ids))
    t.update(t=torch.from_numpy(tt), ids=torch.from_numpy(ids))
    return j, t


@functools.lru_cache(maxsize=None)
def _sdxl_cn(quant):
    """The tiny SDXL ControlNet ("text_time") in `quant` through both
    loaders; the forward tests run the JAX-loaded params converted."""
    sd = _unet_sd(np.random.default_rng(1), cn=True)
    jcfg = jsdxl.SDXLConfig(quant=quant, **CN_TINY)
    tcfg = tsdxl.SDXLConfig(quant=quant, **CN_TINY)
    jparams = jcn.sdxl_controlnet_load(JSource(dict(sd)), jcfg)
    loaded = tcn.sdxl_controlnet_load(TSource(dict(sd), device="cpu"), tcfg)
    tparams = sdxl_controlnet_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams, loaded, sd


@pytest.fixture(params=[None, "int8"])
def sdxl_cn_formats(request):
    return _sdxl_cn(request.param)


@pytest.fixture
def sdxl_cn():
    return _sdxl_cn(None)


def test_sdxl_controlnet_load_matches_converted_jax_load(sdxl_cn_formats):
    _, jparams, tcfg, tparams, loaded, sd = sdxl_cn_formats
    _same_state(loaded, tparams)
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    assert isinstance(tparams.add_embedding, temb.TimestepEmbedding)
    with pytest.raises(ValueError, match="never consumed"):
        tcn.sdxl_controlnet_load(TSource(dict(sd, extra=np.zeros(3, np.float32)),
                                         device="cpu"), tcfg)


def test_cond_embedding_matches_jax(sdxl_cn, correctly_rounded_silu):
    """The hint encoder: SiLU after each conv, stride 2 on the odd blocks
    with JAX's SAME padding."""
    _, jparams, _, tparams, _, _ = sdxl_cn
    hint = np.random.default_rng(3).random((2, 64, 48, 3)).astype(np.float32)
    want = jax.jit(jcn.controlnet_cond_embedding_apply)(jparams["cond_embedding"],
                                                         jnp.asarray(hint))
    with torch.inference_mode():
        got = tparams.cond_embedding(torch.from_numpy(hint).permute(0, 3, 1, 2))
    assert got.shape == (2, TINY["block_channels"][0], 8, 6) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _nchw(want), rtol=0, atol=1e-3)


def _mode_kw(mode: str) -> dict:
    return dict(conditioning_scale=0.7, guess_mode=mode == "guess",
                global_pool_conditions=mode == "pool")


@functools.lru_cache(maxsize=None)
def _jax_cn_outputs(quant):
    """JAX's residuals in each mode (bf16: plain, guess, pool; int8: plain)
    from one jitted function, which traces the trunk once."""
    jcfg, jparams, _, _, _, _ = _sdxl_cn(quant)
    modes = ("plain", "guess", "pool") if quant is None else ("plain",)
    j, _ = _cn_inputs(4)

    def all_modes(p, a):
        return {m: jcn.sdxl_controlnet_forward(p, jcfg, *a, **_mode_kw(m)) for m in modes}

    return jax.jit(all_modes)(jparams, (j["sample"], j["t"], j["ctx"], j["pooled"], j["ids"],
                                        j["hint"]))


@pytest.mark.parametrize("quant, mode", [(None, "plain"), (None, "guess"), (None, "pool"),
                                         ("int8", "plain")])
def test_sdxl_controlnet_forward_matches_jax(quant, mode):
    """The 9 down and the mid residual, NCHW, at conditioning scale 0.7, in
    bf16 and int8; guess mode's logspace scales come out f32 as JAX's;
    global pooling leaves one value per channel."""
    jcfg, jparams, tcfg, tparams, _, _ = _sdxl_cn(quant)
    _, t = _cn_inputs(4)
    kw = _mode_kw(mode)
    jdown, jmid = _jax_cn_outputs(quant)[mode]
    with torch.inference_mode():
        down, mid = tcn.sdxl_controlnet_forward(tparams, tcfg, t["sample"], t["t"], t["ctx"],
                                                t["pooled"], t["ids"], t["hint"], **kw)
    assert len(down) == 9
    chans = tcn.sdxl_controlnet_skip_channels(tcfg)
    for i, (got, want) in enumerate(zip([*down, mid], [*jdown, jmid])):
        want = _nchw(want)
        assert got.shape == want.shape, i
        assert got.shape[1] == (chans + (TINY["block_channels"][2],))[i]
        assert got.dtype == (torch.float32 if mode == "guess" else torch.bfloat16)
        assert _rel_l2(got, want) <= SDXL_TOL, (i, _rel_l2(got, want))
        if mode == "pool":
            assert got.shape[2:] == (1, 1)


@pytest.mark.parametrize("kind", ["text", "text_image", "text_image_proj", "text_proj",
                                  "class_table", "class_mlp"])
def test_sdxl_controlnet_variants_give_jax_emb_and_ctx(sdxl_cn, kind):
    """Each variant the loader reads off the checkpoint's keys, held at the
    (emb, ctx) it gives against the JAX functions on the JAX-loaded params
    (the JAX forward's dispatch, sdxl_controlnet_forward:80-143)."""
    jcfg, _, tcfg, _, _, base = sdxl_cn
    # the attention pooling's heads must divide TINY's 16-wide context
    jcfg = dataclasses.replace(jcfg, addition_embed_num_heads=4)
    tcfg = dataclasses.replace(tcfg, addition_embed_num_heads=4)
    rng = np.random.default_rng(5)
    sd = dict(base)
    if kind in ("text", "text_image"):
        sd = {k: v for k, v in sd.items() if not k.startswith("add_embedding.")}
    sd.update(_variant_sd(rng, kind))
    jp = jcn.sdxl_controlnet_load(JSource(dict(sd)), jcfg)
    tp = tcn.sdxl_controlnet_load(TSource(dict(sd), device="cpu"), tcfg)
    j, t = _cn_inputs(6)
    if kind == "text_image":
        # the reference passes encoder_hidden_states as the text embedding
        # and adds the (B, D) image projection: only a pooled (B, D) text
        # input broadcasts (ROADMAP.md section 3)
        j["ctx"], t["ctx"] = j["ctx"][:, 0], t["ctx"][:, 0]
    ji, ti = _pair(rng.standard_normal((2, 12)))
    labels = np.asarray([3, 1])
    sinus = kind == "class_mlp"
    with torch.inference_mode():
        emb, ctx = tcn._sdxl_cn_embeddings(tp, tcfg, t["t"], t["ctx"], t["pooled"], t["ids"],
                                           torch.from_numpy(labels), sinus, ti)

    def jax_emb_ctx():  # the JAX side in one jitted function
        dt = jnp.bfloat16
        temb_ = jemb.get_timestep_embedding(j["t"], 8, flip_sin_to_cos=True,
                                            downscale_freq_shift=0.0)
        jemb_ = jemb.timestep_embedding_apply(jp["time_embedding"], temb_.astype(dt))
        if kind == "class_table":
            jemb_ = jemb_ + jp["class_embedding"]["weight"][labels].astype(jemb_.dtype)
        elif kind == "class_mlp":
            lab = jemb.get_timestep_embedding(jnp.asarray(labels), 8, flip_sin_to_cos=True,
                                              downscale_freq_shift=0.0)
            jemb_ = jemb_ + jemb.timestep_embedding_apply(jp["class_embedding"], lab.astype(dt))
        ae = jp["add_embedding"]
        if kind == "text":
            jemb_ = jemb_ + jemb.text_time_embedding_apply(ae, j["ctx"],
                                                           jcfg.addition_embed_num_heads)
        elif kind == "text_image":
            jemb_ = jemb_ + jemb.text_image_time_embedding_apply(ae, j["ctx"], ji)
        else:
            te = jemb.get_timestep_embedding(j["ids"].reshape(-1), 4, flip_sin_to_cos=True,
                                             downscale_freq_shift=0.0).reshape(2, -1)
            add = jnp.concatenate([j["pooled"].astype(jnp.float32), te], axis=-1)
            jemb_ = jemb_ + jemb.timestep_embedding_apply(ae, add.astype(dt))
        jctx = j["ctx"]
        if kind == "text_image_proj":
            jctx = jemb.text_image_projection_apply(jp["encoder_hid_proj"], jctx, ji)
        elif kind == "text_proj":
            from fastdm_tpu.layers.qlinear import qlinear_apply

            jctx = qlinear_apply(jp["encoder_hid_proj"], jctx)
        return jemb_, jctx

    jemb_, jctx = jax.jit(jax_emb_ctx)()
    assert _rel_l2(emb, jemb_) <= 1e-2 and _rel_l2(ctx, jctx) <= 1e-2
    assert tuple(ctx.shape) == jctx.shape
    if kind.startswith("class"):
        with pytest.raises(ValueError, match="class_labels"):
            tcn._sdxl_cn_embeddings(tp, tcfg, t["t"], t["ctx"], t["pooled"], t["ids"], None,
                                    sinus, ti)


def test_sdxl_controlnet_init_random_is_seeded_in_the_loaded_layout():
    cfg = tsdxl.SDXLConfig(quant="int8", **TINY)
    a = tcn.sdxl_controlnet_init_random(3, cfg, cond_channels=(4, 4, 8, 16), device="cpu")
    b = tcn.sdxl_controlnet_init_random(3, cfg, cond_channels=(4, 4, 8, 16), device="cpu")
    _same_state(a, b)
    sd = _sdxl_sd(np.random.default_rng(0), cn=True)
    # _sdxl_sd's hint encoder widens on other blocks than diffusers': compare
    # the trunk and the zero convs
    loaded = tcn.sdxl_controlnet_load(TSource(sd, device="cpu"), cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in loaded.state_dict().items()
              if not k.startswith("cond_embedding")}
    assert shapes == {k: (v.shape, v.dtype) for k, v in a.state_dict().items()
                      if not k.startswith("cond_embedding")}
    assert [blk["w"].shape[:2] for blk in a.cond_embedding.blocks] == \
        [(4, 4), (4, 4), (4, 4), (8, 4), (8, 8), (16, 8)]


# ------------------------------------------------------------ FLUX ControlNet


def _flux_cn_cfg(**kw):
    d = dict(FLUX_TINY, num_layers=1, num_single_layers=1, **kw)
    return jcn.FluxControlNetConfig(quant=None, **d), tcn.FluxControlNetConfig(quant=None, **d)


def _raw_hint_sd(rng, sd):
    """A diffusers ControlNetConditioningEmbedding input_hint_block: the
    3-channel image to 4 channels at 1/8 (2x2-packed: in_channels 16)."""
    chans = (4, 4, 8, 8, 8, 8)
    sd["input_hint_block.conv_in.weight"] = rng.standard_normal((4, 3, 3, 3)).astype(
        np.float32) * 0.2
    sd["input_hint_block.conv_in.bias"] = np.zeros(4, np.float32)
    prev = 4
    for i, c in enumerate(chans):
        sd[f"input_hint_block.blocks.{i}.weight"] = rng.standard_normal(
            (c, prev, 3, 3)).astype(np.float32) * 0.2
        sd[f"input_hint_block.blocks.{i}.bias"] = np.zeros(c, np.float32)
        prev = c
    sd["input_hint_block.conv_out.weight"] = rng.standard_normal((4, prev, 3, 3)).astype(
        np.float32) * 0.2
    sd["input_hint_block.conv_out.bias"] = np.zeros(4, np.float32)
    return sd


@pytest.fixture(scope="module")
def flux_cns():
    """Three tiny FLUX ControlNets (1 dual + 1 single block) through both
    loaders: a union one (latent hint, 10 modes, guidance-distilled), a
    raw-hint one and one without a guidance embedder."""
    out = {}
    for name, seed in (("union", 1), ("raw", 2), ("plain", 3)):
        rng = np.random.default_rng(seed)
        sd = _flux_cn_sd(rng, FLUX_TINY, union=name == "union")
        if name == "raw":
            _raw_hint_sd(rng, sd)
        if name == "plain":
            sd = {k: v for k, v in sd.items() if "guidance_embedder" not in k}
        jcfg, tcfg = _flux_cn_cfg(guidance_embeds=name != "plain")
        jp = jcn.flux_controlnet_load(JSource(dict(sd)), jcfg)
        loaded = tcn.flux_controlnet_load(TSource(dict(sd), device="cpu"), tcfg)
        tp = flux_controlnet_params_from_numpy(jax.device_get(jp), device="cpu")
        out[name] = (jcfg, jp, tcfg, tp, loaded, sd)
    return out


def test_flux_controlnet_load_matches_converted_jax_load(flux_cns):
    for name, (jcfg, jp, tcfg, tp, loaded, sd) in flux_cns.items():
        _same_state(loaded, tp)
        assert sum(p.numel() for p in tp.parameters()) == sum(
            x.size for x in jax.tree.leaves(jp)), name
        assert (tp.controlnet_mode_embedder is not None) == (name == "union")
        assert (tp.input_hint_block is not None) == (name == "raw")
        assert (tp.time_text_embed.guidance_embedder is not None) == (name != "plain")
    _, _, tcfg, _, _, sd = flux_cns["union"]
    with pytest.raises(ValueError, match="never consumed"):
        tcn.flux_controlnet_load(TSource(dict(sd, stray=np.zeros(2, np.float32)), device="cpu"),
                                 tcfg)
    flat = dict(sd, **{"input_hint_block.0.weight": np.zeros((4, 3, 3, 3), np.float32)})
    with pytest.raises(NotImplementedError, match="flat Sequential"):
        tcn.flux_controlnet_load(TSource(flat, device="cpu"), tcfg)


def _flux_inputs(seed: int, raw: bool = False):
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for k, shape in (("hidden", (1, HT * WT, 16)), ("encoder", (1, TXT, 64)),
                     ("pooled", (1, 48)), ("cond", (1, HT * WT, 16))):
        j[k], t[k] = _pair(rng.standard_normal(shape))
    if raw:  # the conditioning image in [-1, 1], 16 pixels a token
        j["cond"], t["cond"] = _pair(rng.random((1, 16 * HT, 16 * WT, 3)) * 2 - 1)
        t["cond"] = t["cond"].permute(0, 3, 1, 2)
    return j, t


def _jax_flux_cn(jp, jcfg, j, cos, sin, **kw):
    return jax.jit(lambda p, a, c, s: jcn.flux_controlnet_forward(p, jcfg, *a, c, s, **kw))(
        jp, (j["hidden"], j["cond"], j["encoder"], j["pooled"], jnp.asarray([0.7])), cos, sin)


@pytest.mark.parametrize("name", ["union", "raw", "plain"])
def test_flux_controlnet_forward_matches_jax(flux_cns, name):
    """union: the mode token first in the text stream (cos / sin cover
    TXT + 1 + S); raw: the hint image through input_hint_block and the 2x2
    unshuffle, its tokens bit-exact with JAX's NHWC packing; plain: no
    guidance embedder, whatever the config says."""
    jcfg, jp, tcfg, tp, _, _ = flux_cns[name]
    j, t = _flux_inputs(7, raw=name == "raw")
    txt = TXT + (name == "union")
    jcos, jsin = jflux.flux_rope_cache(jcfg, txt, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, txt, HT, WT, device="cpu")
    kw = dict(guidance=jnp.asarray([3.5]) if name != "plain" else None,
              conditioning_scale=0.8, control_mode=2 if name == "union" else None)
    jbs, jsbs = _jax_flux_cn(jp, jcfg, j, jcos, jsin, **kw)
    kw["guidance"] = torch.tensor([3.5]) if name != "plain" else None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.inference_mode():
        bs, sbs = tcn.flux_controlnet_forward(tp, tcfg, t["hidden"], t["cond"], t["encoder"],
                                              t["pooled"], torch.tensor([0.7]), tcos, tsin, **kw)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32  # the zero heads restore it
    for got, want in ((bs, jbs), (sbs, jsbs)):
        assert tuple(got.shape) == want.shape == (1, 1, HT * WT, 128)
        assert got.dtype == torch.bfloat16 and _rel_l2(got, want) <= FLUX_TOL
    if name == "raw":
        with torch.inference_mode():
            hint = tp.input_hint_block(t["cond"])
        b, c, hp, wp = hint.shape
        nhwc = np.transpose(_np(hint), (0, 2, 3, 1))
        want = nhwc.reshape(b, hp // 2, 2, wp // 2, 2, c).transpose(0, 1, 3, 5, 2, 4)
        np.testing.assert_array_equal(_np(tden.flux_pack_latents(hint)),
                                      want.reshape(b, -1, c * 4))
    if name == "union":
        with pytest.raises(ValueError, match="guidance-distilled"):
            tcn.flux_controlnet_forward(tp, tcfg, t["hidden"], t["cond"], t["encoder"],
                                        t["pooled"], torch.tensor([0.7]), tcos, tsin)


def test_expand_cn_samples_indices_match_jax():
    for l_cn, n in ((5, 19), (10, 38), (3, 7)):
        s = np.arange(l_cn, dtype=np.float32)[:, None, None, None] * np.ones((1, 1, 2, 1),
                                                                              np.float32)
        want = np.asarray(jden.expand_cn_samples(jnp.asarray(s), n))
        got = tden.expand_cn_samples(torch.from_numpy(s), n)
        np.testing.assert_array_equal(_np(got), want)
    assert tden.expand_cn_samples(None, 19) is None
    assert tden.expand_cn_samples(torch.zeros(5, 1, 2, 3), 0) is None


@pytest.fixture(scope="module")
def flux_base():
    sd = _flux_transformer_sd(np.random.default_rng(8))
    jcfg = jflux.FluxConfig(quant=None, **FLUX_TINY)
    tcfg = tflux.FluxConfig(quant=None, **FLUX_TINY)
    jp = jflux.flux_load(JSource(dict(sd)), jcfg)
    return jcfg, jp, tcfg, flux_params_from_numpy(jax.device_get(jp), device="cpu")


def test_flux_forward_with_residuals_matches_jax(flux_base):
    """flux_forward and, under FBCache (its probe, dual block 0, adds the
    first residual), flux_forward_cached with stacked residuals on both
    stacks, held to JAX's cached forward: a first step computes every block,
    and the port's cached first step equals its uncached forward bit for
    bit."""
    jcfg, jp, tcfg, tp = flux_base
    rng = np.random.default_rng(9)
    j, t = _flux_inputs(10)
    jcs, tcs = _pair(rng.standard_normal((2, 1, HT * WT, 128)) * 0.5)
    jss, tss = _pair(rng.standard_normal((2, 1, HT * WT, 128)) * 0.5)
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    targs = (t["hidden"], t["encoder"], t["pooled"], torch.tensor([0.6]), tcos, tsin)
    from fastdm_tpu.caching.xcaching import cache_init_state

    jfb = jcc.FBCacheConfig(enable_caching=True, threshold=0.1)
    tfb = tcc.FBCacheConfig(enable_caching=True, threshold=0.1)
    shape = (1, HT * WT, tcfg.inner_dim)
    want, jstate = jax.jit(lambda p, st, a, cs, ss: jflux.flux_forward_cached(
        p, jcfg, jfb, st, jnp.int32(0), 4, *a, guidance=jnp.asarray([3.5]),
        controlnet_block_samples=cs, controlnet_single_block_samples=ss))(
        jp, cache_init_state(jfb, shape, shape),
        (j["hidden"], j["encoder"], j["pooled"], jnp.asarray([0.6]), jcos, jsin), jcs, jss)
    with torch.inference_mode():
        kw = dict(guidance=torch.tensor([3.5]), controlnet_block_samples=tcs,
                  controlnet_single_block_samples=tss)
        got = tflux.flux_forward(tp, tcfg, *targs, **kw)
        without = tflux.flux_forward(tp, tcfg, *targs, guidance=torch.tensor([3.5]))
        got_c, state = tflux.flux_forward_cached(
            tp, tcfg, tfb, t_cache_init_state(tfb, shape, shape, device="cpu"), 0, 4, *targs,
            **kw)
    assert int(jstate["skips"]) == state["skips"] == 0
    assert _rel_l2(got, want) <= FLUX_TOL and torch.equal(got_c, got)
    assert _rel_l2(without, want) > 10 * FLUX_TOL  # the residuals do enter
    # a one-layer stack spread over both blocks of each kind in place equals
    # the stack expand_cn_samples (JAX's index form) makes, bit for bit
    with torch.inference_mode():
        short = tflux.flux_forward(tp, tcfg, *targs, guidance=torch.tensor([3.5]),
                                   controlnet_block_samples=tcs[:1],
                                   controlnet_single_block_samples=tss[1:])
        full = tflux.flux_forward(
            tp, tcfg, *targs, guidance=torch.tensor([3.5]),
            controlnet_block_samples=tden.expand_cn_samples(tcs[:1], tcfg.num_layers),
            controlnet_single_block_samples=tden.expand_cn_samples(tss[1:],
                                                                   tcfg.num_single_layers))
    assert torch.equal(short, full) and not torch.equal(short, got)


def _flux_sched(mod):
    return mod.FlowMatchEulerScheduler.create(
        STEPS, use_dynamic_shifting=True, mu=mod.flow_match_shift_mu(HT * WT))


@functools.lru_cache(maxsize=None)
def _jax_flux_cn_loop(mode):
    """JAX's FLUX ControlNet loop on FLUX_TINY with a guidance-distilled
    1 + 1-block ControlNet: STEPS steps, guidance 3.5, scale 0.9, at
    control_mode `mode`; one compile for the loop and the engine tests."""
    return jden.make_flux_cn_denoiser(jflux.FluxConfig(quant=None, **FLUX_TINY),
                                      _flux_cn_cfg(guidance_embeds=True)[0],
                                      _flux_sched(jsch), STEPS, 3.5, 0.9, mode)


def test_make_flux_cn_denoiser_matches_jax(flux_base, flux_cns, monkeypatch):
    """Two steps with the union ControlNet at control_mode 4 (its cos / sin
    rows, row 0 duplicated in front, bit-exact with JAX's and with the
    rope tables of TXT + 1 text ids) and with the raw-hint one."""
    jcfg, jp, tcfg, tp = flux_base
    seen = []
    forward = tcn.flux_controlnet_forward

    def spy(*a, **k):
        seen.append((a[7], a[8]))
        return forward(*a, **k)

    monkeypatch.setattr(tcn, "flux_controlnet_forward", spy)
    tsc = _flux_sched(tsch)
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    tcos, tsin = tflux.flux_rope_cache(tcfg, TXT, HT, WT, device="cpu")
    lat = np.random.default_rng(11).standard_normal((1, HT * WT, 16)).astype(np.float32)
    for name, mode in (("union", 4), ("raw", None)):
        jccfg, jcp, tccfg, tcp, _, _ = flux_cns[name]
        j, t = _flux_inputs(12, raw=name == "raw")
        want, _ = _jax_flux_cn_loop(mode)(jp, jcp, jnp.asarray(lat), j["cond"], j["encoder"],
                                          j["pooled"], jcos, jsin)
        got, skips = tden.make_flux_cn_denoiser(tcfg, tccfg, tsc, STEPS, 3.5, 0.9, mode)(
            tp, tcp, torch.from_numpy(lat), t["cond"], t["encoder"], t["pooled"], tcos, tsin)
        assert skips == 0 and got.dtype == torch.float32
        assert _rel_l2(got, want) <= 2e-2, (name, _rel_l2(got, want))
    ucos, usin = seen[0]
    np.testing.assert_array_equal(_np(ucos), _np(jnp.concatenate([jcos[:1], jcos])))
    wcos, wsin = tflux.flux_rope_cache(tcfg, TXT + 1, HT, WT, device="cpu")
    assert torch.equal(ucos, wcos) and torch.equal(usin, wsin)
    assert seen[-1][0] is tcos  # no mode token: the base tables
    with pytest.raises(ValueError, match="union"):
        tden.make_flux_cn_denoiser(tcfg, flux_cns["raw"][2], tsc, STEPS, 3.5, 1.0, 1)(
            tp, flux_cns["raw"][3], torch.from_numpy(lat), t["cond"], t["encoder"],
            t["pooled"], tcos, tsin)


# ------------------------------------------------------------- SDXL loops


@pytest.fixture(scope="module")
def sdxl_unet():
    sd = _unet_sd(np.random.default_rng(13))
    jcfg = jsdxl.SDXLConfig(quant=None, **CN_TINY)
    jp = jsdxl.sdxl_load(JSource(dict(sd)), jcfg)
    return jcfg, jp, sdxl_params_from_numpy(jax.device_get(jp), device="cpu"), sd


@functools.lru_cache(maxsize=None)
def _jax_sdxl_cn_loop(guess: bool):
    """JAX's SDXL ControlNet loop at CN_TINY: STEPS CFG steps, guidance 5.0,
    scale 0.8; one compile for the loop and the engine tests."""
    sched = jsch.EulerDiscreteScheduler.create(STEPS)
    return jdm.make_sdxl_cn_denoiser(jsdxl.SDXLConfig(quant=None, **CN_TINY), sched, STEPS,
                                     5.0, 0.8, guess), sched


@pytest.mark.parametrize("guess", [False, True])
def test_make_sdxl_cn_denoiser_matches_jax(sdxl_unet, sdxl_cn, guess):
    """Two CFG steps (guidance 5.0, scale 0.8): the ControlNet on the 2B
    batch, or under guess mode on the positive half with zero residuals for
    the negative one."""
    jcfg, jp, tp, _ = sdxl_unet
    _, jcp, _, tcp, _, _ = sdxl_cn
    run, jsc = _jax_sdxl_cn_loop(guess)
    tsc = tsch.EulerDiscreteScheduler.create(STEPS)
    j, t = _cn_inputs(14)
    lat = np.random.default_rng(15).standard_normal((1, 4, H, W)).astype(np.float32)
    lat *= jsc.init_noise_sigma
    want, _ = run(jp, jcp, jnp.asarray(lat), j["ctx"], j["pooled"], j["ids"], j["hint"][:1])
    got, skips = tdx.make_sdxl_cn_denoiser(tsdxl.SDXLConfig(quant=None, **CN_TINY), tsc, STEPS,
                                           5.0, 0.8, guess)(
        tp, tcp, torch.from_numpy(lat), t["ctx"], t["pooled"], t["ids"], t["hint"][:1])
    assert skips == 0 and tuple(got.shape) == (1, 4, H, W)
    assert _rel_l2(got, want) <= SDXL_TOL, _rel_l2(got, want)


def test_batch_one_tokens_reach_the_quantizer_row_contiguous(monkeypatch):
    """An SDXL Transformer2D at batch 1 (the guess-mode ControlNet, SDXL
    without CFG): its proj_in input is the (1, H*W, C) token view of an NCHW
    map, whose (H*W, C) rows reshape into a strided view; qlinear_apply
    hands the quantizer (whose kernel reads a contiguous last dim) a
    contiguous copy, and the result is the batch-2 forward's first half."""
    from fastdm_tpu_torch.layers import qlinear as tql

    cfg = tsdxl.SDXLConfig(quant="int8", **TINY)
    t2d = tsdxl.sdxl_init_random(0, cfg, device="cpu").down[1].attns[0]
    quantize, seen = tql.quantize_to_int8, []

    def strict(x, *a, **k):
        seen.append(x.stride(-1))
        return quantize(x, *a, **k)

    monkeypatch.setattr(tql, "quantize_to_int8", strict)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((2, 16, 8, 8)).astype(np.float32)).bfloat16()
    ctx = torch.from_numpy(rng.standard_normal((2, CTX, 16)).astype(np.float32)).bfloat16()
    with torch.inference_mode():
        one = t2d(x[:1], ctx[:1], cfg, None, 0.6)
        two = t2d(x, ctx, cfg, None, 0.6)
    assert seen and set(seen) == {1}
    assert torch.equal(one, two[:1])


# ------------------------------------------------------------- IP-Adapter


def _ip_sd(rng, plus: bool, embed_dim: int = 24, num_tokens: int = 4) -> dict:
    """An IP-Adapter checkpoint for the CN_TINY UNet in the official layout:
    to_k_ip / to_v_ip at ip_adapter.{odd index}, processors in diffusers'
    order (down blocks, up blocks, the mid block last), and the simple or
    the Plus image projection (hidden 128: two heads of 64)."""
    sd, idx, ctx = {}, 0, CN_TINY["cross_attention_dim"]
    c0, c1, c2 = CN_TINY["block_channels"]
    n1, n2 = CN_TINY["attn_layers"][1], CN_TINY["attn_layers"][2]
    for ch, nl, cnt in ((c1, n1, 2), (c2, n2, 2), (c2, n2, 3), (c1, n1, 3), (c2, n2, 1)):
        for _ in range(cnt * nl):
            idx += 1
            for n in ("to_k_ip", "to_v_ip"):
                sd[f"ip_adapter.{idx}.{n}.weight"] = (
                    rng.standard_normal((ch, ctx)) * 0.3).astype(np.float32)
            idx += 1
    if not plus:
        _lin(rng, "image_proj.proj", embed_dim, num_tokens * ctx, sd)
        _ln(rng, "image_proj.norm", ctx, sd)
        return sd
    hidden = 128
    sd["image_proj.latents"] = (rng.standard_normal((1, num_tokens, hidden)) * 0.5).astype(
        np.float32)
    _lin(rng, "image_proj.proj_in", embed_dim, hidden, sd)
    _lin(rng, "image_proj.proj_out", hidden, ctx, sd)
    _ln(rng, "image_proj.norm_out", ctx, sd)
    for i in range(2):
        p = f"image_proj.layers.{i}"
        _ln(rng, f"{p}.0.norm1", hidden, sd)
        _ln(rng, f"{p}.0.norm2", hidden, sd)
        _lin(rng, f"{p}.0.to_q", hidden, hidden, sd, bias=False, std=0.1)
        _lin(rng, f"{p}.0.to_kv", hidden, 2 * hidden, sd, bias=False, std=0.1)
        _lin(rng, f"{p}.0.to_out", hidden, hidden, sd, bias=False, std=0.1)
        _ln(rng, f"{p}.1.0", hidden, sd)
        _lin(rng, f"{p}.1.1", hidden, 4 * hidden, sd, bias=False, std=0.1)
        _lin(rng, f"{p}.1.3", 4 * hidden, hidden, sd, bias=False, std=0.1)
    return sd


@pytest.mark.parametrize("plus", [False, True])
def test_ip_adapter_attach_and_projection_match_jax(sdxl_unet, plus):
    """sdxl_attach_ip_adapter on both sides (bf16: JAX's int8 loader
    quantizes through its native host library, eagerly per shape): every
    cross-attention's k|v bit for bit at the index diffusers' processor
    order gives it, and in int8 the port's fused k|v is quantize_weight of
    the two checkpoint weights, as the rest of the UNet; the
    projection (simple: num_tokens from the weight; Plus: the resampler
    over 12 CLIP tokens, its attention through the sdpa op) and its
    multi-adapter form within 1e-2 of JAX."""
    jcfg, jp0, _, unet_sd = sdxl_unet
    rng = np.random.default_rng(16 + plus)
    sd = _ip_sd(rng, plus)
    tcfg = tsdxl.SDXLConfig(quant=None, **CN_TINY)
    jp = jax.tree.map(lambda a: a, jp0)  # new containers: the attach writes into them
    jproj = jsdxl.sdxl_attach_ip_adapter(jp, JSource(dict(sd)), jcfg)
    tp = tsdxl.sdxl_load(TSource(dict(unet_sd), device="cpu"), tcfg)
    tproj = tsdxl.sdxl_attach_ip_adapter(tp, TSource(dict(sd), device="cpu"), tcfg)
    _same_state(tp, sdxl_params_from_numpy(jax.device_get(jp), device="cpu"))
    _same_state(tproj, ip_adapter_proj_from_numpy(jax.device_get(jproj), device="cpu"))
    tcfg8 = tsdxl.SDXLConfig(quant="int8", **CN_TINY)
    tp = tsdxl.sdxl_load(TSource(dict(unet_sd), device="cpu"), tcfg8)
    tsdxl.sdxl_attach_ip_adapter(tp, TSource(dict(sd), device="cpu"), tcfg8)
    # the mid block's last cross-attention holds the last odd index
    last = len([k for k in sd if k.endswith("to_k_ip.weight")]) * 2 - 1
    w = torch.from_numpy(np.concatenate([sd[f"ip_adapter.{last}.to_k_ip.weight"],
                                         sd[f"ip_adapter.{last}.to_v_ip.weight"]]).T)
    got = tp.mid.attns[0].blocks[-1].attn2.ipadp_kv
    assert torch.equal(got.w, quantize_weight(w, "int8").w)
    assert tproj.num_tokens == 4
    # batch 1, as test_engine_sdxl_ip_adapter_path's: JAX's eager ops compile once
    x = rng.standard_normal((1, 12, 24) if plus else (1, 24))
    jx, tx = _pair(x)
    if plus:
        want = jip.ip_adapter_plus_projection_apply(jproj, jx, jproj["heads"],
                                                    jproj["head_dim"])
    else:
        want = jip.image_projection_apply(jproj, jx, jproj["num_tokens"])
    with torch.inference_mode():
        tokens = tproj(tx)
    assert tuple(tokens.shape) == want.shape == (1, 4, 16)
    assert _rel_l2(tokens, want) <= 1e-2, _rel_l2(tokens, want)
    if not plus:
        from fastdm_tpu_torch.layers.ip_adapter import multi_image_projection_apply

        jx3, tx3 = _pair(rng.standard_normal((2, 3, 24)))
        jm = jip.multi_image_projection_apply([jproj], [jx3], jproj["num_tokens"])[0]
        with torch.inference_mode():
            tm = multi_image_projection_apply([tproj], [tx3])[0]
        assert tuple(tm.shape) == jm.shape == (2, 3, 4, 16) and _rel_l2(tm, jm) <= 1e-2


def test_sdxl_cross_attention_with_ip_tokens_matches_jax(sdxl_unet, correctly_rounded_silu):
    """The mid block's Transformer2D (its blocks hold the checkpoint's last
    IP weights) on the attached adapter's projected tokens at
    ip_adapter_scale 0.8, within relative L2 2e-3 (measured 7.4e-4 on
    CN_TINY's one block, 1.26e-3 on TINY's two: three attentions a block,
    every one a few one-ulp bf16 differences, a bf16 ulp being 3.9e-3
    relative; test_torch_sdxl.py holds a one-block Transformer2D within 1e-3
    and the whole forward with IP tokens within 5e-2)."""
    jcfg0, jp0, _, unet_sd = sdxl_unet
    rng = np.random.default_rng(18)
    sd = _ip_sd(rng, False)
    jcfg = dataclasses.replace(jcfg0, ip_adapter_scale=0.8)
    tcfg = tsdxl.SDXLConfig(quant=None, ip_adapter_scale=0.8, **CN_TINY)
    jp = jax.tree.map(lambda a: a, jp0)
    jproj = jsdxl.sdxl_attach_ip_adapter(jp, JSource(dict(sd)), jcfg)
    tp = tsdxl.sdxl_load(TSource(dict(unet_sd), device="cpu"), tcfg)
    tproj = tsdxl.sdxl_attach_ip_adapter(tp, TSource(dict(sd), device="cpu"), tcfg)
    jx, tx = _pair(rng.standard_normal((2, 24)))
    jtok = jip.image_projection_apply(jproj, jx, jproj["num_tokens"])
    with torch.inference_mode():
        ttok = tproj(tx)
    assert _rel_l2(ttok, jtok) <= 1e-2
    ttok = torch.from_numpy(np.array(jtok, np.float32)).bfloat16()  # the same tokens
    jh, th = _pair(rng.standard_normal((2, 4, 4, 32)))
    jc, tc = _pair(rng.standard_normal((2, CTX, 16)))
    want = jax.jit(lambda p, h, c, tok: jsdxl._transformer2d(p, h, c, jcfg, tok))(
        jp["mid"]["attn"], jh, jc, jtok)
    with torch.inference_mode():
        t2d = tp.mid.attns[0]
        got = t2d(th.permute(0, 3, 1, 2), tc, tcfg, ttok, tcfg.ip_adapter_scale)
        without = t2d(th.permute(0, 3, 1, 2), tc, tcfg, None, tcfg.ip_adapter_scale)
    assert _rel_l2(got, _nchw(_np(want))) <= 2e-3
    assert _rel_l2(without, got) > 1e-2  # the image tokens enter


# ------------------------------------------------------------------ engine


def _flux_root(tmp_path):
    """A FLUX_TINY transformer/ + vae/ checkpoint -> (root, transformer state
    dict, VAE state dict)."""
    root = str(tmp_path / "flux-tiny")
    rng = np.random.default_rng(0)
    tsd, vsd = _flux_transformer_sd(rng), _vae_sd(rng)
    _write_st(os.path.join(root, "transformer", "model.safetensors"), tsd)
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(FLUX_TINY, f)
    _write_st(os.path.join(root, "vae", "model.safetensors"), vsd)
    return root, tsd, vsd


def _flux_cn_dir(tmp_path, name: str, sd: dict, cfg: dict) -> str:
    path = str(tmp_path / name)
    _write_st(os.path.join(path, "diffusion_pytorch_model.safetensors"), sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return path


def _uint8(seed, h, w):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


@pytest.fixture
def sdxl_cn_root(tmp_path, monkeypatch):
    """A CN_TINY unet/ + vae/ checkpoint, with the engine's SDXLConfig and
    VAE_CONFIGS["sdxl"] shrunk to match it -> (root, the UNet's state dict)."""
    rng = np.random.default_rng(9)
    root = str(tmp_path / "sdxl-cn-tiny")
    unet_sd = _unet_sd(rng)
    _write_st(os.path.join(root, "unet", "model.safetensors"), unet_sd)
    _write_st(os.path.join(root, "vae", "model.safetensors"), _vae_sd(rng, latent_channels=4))
    monkeypatch.setitem(teng.VAE_CONFIGS, "sdxl", tvae.VAEConfig(**VAE_TINY))
    tiny = tsdxl.SDXLConfig
    monkeypatch.setattr(tsdxl, "SDXLConfig", lambda quant=None: tiny(quant=quant, **CN_TINY))
    return root, unet_sd


def _sdxl_request(seed: int):
    """A 64x64 CFG request's keywords (guidance 5.0) and the conditioning
    JAX's loop takes for it: (embeds, pooled, time_ids) as the JAX engine
    builds them, uncond first."""
    kw = dict(sdxl_embeds(seed), height=64, width=64, num_inference_steps=STEPS,
              guidance_scale=5.0, output_type="latent")
    bf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in sdxl_embeds(seed).items()}
    cond = (jnp.concatenate([bf["negative_prompt_embeds"], bf["prompt_embeds"]]),
            jnp.concatenate([bf["negative_pooled_prompt_embeds"], bf["pooled_prompt_embeds"]]),
            jnp.asarray([[64.0, 64, 0, 0, 64, 64]] * 2))
    return kw, cond


def _engine_noise(shape, seed: int) -> np.ndarray:
    """The engine's latent noise for `seed` (a seeded torch.Generator)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).numpy()


def test_engine_flux_controlnet_path(tmp_path, monkeypatch):
    """controlnet_path with a union checkpoint (config.json: 1 dual, 1
    single block, guidance): a latent hint, control_mode 4, two steps,
    against JAX's loop on JAX's loads of the same checkpoints, fed the hint
    the JAX engine makes (the image in [-1, 1] through JAX's VAE encoder,
    packed) and the engine's noise; another mode changes the latents, an
    i2i image is dropped (JAX's ControlNet branch comes before SDEdit), and
    with use_int8 the ControlNet takes the engine's quant."""
    monkeypatch.setitem(teng.VAE_CONFIGS, "flux", tvae.VAEConfig(**VAE_TINY))
    root, tsd, vsd = _flux_root(tmp_path)
    cn_sd = _flux_cn_sd(np.random.default_rng(20), FLUX_TINY, union=True)
    cn = _flux_cn_dir(tmp_path, "cn-union", cn_sd,
                      dict(FLUX_TINY, num_layers=1, num_single_layers=1))
    eng = teng.FastDMEngine(root, architecture="flux", verbose=False, device="cpu",
                            controlnet_path=cn)
    jcfg = jflux.FluxConfig(quant=None, **FLUX_TINY)
    jccfg = _flux_cn_cfg(guidance_embeds=True)[0]
    assert (eng.cn_cfg.num_layers, eng.cn_cfg.num_single_layers, eng.cn_cfg.guidance_embeds) \
        == (jccfg.num_layers, jccfg.num_single_layers, jccfg.guidance_embeds)
    rng = np.random.default_rng(21)
    kw = dict(prompt_embeds=rng.standard_normal((1, TXT, 64)).astype(np.float32),
              pooled_prompt_embeds=rng.standard_normal((1, 48)).astype(np.float32),
              height=64, width=64, num_inference_steps=STEPS, seed=4, output_type="latent",
              controlnet_conditioning_scale=0.9)
    hint = _uint8(22, 64, 64)
    lat = eng.generate(control_image=hint, control_mode=4, **kw)
    jvcfg = jvae.VAEConfig(**VAE_TINY)
    jv = jvae.vae_load(JSource(dict(vsd)), jvcfg)
    z = jax.jit(lambda p, x: jvae.vae_encode(p, jvcfg, x))(
        jv["encoder"], jnp.asarray(hint, jnp.float32)[None] / 127.5 - 1.0)
    jcos, jsin = jflux.flux_rope_cache(jcfg, TXT, HT, WT)
    want, _ = _jax_flux_cn_loop(4)(
        jflux.flux_load(JSource(dict(tsd)), jcfg),
        jcn.flux_controlnet_load(JSource(dict(cn_sd)), jccfg),
        jnp.asarray(_engine_noise((1, HT * WT, 16), 4)), jden.flux_pack_latents(z),
        jnp.asarray(kw["prompt_embeds"], jnp.bfloat16),
        jnp.asarray(kw["pooled_prompt_embeds"], jnp.bfloat16), jcos, jsin)
    assert lat.shape == want.shape and _rel_l2(lat, want) <= 2e-2, _rel_l2(lat, want)
    assert not np.array_equal(eng.generate(control_image=hint, control_mode=5, **kw), lat)
    i2i = eng.generate(task="i2i", image=_uint8(23, 64, 64), control_image=hint,
                       control_mode=4, **kw)
    np.testing.assert_array_equal(i2i, lat)
    eng8 = teng.FastDMEngine(root, architecture="flux", use_int8=True, verbose=False,
                             device="cpu", controlnet_path=cn)
    assert eng8.cn_cfg.quant == "int8"
    assert eng8.cn_params.dual_blocks[0].attn.qkv.w.dtype == torch.int8


def test_engine_sdxl_controlnet_path(tmp_path, sdxl_cn_root):
    """controlnet_path on SDXL (the UNet's config): a [0, 1] hint, two CFG
    steps with and without guess mode, each against JAX's loop on JAX's
    loads of the same checkpoints and the engine's noise; an i2i image is
    ignored (JAX's `not use_cn`): the call with it equals the call without."""
    root, unet_sd = sdxl_cn_root
    cn_sd = _unet_sd(np.random.default_rng(24), cn=True)
    cn_dir = str(tmp_path / "sdxl-cn")
    _write_st(os.path.join(cn_dir, "diffusion_pytorch_model.safetensors"), cn_sd)
    eng = teng.FastDMEngine(root, architecture="sdxl", verbose=False, device="cpu",
                            controlnet_path=cn_dir)
    assert eng.cn_cfg is eng.cfg
    jcfg = jsdxl.SDXLConfig(quant=None, **CN_TINY)
    jp = jsdxl.sdxl_load(JSource(dict(unet_sd)), jcfg)
    jcp = jcn.sdxl_controlnet_load(JSource(dict(cn_sd)), jcfg)
    hint = _uint8(25, 64, 64)
    kw, (embeds, pooled, ids) = _sdxl_request(26)
    kw.update(seed=5, controlnet_conditioning_scale=0.8)
    jhint = jnp.asarray(hint, jnp.float32)[None] / 255.0
    for guess in (True, False):
        lat = eng.generate(control_image=hint, guess_mode=guess, **kw)
        run, sched = _jax_sdxl_cn_loop(guess)
        noise = jnp.asarray(_engine_noise((1, 4, 8, 8), 5)) * sched.init_noise_sigma
        want, _ = run(jp, jcp, noise, embeds, pooled, ids, jhint)
        assert lat.shape == want.shape and _rel_l2(lat, want) <= SDXL_TOL, \
            (guess, _rel_l2(lat, want))
    i2i = eng.generate(task="i2i", image=_uint8(27, 96, 96), control_image=hint, **kw)
    np.testing.assert_array_equal(i2i, lat)


@functools.lru_cache(maxsize=None)
def _jax_sdxl_ip_loop():
    """JAX's SDXL loop at CN_TINY with ip_adapter_scale 0.8: STEPS CFG steps,
    guidance 5.0; one compile for both projections."""
    sched = jsch.EulerDiscreteScheduler.create(STEPS)
    cfg = jsdxl.SDXLConfig(quant=None, ip_adapter_scale=0.8, **CN_TINY)
    return jdm.make_sdxl_denoiser(cfg, sched, STEPS, 5.0), sched, cfg


@pytest.mark.parametrize("plus", [False, True])
def test_engine_sdxl_ip_adapter_path(tmp_path, sdxl_cn_root, plus):
    """ip_adapter_path (scale 0.8) with ip_adapter_image_embeds: (B, D)
    projected embeddings for the simple projection, (B, S, D) states for
    Plus; the negative half's tokens are zeros under CFG. The latents are
    held to JAX's loop on JAX's loads of the same checkpoints, fed the
    tokens JAX's projection makes of the same embeddings, as the JAX engine
    does, and the engine's noise. With an image_encoder/ (a tiny
    CLIPVisionModelWithProjection: projection 24 for the simple adapter,
    hidden 24 for Plus) ip_adapter_image gives the latents of the embeds
    request made with the port tower's output, bit for bit, and JAX's loop
    on JAX's CLIPImageEncoder's output within SDXL_TOL; given embeds win
    over an image. With use_int8 the fused k|v is int8."""
    root, unet_sd = sdxl_cn_root
    ip_sd = _ip_sd(np.random.default_rng(28), plus)
    ip_dir = str(tmp_path / "ip")
    _write_st(os.path.join(ip_dir, "ip-adapter.safetensors"), ip_sd)
    eng = teng.FastDMEngine(root, architecture="sdxl", verbose=False, device="cpu",
                            ip_adapter_path=ip_dir, ip_adapter_scale=0.8)
    assert eng.cfg.ip_adapter_scale == 0.8
    emb = np.random.default_rng(29).standard_normal((1, 12, 24) if plus else (1, 24)).astype(
        np.float32)
    kw, (embeds, pooled, ids) = _sdxl_request(30)
    kw.update(seed=6)
    lat = eng.generate(ip_adapter_image_embeds=emb, **kw)
    run, sched, jcfg = _jax_sdxl_ip_loop()
    jp = jsdxl.sdxl_load(JSource(dict(unet_sd)), jcfg)
    jproj = jsdxl.sdxl_attach_ip_adapter(jp, JSource(dict(ip_sd)), jcfg)

    def jax_latents(jemb):
        if plus:
            tok = jip.ip_adapter_plus_projection_apply(jproj, jemb, heads=jproj["heads"],
                                                       head_dim=jproj["head_dim"])
        else:
            tok = jip.image_projection_apply({k: jproj[k] for k in ("proj", "norm")}, jemb,
                                             jproj["num_tokens"])
        noise = jnp.asarray(_engine_noise((1, 4, 8, 8), 6)) * sched.init_noise_sigma
        return run(jp, noise, embeds, pooled, ids, jnp.concatenate([jnp.zeros_like(tok), tok]))[0]

    want = jax_latents(jnp.asarray(emb, jnp.bfloat16))
    assert lat.shape == want.shape and _rel_l2(lat, want) <= SDXL_TOL, _rel_l2(lat, want)
    assert not np.array_equal(eng.generate(**kw), lat)
    # an image through the CLIP vision tower of image_encoder/
    from fastdm_tpu.pipeline.text_encoder import CLIPImageEncoder as JImageEncoder
    from test_torch_clip_vision import write_tower

    enc_dir = os.path.join(root, "image_encoder")
    image = _uint8(33, 60, 90)
    with pytest.raises(FileNotFoundError, match="image_encoder"):
        eng.generate(ip_adapter_image=image, **kw)
    write_tower(enc_dir, True, seed=34, **(dict(hidden_size=24, num_attention_heads=2,
                                                intermediate_size=48) if plus else {}))
    img_lat = eng.generate(ip_adapter_image=image, **kw)
    port_emb = eng.image_encoder.encode(image, hidden_states=plus)
    assert tuple(port_emb.shape) == ((1, 17, 24) if plus else (1, 24))
    np.testing.assert_array_equal(eng.generate(ip_adapter_image_embeds=port_emb, **kw), img_lat)
    np.testing.assert_array_equal(
        eng.generate(ip_adapter_image=image, ip_adapter_image_embeds=emb, **kw), lat)
    want = jax_latents(JImageEncoder(enc_dir).encode(image, hidden_states=plus))
    assert _rel_l2(img_lat, want) <= SDXL_TOL, _rel_l2(img_lat, want)
    if not plus:
        eng8 = teng.FastDMEngine(root, architecture="sdxl", use_int8=True, verbose=False,
                                 device="cpu", ip_adapter_path=ip_dir, ip_adapter_scale=0.8)
        assert eng8.params.up[1].attns[2].blocks[0].attn2.ipadp_kv.w.dtype == torch.int8


def test_engine_refusals(tmp_path, sdxl_engine_root):
    """A control_image without controlnet_path and ip_adapter_image_embeds
    or ip_adapter_image without ip_adapter_path raise ValueError (JAX ignores
    them; an ip_adapter_image on a checkpoint without image_encoder/ names
    the directory, test_engine_sdxl_ip_adapter_path); a ControlNet on another
    family or an IP-Adapter off SDXL raises before any weight is read."""
    root = sdxl_engine_root
    eng = teng.FastDMEngine(root, architecture="sdxl", verbose=False, device="cpu")
    kw = dict(sdxl_embeds(31), height=64, width=64, num_inference_steps=1)
    with pytest.raises(ValueError, match="controlnet_path"):
        eng.generate(control_image=np.zeros((64, 64, 3), np.uint8), **kw)
    with pytest.raises(ValueError, match="ip_adapter_path"):
        eng.generate(ip_adapter_image_embeds=np.zeros((1, 24), np.float32), **kw)
    with pytest.raises(ValueError, match="ip_adapter_image needs .* ip_adapter_path"):
        eng.generate(ip_adapter_image=np.zeros((64, 64, 3), np.uint8), **kw)
    missing = str(tmp_path / "nothing-here")
    with pytest.raises(ValueError, match="flux/sdxl"):
        teng.FastDMEngine(missing, architecture="sd35", device="cpu", controlnet_path=missing)
    with pytest.raises(ValueError, match="sdxl only"):
        teng.FastDMEngine(missing, architecture="flux", device="cpu", ip_adapter_path=missing)


def test_entry_points_default_to_the_card(tmp_path, sdxl_engine_root):
    """Without a GPU the new entry points raise unless the caller asks for
    the CPU: no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    cn_dir = str(tmp_path / "sdxl-cn")
    _write_st(os.path.join(cn_dir, "model.safetensors"),
              _sdxl_sd(np.random.default_rng(32), cn=True))
    _, tcfg = _flux_cn_cfg()
    for call in (lambda: tcn.sdxl_controlnet_init_random(0, tsdxl.SDXLConfig()),
                 lambda: tcn.flux_controlnet_init_random(0, tcfg),
                 lambda: teng.FastDMEngine(sdxl_engine_root, architecture="sdxl",
                                           verbose=False, controlnet_path=cn_dir)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
