"""The port's Wan2.2 text-to-video path against the JAX package: the radial
sparse tables, the transformer (dense, with the superblock gather tables, and
the split-QKV form), the loader, UniPC, the dual-expert phase denoiser and
the engine end to end, on tiny configs (2 heads x 24, 2 layers), inputs from
numpy seeds, JAX random params moved across by the converter.

Tolerances: the radial mask and the superblock tables equal JAX's bit for
bit; UniPC within 1e-6 + 1e-6*|x| of JAX (the step's scalar coefficients
are computed in float64 on the host here, in float32 on the device there) and
of the float64 numpy oracle; a Wan forward runs in bfloat16 (the patch embedding
casts to it), so the forwards are held to relative L2 1e-2 of JAX (bf16
rounds at the same points; a one-ulp flip of a SiLU/GELU or a norm propagates
through the residual adds), the split-QKV forward to 2e-2 + 2e-2*|x| of the
fused one (as tests/test_wan_model.py) and, in int8, to the fused one bit for
bit (per-row quantization and the int8 GEMM are exact, and the two-operand
norm+rope computes what the fused one does); the 4-step dual-expert
denoiser's latents to relative L2 2e-2 of JAX's; weights loaded by both
loaders from one checkpoint, bit for bit.
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

from fastdm_tpu.models import wan as jwan
from fastdm_tpu.models.loader import TensorSource as JSource
from fastdm_tpu.pipeline.denoise_more import make_wan_denoiser as j_one_expert
from fastdm_tpu.pipeline.denoise_more import make_wan_dual_phase_denoiser as j_dual_phase
from fastdm_tpu.pipeline.schedulers import UniPCMultistepScheduler as JUniPC
from fastdm_tpu.sparse.config import RadialAttnConfig as JRadialConfig
from fastdm_tpu.sparse.xsparse import RadialAttn as JRadialAttn
from fastdm_tpu.sparse.xsparse import radial_block_mask as j_radial_block_mask
from fastdm_tpu_torch.models import wan as twan
from fastdm_tpu_torch.models.convert import wan_params_from_numpy
from fastdm_tpu_torch.models.loader import TensorSource as TSource
from fastdm_tpu_torch.pipeline.denoise_wan import (
    expert_boundary_step,
    make_wan_denoiser,
    make_wan_dual_phase_denoiser,
)
from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler as TUniPC
from fastdm_tpu_torch.sparse.config import RadialAttnConfig, SparseConfig
from fastdm_tpu_torch.sparse.xsparse import RadialAttn, radial_block_mask

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_wan import TINY, _state_dict  # noqa: E402
from unipc_oracle import UniPCOracle  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = 8
RADIAL = dict(sparse_algorithm="radial", model_type="wan", block_size=16, decay_factor=0.3,
              dense_layers=1, dense_steps=1)


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


@pytest.fixture(scope="module", params=[None, "int8"])
def models(request):
    jcfg, tcfg = _cfgs(quant=request.param)
    jparams = jwan.wan_init_random(jax.random.key(0), jcfg)
    tparams = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _inputs(seed, f=4, h=16, w=16):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((1, TINY["in_channels"], f, h, w)).astype(np.float32)
    text = rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
    return video, text


# the sparse cases: 8 latent frames of 4x4 patches, one 16-token block per
# frame, q tiles of one block, so the radial mask's frame-distance pattern
# survives into the tables
SPARSE_FHW = (8, 8, 8)
SPARSE_BLOCKS = dict(sparse_gather_fine_blocks=(16, 8, 16), sparse_gather_superblock=4)


def _super_tables(f, h, w, bq=16, grp=8, sb=4):
    """Port and JAX radial superblock tables of a (f, h, w) latent video at
    block_size 16 (patch 1x2x2 -> f*h*w/4 tokens); they must agree."""
    tokens = f * (h // 2) * (w // 2)
    mine = RadialAttn.from_dict(RADIAL)
    mine.post_init(tokens, f)
    theirs = JRadialAttn.from_dict(RADIAL)
    theirs.post_init(tokens, f)
    t, j = mine.block_lists_super(bq, grp // sb, sb), theirs.block_lists_super(bq, grp // sb, sb)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    return t


# ------------------------------------------------------------ sparse tables


@pytest.mark.parametrize("tokens,frames,block,decay,model_type", [
    (21 * 30 * 52, 21, 128, 0.3, "wan"),   # Wan2.2-A14B 480x832x81, the example config
    (5 * 30 * 52, 5, 128, 0.3, "wan"),     # 17 frames
    (9 * 16 * 16, 9, 64, 1.0, "wan"),
    (8 * 12 * 20, 8, 32, 0.5, "hunyuan"),
])
def test_radial_block_mask_matches_jax(tokens, frames, block, decay, model_type):
    kw = dict(block_size=block, decay_factor=decay, model_type=model_type)
    got = radial_block_mask(tokens, frames, RadialAttnConfig(**kw))
    want = j_radial_block_mask(tokens, frames, JRadialConfig(**kw))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("q_tokens,group,superblock", [(256, 8, 4), (512, 4, 4), (256, 3, 2)])
def test_block_lists_super_matches_jax(q_tokens, group, superblock):
    cfg = json.load(open(os.path.join(REPO, "examples", "sparse", "radial_attn_wan.json")))
    mine, theirs = RadialAttn.from_dict(cfg), JRadialAttn.from_dict(cfg)
    for a in (mine, theirs):
        a.post_init(5 * 30 * 52, 5)
    got = mine.block_lists_super(q_tokens, group, superblock)
    want = theirs.block_lists_super(q_tokens, group, superblock)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_sparse_config_reads_the_example_json():
    cfg = SparseConfig.from_json(os.path.join(REPO, "examples", "sparse",
                                              "radial_attn_wan.json"))
    assert isinstance(cfg, RadialAttnConfig)
    assert (cfg.block_size, cfg.decay_factor, cfg.dense_layers, cfg.dense_steps,
            cfg.model_type) == (128, 0.3, 1, 11, "wan")


# ---------------------------------------------------------------- model


def _forward_pair(jcfg, jparams, tcfg, tparams, seed, jmask=None, tmask=None,
                  fhw=(4, 16, 16)):
    video, text = _inputs(seed, *fhw)
    t = 500.0
    want = jwan.wan_forward(jparams, jcfg, jnp.asarray(video, jnp.bfloat16),
                            jnp.full((1,), t, jnp.float32), jnp.asarray(text, jnp.bfloat16),
                            sparse_mask=jmask)
    got = twan.wan_forward(tparams, tcfg, torch.from_numpy(video).bfloat16(),
                           torch.full((1,), t), torch.from_numpy(text).bfloat16(),
                           sparse_mask=tmask)
    return got, want


def test_converter_keeps_every_parameter(models):
    _, jparams, _, tparams = models
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    assert len(tparams.blocks) == TINY["num_layers"]


def test_wan_forward_matches_jax(models):
    got, want = _forward_pair(*models, seed=1)
    assert tuple(got.shape) == want.shape == (1, TINY["out_channels"], 4, 16, 16)
    assert _rel_l2(got, want) <= 1e-2


def test_wan_forward_with_super_tables_matches_jax(models):
    """Radial superblock tables, dense first layer: the port's gather_super
    plain version against JAX's sdpa_gather_super_jnp inside the model."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(dense_layers=1, **SPARSE_BLOCKS)
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    tables = _super_tables(*SPARSE_FHW)
    got, want = _forward_pair(jcfg, jparams, tcfg, tparams, 2,
                              tuple(jnp.asarray(a) for a in tables),
                              tuple(torch.from_numpy(a) for a in tables), fhw=SPARSE_FHW)
    assert _rel_l2(got, want) <= 1e-2
    dense, _ = _forward_pair(jcfg, jparams, tcfg, tparams, 2, fhw=SPARSE_FHW)
    assert _rel_l2(got, dense) > 1e-3  # the tables do cut attention


def test_split_qkv_matches_fused(models):
    """split_qkv_proj with chunked projections (4 chunks of 64 of 256
    tokens) against the fused form, and against JAX's split form."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(split_qkv_proj=True, ffn_chunk_tokens=64)
    fused, _ = _forward_pair(jcfg, jparams, tcfg, tparams, 3)
    split, jsplit = _forward_pair(dataclasses.replace(jcfg, **kw), jparams,
                                  dataclasses.replace(tcfg, **kw), tparams, 3)
    np.testing.assert_allclose(_np(split), _np(fused), rtol=2e-2, atol=2e-2)
    assert _rel_l2(split, jsplit) <= 1e-2
    if tcfg.quant == "int8":
        assert torch.equal(split, fused)


def test_wan_load_matches_jax_loader():
    sd = _state_dict(np.random.default_rng(0))
    for quant in (None, "int8"):
        jcfg, tcfg = _cfgs(quant=quant)
        jparams = jwan.wan_load(JSource(dict(sd)), jcfg)
        loaded = twan.wan_load(TSource(dict(sd), device="cpu"), tcfg)
        converted = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
        for (name, a), (name_b, b) in zip(loaded.named_parameters(),
                                          converted.named_parameters()):
            assert name == name_b and a.dtype == b.dtype and torch.equal(a, b), name


def test_wan_init_random_is_seeded_int8():
    _, cfg = _cfgs(quant="int8")
    a, b = (twan.wan_init_random(7, cfg, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    blk = a.blocks[0]
    assert blk.attn1.qkv.w.dtype == torch.int8 and blk.ffn.out.w.dtype == torch.int8
    assert a.patch_embedding.w.dtype == torch.bfloat16
    assert blk.scale_shift_table.dtype == torch.float32
    assert blk.attn1.norm_q.shape == (cfg.inner_dim,)


def test_wan_config_defaults_are_the_a14b_transformer():
    j, t = jwan.WanConfig(), twan.WanConfig()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.inner_dim, t.num_layers, t.ffn_dim, t.patch_size) == (5120, 40, 13824, (1, 2, 2))


def test_rope_tables_match_jax():
    jcfg, tcfg = _cfgs()
    jc, js = jwan.wan_rope_cos_sin(jcfg, 5, 12, 20)
    tc, ts = twan.wan_rope_cos_sin(tcfg, 5, 12, 20, device="cpu")
    assert np.array_equal(np.asarray(jc), tc.numpy()) and np.array_equal(np.asarray(js),
                                                                           ts.numpy())


def test_later_slices_raise(models):
    """The Wan2.1 image branch has arrived (its cases below): image tokens on
    a transformer without the image embedder raise ValueError; TeaCache on
    Wan is still refused."""
    _, _, tcfg, tparams = models
    video, text = _inputs(0)
    args = (torch.from_numpy(video).bfloat16(), torch.full((1,), 1.0),
            torch.from_numpy(text).bfloat16())
    with pytest.raises(ValueError, match="image embedder"):
        twan.wan_forward(tparams, tcfg, *args,
                         encoder_hidden_states_image=torch.zeros(1, IMG_TOKENS, IMG_DIM))
    # the step caches of Wan are FBCache and DiCache; TeaCache is refused, as in JAX
    from fastdm_tpu_torch.caching.config import TeaCacheConfig

    with pytest.raises(ValueError, match="FBCache / DiCache"):
        twan.wan_forward_cached(tparams, tcfg, TeaCacheConfig(), {}, 0, 1, *args)


# ------------------------------------------------------ Wan2.1-I2V image branch

# the image tokens of tests/test_torch_clip_vision.py's tiny tower: 48 wide,
# 4x4 patches of a 56-pixel image and the class token
IMG_DIM, IMG_TOKENS = 48, 17
INNER = TINY["num_attention_heads"] * TINY["attention_head_dim"]


def _image_sd(seed, pos_embed=False, in_channels=None, out_channels=None):
    """A tiny diffusers-layout Wan2.1-I2V transformer state dict: the t2v
    blocks plus condition_embedder.image_embedder (and its pos_embed) and
    each block's attn2.add_k_proj / add_v_proj / norm_added_k."""
    from reference_harness import lin

    rng = np.random.default_rng(seed)
    sd = _state_dict(rng)
    if in_channels is not None:
        sd["patch_embedding.weight"] = (rng.standard_normal((INNER, in_channels, 1, 2, 2))
                                        * 0.05).astype(np.float32)
        lin(sd, rng, "proj_out", INNER, out_channels * 4)
    ie = "condition_embedder.image_embedder"
    for n, width in (("norm1", IMG_DIM), ("norm2", INNER)):
        sd[f"{ie}.{n}.weight"] = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        sd[f"{ie}.{n}.bias"] = (0.05 * rng.standard_normal(width)).astype(np.float32)
    lin(sd, rng, f"{ie}.ff.net.0.proj", IMG_DIM, IMG_DIM, std=0.15)
    lin(sd, rng, f"{ie}.ff.net.2", IMG_DIM, INNER, std=0.15)
    if pos_embed:
        sd[f"{ie}.pos_embed"] = (0.3 * rng.standard_normal((1, 2 * IMG_TOKENS, IMG_DIM))
                                 ).astype(np.float32)
    for i in range(TINY["num_layers"]):
        p = f"blocks.{i}.attn2"
        lin(sd, rng, f"{p}.add_k_proj", INNER, INNER, std=0.15)
        lin(sd, rng, f"{p}.add_v_proj", INNER, INNER, std=0.15)
        sd[f"{p}.norm_added_k.weight"] = (1.0 + 0.05 * rng.standard_normal(INNER)).astype(
            np.float32)
    return sd


def _image_cfgs(quant):
    return _cfgs(quant=quant, image_dim=IMG_DIM, added_kv_proj_dim=INNER)


@pytest.fixture(scope="module", params=[(None, False), ("int8", False), (None, True),
                                        ("int8", True)], ids=lambda p: f"{p[0]}-pos{p[1]}")
def image_models(request):
    """JAX's loader on a synthetic Wan2.1-I2V state dict, the port's tree
    converted from it (with and without pos_embed)."""
    quant, pos = request.param
    jcfg, tcfg = _image_cfgs(quant)
    sd = _image_sd(20 + pos, pos_embed=pos)
    jparams = jwan.wan_load(JSource(dict(sd)), jcfg)
    tparams = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams, sd, pos


def _image_tokens(seed, pos):
    """CLIP penultimate tokens: two images' (first and last frame) with a
    pos_embed, one otherwise."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2 if pos else 1, IMG_TOKENS, IMG_DIM)).astype(np.float32)


def test_image_branch_loads_and_converts_bit_for_bit(image_models):
    """wan_load from the diffusers names and wan_params_from_numpy of JAX's
    tree give the same parameters, and the converter keeps every leaf."""
    jcfg, jparams, tcfg, tparams, sd, pos = image_models
    loaded = twan.wan_load(TSource(dict(sd), device="cpu"), tcfg)
    for (name, a), (name_b, b) in zip(loaded.named_parameters(), tparams.named_parameters()):
        assert name == name_b and a.dtype == b.dtype and torch.equal(a, b), name
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    ie = tparams.image_embedder
    assert (ie.pos_embed is not None) == pos and ie.proj.w.dtype == torch.bfloat16
    a2 = tparams.blocks[0].attn2
    want = torch.int8 if tcfg.quant == "int8" else torch.bfloat16
    assert a2.add_k.w.dtype == a2.add_v.w.dtype == want and a2.norm_added_k.shape == (INNER,)


def test_wan_condition_with_image_matches_jax(image_models):
    """The image embedder (f32) and the text projection: the context is the
    image tokens, within relative L2 1e-3 of JAX (f32 throughout, one bf16
    rounding at the end), then the text tokens, within 1e-2 (the bf16 text
    projection, as the forwards)."""
    jcfg, jparams, tcfg, tparams, _, pos = image_models
    img = _image_tokens(1, pos)
    _, text = _inputs(1)
    t = np.array([700.0], np.float32)
    _, _, want = jwan.wan_condition(jparams, jcfg, jnp.asarray(t), jnp.asarray(text, jnp.bfloat16),
                                    jnp.asarray(img, jnp.bfloat16))
    _, _, got = twan.wan_condition(tparams, tcfg, torch.from_numpy(t),
                                   torch.from_numpy(text).bfloat16(),
                                   torch.from_numpy(img).bfloat16())
    n_img = (2 if pos else 1) * IMG_TOKENS
    assert tuple(got.shape) == want.shape == (1, n_img + TEXT, INNER)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got[:, :n_img], want[:, :n_img]) <= 1e-3
    assert _rel_l2(got[:, n_img:], want[:, n_img:]) <= 1e-2


def _image_forward_pair(jcfg, jparams, tcfg, tparams, seed, img):
    video, text = _inputs(seed)
    t = 400.0
    jimg = None if img is None else jnp.asarray(img, jnp.bfloat16)
    timg = None if img is None else torch.from_numpy(img).bfloat16()
    want = jwan.wan_forward(jparams, jcfg, jnp.asarray(video, jnp.bfloat16),
                            jnp.full((1,), t, jnp.float32), jnp.asarray(text, jnp.bfloat16),
                            jimg)
    got = twan.wan_forward(tparams, tcfg, torch.from_numpy(video).bfloat16(),
                           torch.full((1,), t), torch.from_numpy(text).bfloat16(), timg)
    return got, want


def test_wan_forward_with_image_matches_jax(image_models):
    """The whole forward with image tokens (bf16 and int8, with and without
    pos_embed) within relative L2 1e-2 of JAX; the image changes it; the
    chunked cross-attention (4 chunks) gives the same forward."""
    jcfg, jparams, tcfg, tparams, _, pos = image_models
    img = _image_tokens(2, pos)
    got, want = _image_forward_pair(jcfg, jparams, tcfg, tparams, 3, img)
    assert _rel_l2(got, want) <= 1e-2
    text_only, _ = _image_forward_pair(jcfg, jparams, tcfg, tparams, 3, None)
    assert _rel_l2(got, text_only) > 1e-2
    video, text = _inputs(3)
    chunked = twan.wan_forward(tparams, dataclasses.replace(tcfg, ffn_chunk_tokens=64),
                               torch.from_numpy(video).bfloat16(), torch.full((1,), 400.0),
                               torch.from_numpy(text).bfloat16(),
                               torch.from_numpy(img).bfloat16())
    if tcfg.quant == "int8":
        assert torch.equal(chunked, got)
    else:
        assert _rel_l2(chunked, got) <= 1e-2


def test_text_only_context_skips_the_image_keys(image_models):
    """An image checkpoint driven without an image: a context of text_len
    tokens takes the text path alone (JAX's guard: a zero-length image
    softmax would be NaN), equal to the forward of the same tree without
    add_k / add_v, and to JAX's."""
    jcfg, jparams, tcfg, tparams, _, _ = image_models
    got, want = _image_forward_pair(jcfg, jparams, tcfg, tparams, 4, None)
    assert bool(torch.isfinite(got).all()) and _rel_l2(got, want) <= 1e-2
    bare = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
    for blk in bare.blocks:
        blk.attn2.add_k = blk.attn2.add_v = None
    video, text = _inputs(4)
    plain = twan.wan_forward(bare, tcfg, torch.from_numpy(video).bfloat16(),
                             torch.full((1,), 400.0), torch.from_numpy(text).bfloat16())
    assert torch.equal(plain, got)


def test_wan_init_random_image_branch():
    _, tcfg = _image_cfgs("int8")
    a, b = (twan.wan_init_random(9, tcfg, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    ie, a2 = a.image_embedder, a.blocks[1].attn2
    assert ie.proj.w.shape == (IMG_DIM, IMG_DIM) and ie.out.w.shape == (IMG_DIM, INNER)
    assert ie.norm1_gamma.dtype == torch.float32 and ie.pos_embed is None
    assert a2.add_k.w.dtype == a2.add_v.w.dtype == torch.int8
    assert a2.add_k.w.shape == (INNER, INNER) and a2.norm_added_k.dtype == torch.bfloat16
    _, plain = _cfgs(quant="int8")
    t2v = twan.wan_init_random(9, plain, device="cpu")
    assert t2v.image_embedder is None and t2v.blocks[0].attn2.add_k is None


# ------------------------------------------------------------- scheduler


@pytest.mark.parametrize("num_steps", [1, 2, 4, 12])
def test_unipc_matches_jax_and_oracle(num_steps):
    j, t = JUniPC.create(num_steps, shift=5.0), TUniPC.create(num_steps, shift=5.0)
    assert np.array_equal(j.sigmas, t.sigmas)
    rng = np.random.default_rng(num_steps)
    x = rng.standard_normal((1, 4, 3, 5, 6)).astype(np.float32)
    jx, tx, ox = jnp.asarray(x), torch.from_numpy(x), x.astype(np.float64)
    js, ts, oracle = j.init_state(x.shape), t.init_state(tx), UniPCOracle(num_steps, shift=5.0)
    for i in range(num_steps):
        v = rng.standard_normal(x.shape).astype(np.float32)
        jx, js = j.step(jnp.asarray(v), i, jx, jnp.asarray(j.sigmas), js, num_steps)
        tx, ts = t.step(torch.from_numpy(v), i, tx, ts, num_steps)
        ox = oracle.step(v.astype(np.float64), ox)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tx.numpy(), ox, rtol=1e-6, atol=1e-6)


def test_a14b_boundary_splits_four_steps_two_and_two():
    sched = TUniPC.create(4, shift=5.0)
    np.testing.assert_allclose(sched.sigmas[:4], [0.9998, 0.9373, 0.8331, 0.6247], atol=1e-4)
    assert expert_boundary_step(sched.sigmas, 4, 0.875) == 2


# ------------------------------------------------------------- denoiser


def test_dual_phase_denoiser_matches_jax():
    """Two experts, 4 UniPC steps (boundary 0.875: 2 + 2), CFG 4.0 / 3.0, the
    radial superblock tables with one dense warmup step and one dense layer;
    the same numpy latents, text and tables on both sides."""
    jcfg, tcfg = _cfgs(quant="int8", dense_layers=1, **SPARSE_BLOCKS)
    jp1, jp2 = (jwan.wan_init_random(jax.random.key(s), jcfg) for s in (1, 2))
    tp1, tp2 = (wan_params_from_numpy(jax.device_get(p), device="cpu") for p in (jp1, jp2))
    f, h, w = SPARSE_FHW
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((1, TINY["out_channels"], f, h, w)).astype(np.float32)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    tables = _super_tables(f, h, w)
    jrun = j_dual_phase(jcfg, JUniPC.create(4, shift=5.0), 4, None, 4.0, 3.0, 0.875, 1)
    jc, js = jwan.wan_rope_cos_sin(jcfg, f, h, w)
    want, _ = jrun(jp1, jp2, jnp.asarray(lat), jnp.asarray(pos, jnp.bfloat16),
                   jnp.asarray(neg, jnp.bfloat16), jc, js, tuple(jnp.asarray(a) for a in tables))
    trun = make_wan_dual_phase_denoiser(tcfg, TUniPC.create(4, shift=5.0), 4, 4.0, 3.0, 0.875, 1)
    tc, ts = twan.wan_rope_cos_sin(tcfg, f, h, w, device="cpu")
    got, skips = trun(tp1, tp2, torch.from_numpy(lat), torch.from_numpy(pos).bfloat16(),
                      torch.from_numpy(neg).bfloat16(), tc, ts,
                      tuple(torch.from_numpy(a) for a in tables))
    assert trun.phase_steps == (2, 2) and skips == 0
    assert got.dtype == torch.float32 and tuple(got.shape) == lat.shape
    assert _rel_l2(got, want) <= 2e-2


def test_one_expert_denoiser_matches_jax():
    """One expert (Wan2.1 / single-transformer checkpoints), dense, 3 UniPC
    steps with CFG 5.0, against JAX's make_wan_denoiser without params_2."""
    jcfg, tcfg = _cfgs(quant=None)
    jparams = jwan.wan_init_random(jax.random.key(3), jcfg)
    tparams = wan_params_from_numpy(jax.device_get(jparams), device="cpu")
    f, h, w = 2, 8, 8
    rng = np.random.default_rng(12)
    lat = rng.standard_normal((1, TINY["out_channels"], f, h, w)).astype(np.float32)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    jc, js = jwan.wan_rope_cos_sin(jcfg, f, h, w)
    want, _ = j_one_expert(jcfg, JUniPC.create(3, shift=5.0), 3, 5.0)(
        jparams, None, jnp.asarray(lat), jnp.asarray(pos, jnp.bfloat16),
        jnp.asarray(neg, jnp.bfloat16), jc, js, None)
    tc, ts = twan.wan_rope_cos_sin(tcfg, f, h, w, device="cpu")
    got, _ = make_wan_denoiser(tcfg, TUniPC.create(3, shift=5.0), 3, 5.0)(
        tparams, torch.from_numpy(lat), torch.from_numpy(pos).bfloat16(),
        torch.from_numpy(neg).bfloat16(), tc, ts)
    assert _rel_l2(got, want) <= 2e-2


# ---------------------------------------------------------------- engine


def _write_wan_checkpoint(root, vae: bool = True):
    """A tiny diffusers-layout Wan2.2-A14B checkpoint: two experts, a
    model_index.json with the published boundary, the AutoencoderKLWan."""
    from safetensors.torch import save_file
    from test_wan_vae import TINY as VAE_TINY
    from test_wan_vae import _mk_diffusers_state_dict

    cfg_json = dict(TINY, patch_size=[1, 2, 2])
    for sub, seed in (("transformer", 0), ("transformer_2", 1)):
        os.makedirs(os.path.join(root, sub))
        sd = _state_dict(np.random.default_rng(seed))
        save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                  os.path.join(root, sub, "model.safetensors"))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg_json, f)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"boundary_ratio": 0.875}, f)
    if vae:
        os.makedirs(os.path.join(root, "vae"))
        sd = _mk_diffusers_state_dict(VAE_TINY)
        save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                  os.path.join(root, "vae", "model.safetensors"))
        with open(os.path.join(root, "vae", "config.json"), "w") as f:
            json.dump({"base_dim": VAE_TINY.base_dim, "z_dim": VAE_TINY.z_dim,
                       "dim_mult": list(VAE_TINY.dim_mult),
                       "num_res_blocks": VAE_TINY.num_res_blocks,
                       "temperal_downsample": list(VAE_TINY.temporal_downsample),
                       "latents_mean": list(VAE_TINY.latents_mean),
                       "latents_std": list(VAE_TINY.latents_std)}, f)


def _embeds(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_end_to_end(tmp_path, quant):
    from fastdm_tpu_torch.engine import FastDMEngine

    _write_wan_checkpoint(str(tmp_path))
    eng = FastDMEngine(str(tmp_path), architecture="wan2.2-t2v", use_int8=quant == "int8",
                       sparse_attn_config=dict(RADIAL), verbose=False, device="cpu")
    assert eng.params_2 is not None and eng.boundary_ratio == 0.875
    assert eng.cfg.dense_layers == 1 and eng.vae_params is not None
    want = torch.int8 if quant else torch.bfloat16
    assert eng.params.blocks[0].attn1.qkv.w.dtype == want
    pos, neg = _embeds(3)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=64,
              num_frames=10, num_inference_steps=4, guidance_scale=4.0, guidance_scale_2=3.0,
              seed=5)
    video = eng.generate(**kw)
    # 10 frames round down to 4k+1 = 9: 3 latent frames, 48 tokens
    assert isinstance(video, np.ndarray) and video.dtype == np.uint8
    assert video.shape == (1, 9, 64, 64, 3)
    assert eng.last_phase_steps == (2, 2)
    assert eng.cfg.sparse_gather_fine_blocks == (256, 32, 16)
    assert eng.cfg.sparse_gather_superblock == 4 and eng.cfg.ffn_chunk_tokens == 0
    assert np.array_equal(eng.generate(**kw), video)  # seeded
    latents = eng.generate(**kw, output_type="latent")
    assert latents.shape == (1, TINY["out_channels"], 3, 8, 8) and latents.dtype == np.float32


def test_engine_capacity_knobs_follow_the_token_count(tmp_path, monkeypatch):
    """Above the FFN threshold a generate chunks by tokens/8, and above the
    split threshold the dual expert projects q, k, v apart (the JAX engine's
    rule); under them both are off again."""
    from fastdm_tpu_torch import engine as teng

    _write_wan_checkpoint(str(tmp_path), vae=False)
    eng = teng.FastDMEngine(str(tmp_path), architecture="wan", verbose=False, device="cpu")
    pos, neg = _embeds(4)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=64,
              num_frames=9, num_inference_steps=1, output_type="latent")
    monkeypatch.setattr(teng, "_FFN_CHUNK_MIN_TOKENS", 40)
    monkeypatch.setattr(teng, "_SPLIT_QKV_MIN_TOKENS", 48)
    eng.generate(**kw)
    assert (eng.cfg.ffn_chunk_tokens, eng.cfg.split_qkv_proj) == (6, True)
    monkeypatch.setattr(teng, "_SPLIT_QKV_MIN_TOKENS", 49)
    eng.generate(**kw)
    assert (eng.cfg.ffn_chunk_tokens, eng.cfg.split_qkv_proj) == (6, False)
    monkeypatch.setattr(teng, "_FFN_CHUNK_MIN_TOKENS", 49)
    eng.generate(**kw)
    assert (eng.cfg.ffn_chunk_tokens, eng.cfg.split_qkv_proj) == (0, False)


def test_engine_without_a_vae_returns_latents_and_says_so(tmp_path, capsys):
    from fastdm_tpu_torch.engine import FastDMEngine

    _write_wan_checkpoint(str(tmp_path), vae=False)
    eng = FastDMEngine(str(tmp_path), architecture="wan", verbose=False, device="cpu")
    assert eng.vae_params is None and "did not load" in capsys.readouterr().out
    pos, neg = _embeds(5)
    out = eng.generate(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=64,
                       num_frames=5, num_inference_steps=2)
    assert out.dtype == np.float32 and out.shape == (1, TINY["out_channels"], 2, 8, 8)
    # the UMT5 encoder has arrived: a prompt on a checkpoint without its
    # directories names the missing one (tests/test_torch_text_engine.py)
    with pytest.raises(FileNotFoundError, match="tokenizer/"):
        eng.generate(prompt="a cat", height=64, width=64)
    with pytest.raises(NotImplementedError, match="t2v"):
        eng.generate(task="v2v", prompt_embeds=pos, negative_prompt_embeds=neg)
    with pytest.raises(RuntimeError, match="needs the Wan VAE"):
        eng.generate(task="i2v", image=np.zeros((64, 64, 3), np.uint8), prompt_embeds=pos,
                     negative_prompt_embeds=neg, height=64, width=64, num_frames=5)
    with pytest.raises(ValueError, match="FBCache / DiCache"):
        FastDMEngine(str(tmp_path), architecture="wan", device="cpu", verbose=False,
                     cache_config={"cache_algorithm": "teacache", "enable_caching": True})


# ------------------------------------------------------- Wan2.1-I2V engine


def _write_i2v_checkpoint(root, experts: int = 1):
    """A tiny Wan2.1-I2V-14B layout: the transformer with in_channels 36
    (16 latent + 4 mask + 16 encoded channels), image_dim and
    added_kv_proj_dim in its config.json (two experts when asked), the
    Wan2.1-layout VAE with z_dim 16 and image_encoder/, a CLIPVisionModel
    written by transformers (no projection, as Wan2.1's)."""
    from safetensors.torch import save_file
    from test_torch_clip_vision import write_tower
    from test_wan_vae import TINY as VAE_TINY
    from test_wan_vae import _mk_diffusers_state_dict

    sds = []
    for i, sub in enumerate(("transformer", "transformer_2")[:experts]):
        sd = _image_sd(40 + i, in_channels=36, out_channels=16)
        os.makedirs(os.path.join(root, sub))
        save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                  os.path.join(root, sub, "model.safetensors"))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(dict(TINY, in_channels=36, out_channels=16, patch_size=[1, 2, 2],
                           image_dim=IMG_DIM, added_kv_proj_dim=INNER), f)
        sds.append(sd)
    vcfg = dataclasses.replace(VAE_TINY, z_dim=16, latents_mean=tuple(0.05 * i for i in range(16)),
                               latents_std=tuple(1.0 + 0.05 * i for i in range(16)))
    os.makedirs(os.path.join(root, "vae"))
    save_file({k: torch.from_numpy(v) for k, v in _mk_diffusers_state_dict(vcfg).items()},
              os.path.join(root, "vae", "model.safetensors"))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump({"base_dim": vcfg.base_dim, "z_dim": 16, "dim_mult": list(vcfg.dim_mult),
                   "num_res_blocks": vcfg.num_res_blocks,
                   "temperal_downsample": list(vcfg.temporal_downsample),
                   "latents_mean": list(vcfg.latents_mean),
                   "latents_std": list(vcfg.latents_std)}, f)
    write_tower(os.path.join(root, "image_encoder"), projection=False, seed=41)
    return sds


def _i2v_embeds(seed):
    """UMT5-length (text_len 512) embeddings: the image keys are taken only
    when the context is longer than text_len."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 512, TINY["text_dim"])).astype(np.float32) * 0.5
            for _ in range(2)]


@pytest.mark.parametrize("arch,quant", [("wan2.1-i2v", "int8"), ("wan-i2v", None)])
def test_engine_wan21_i2v_matches_jax(tmp_path, arch, quant):
    """generate(task="i2v", image=...) on a Wan2.1-I2V checkpoint: the CLIP
    tokens equal JAX's CLIPImageEncoder's (hidden_states=True) but for one
    bf16 ulp on at most 2e-3 of the elements; the latents are JAX's
    one-expert loop (JAX's loader, JAX's tokens) on the engine's noise and
    i2v channels within relative L2 2e-2, and the port's loop on the
    engine's own tokens bit for bit."""
    from fastdm_tpu.pipeline import text_encoder as jtext
    from fastdm_tpu_torch.engine import FastDMEngine

    root = str(tmp_path)
    sd = _write_i2v_checkpoint(root)[0]
    eng = FastDMEngine(root, architecture=arch, use_int8=quant == "int8", verbose=False,
                       device="cpu")
    assert eng.architecture == "wan" and eng.params_2 is None
    assert eng.cfg.image_dim == IMG_DIM and eng.cfg.added_kv_proj_dim == INNER
    assert eng.wan_image_encoder is not None and not eng.wan_image_encoder.loaded
    pos, neg = _i2v_embeds(6)
    image = np.random.default_rng(7).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=32, width=48, num_frames=5,
              num_inference_steps=3, guidance_scale=5.0, seed=2, output_type="latent")
    lat = eng.generate(image=image, **kw)  # no task: i2v
    assert lat.shape == (1, 16, 2, 4, 6)
    tokens = eng.wan_image_encoder.encode(image, hidden_states=True)
    jtokens = jtext.CLIPImageEncoder(os.path.join(root, "image_encoder")).encode(
        image, hidden_states=True)
    assert tuple(tokens.shape) == (1, IMG_TOKENS, IMG_DIM)
    diff = np.abs(tokens.float().numpy() - np.asarray(jtokens.astype(jnp.float32)))
    spacing = np.spacing(np.abs(np.asarray(jtokens.astype(jnp.float32)))) * 2.0 ** 16
    assert (diff <= spacing).all() and (diff > 0).mean() <= 2e-3
    cond = eng._wan_i2v_latents(image, 2, 4, 6, 5)
    noise = torch.randn((1, 16, 2, 4, 6), generator=torch.Generator().manual_seed(2))
    cos, sin = twan.wan_rope_cos_sin(eng.cfg, 2, 4, 6, device="cpu")
    tpos, tneg = torch.from_numpy(pos).bfloat16(), torch.from_numpy(neg).bfloat16()
    ref, _ = make_wan_denoiser(eng.cfg, TUniPC.create(3, shift=5.0), 3, 5.0)(
        eng.params, noise, tpos, tneg, cos, sin, None, cond, tokens)
    np.testing.assert_array_equal(lat, ref.numpy())
    no_image, _ = make_wan_denoiser(eng.cfg, TUniPC.create(3, shift=5.0), 3, 5.0)(
        eng.params, noise, tpos, tneg, cos, sin, None, cond)
    assert _rel_l2(no_image, ref) > 1e-2
    jcfg = jwan.WanConfig(**dataclasses.asdict(eng.cfg))
    jparams = jwan.wan_load(JSource(dict(sd)), jcfg)
    jc, js = jwan.wan_rope_cos_sin(jcfg, 2, 4, 6)
    want, _ = j_one_expert(jcfg, JUniPC.create(3, shift=5.0), 3, 5.0)(
        jparams, None, jnp.asarray(noise.numpy()), jnp.asarray(pos, jnp.bfloat16),
        jnp.asarray(neg, jnp.bfloat16), jc, js, None, jnp.asarray(cond.numpy()), jtokens)
    assert _rel_l2(lat, want) <= 2e-2, _rel_l2(lat, want)


def test_engine_wan21_i2v_refusals(tmp_path):
    """The dual expert with image tokens raises, as the JAX engine; a
    missing image_encoder/ names the directory."""
    from fastdm_tpu_torch.engine import FastDMEngine

    root = str(tmp_path)
    _write_i2v_checkpoint(root, experts=2)
    eng = FastDMEngine(root, architecture="wan2.1-i2v", verbose=False, device="cpu")
    assert eng.params_2 is not None and eng.wan_image_encoder is not None
    pos, neg = _i2v_embeds(8)
    image = np.random.default_rng(9).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=32, width=48, num_frames=5,
              num_inference_steps=2, output_type="latent")
    with pytest.raises(NotImplementedError, match="dual-expert"):
        eng.generate(task="i2v", image=image, **kw)
    import shutil

    shutil.rmtree(os.path.join(root, "image_encoder"))
    shutil.rmtree(os.path.join(root, "transformer_2"))
    eng = FastDMEngine(root, architecture="wan-i2v", verbose=False, device="cpu")
    with pytest.raises(FileNotFoundError, match="image_encoder"):
        eng.generate(task="i2v", image=image, **kw)
