"""The four radial sparse modes of the port's Wan path against the JAX
package: the table builders (RadialAttn.block_mask, block_lists,
block_lists_fine), the transformer forward in each mode, and the engine's
FASTDM_SPARSE_GATHER switch on a tiny two-expert checkpoint.

Tolerances: the tables equal JAX's bit for bit; a Wan forward runs in
bfloat16, so each mode's forward is held to relative L2 1e-2 of JAX's (as
tests/test_torch_wan.py holds the dense and superblock ones).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdm_tpu.kernels.jnp_backend.impl import sdpa_gather_jnp
from fastdm_tpu.models import wan as jwan
from fastdm_tpu.sparse.xsparse import RadialAttn as JRadialAttn
from fastdm_tpu_torch.kernels import kernel_registry
from fastdm_tpu_torch.kernels.torch_backend import sdpa_gather_torch
from fastdm_tpu_torch.models import wan as twan
from fastdm_tpu_torch.models.convert import wan_params_from_numpy
from fastdm_tpu_torch.sparse.xsparse import RadialAttn

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_wan import TINY  # noqa: E402
from test_torch_wan import RADIAL, _write_wan_checkpoint  # noqa: E402
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

TEXT = 8


def _pair(cfg: dict, tokens: int, frames: int):
    mine, theirs = RadialAttn.from_dict(cfg), JRadialAttn.from_dict(cfg)
    mine.post_init(tokens, frames)
    theirs.post_init(tokens, frames)
    return mine, theirs


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


# (tokens, frames, radial config): the A14B 17-frame video on the example
# config (partial tail block: 7800 = 60 x 128 + 120), a 64-token block
# config, and a hunyuan-type mask
SHAPES = {
    "a14b-17f": (5 * 30 * 52, 5, dict(block_size=128, decay_factor=0.3, model_type="wan")),
    "block64": (9 * 16 * 16, 9, dict(block_size=64, decay_factor=1.0, model_type="wan")),
    "hunyuan32": (8 * 12 * 20, 8, dict(block_size=32, decay_factor=0.5, model_type="hunyuan")),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_table_builders_match_jax(shape):
    tokens, frames, kw = SHAPES[shape]
    bs = kw["block_size"]
    mine, theirs = _pair(dict(sparse_algorithm="radial", **kw), tokens, frames)
    # the mask at its own granularity, OR-coarsened to 128 and 4x, repeated to bs/2
    for tile in (None, 128, 4 * bs, bs // 2):
        got = mine.block_mask(2, 3, block_tokens=tile)
        want = theirs.block_mask(2, 3, block_tokens=tile)
        assert got.shape[:2] == (2, 3) and got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    for q_tokens, k_tokens in ((4 * bs, 8 * bs), (bs, 2 * bs), (512, 1024)):
        _same(mine.block_lists(q_tokens, k_tokens), theirs.block_lists(q_tokens, k_tokens))
    for q_tokens, group in ((4 * bs, 8), (2 * bs, 3), (512, 32)):
        got = mine.block_lists_fine(q_tokens, group)
        _same(got, theirs.block_lists_fine(q_tokens, group))
    with pytest.raises(ValueError, match="multiples"):
        mine.block_lists(bs + 1, bs)
    with pytest.raises(ValueError, match="incompatible"):
        mine.block_mask(block_tokens=bs + bs // 2)


# 4 latent frames of 16x32 patches: 2048 tokens, 512 per frame, radial
# blocks of 32, so that even the mask mode's 128-token tiles keep part of the
# radial pattern (0.87 of the tiles; the other modes 0.78-0.82 of the keys)
FHW = (4, 32, 64)
TOKENS = 4 * 16 * 32
RADIAL32 = dict(RADIAL, block_size=32)
MODES = {
    "mask": {},
    "coarse": dict(sparse_gather_blocks=(64, 128)),
    "fine": dict(sparse_gather_fine_blocks=(64, 4, 32), sparse_gather_superblock=1),
    "super": dict(sparse_gather_fine_blocks=(64, 8, 32), sparse_gather_superblock=4),
}


def _mode_tables(mode: str, heads: int):
    """The mode's tables from both packages (equal), as torch and JAX operands."""
    mine, theirs = _pair(RADIAL32, TOKENS, FHW[0])
    if mode == "mask":
        t, j = (a.block_mask(1, heads, block_tokens=128) for a in (mine, theirs))
        assert np.array_equal(t, j)
        return torch.from_numpy(t), jnp.asarray(j)
    if mode == "coarse":
        t, j = (a.block_lists(*MODES[mode]["sparse_gather_blocks"]) for a in (mine, theirs))
    elif mode == "fine":
        t, j = (a.block_lists_fine(64, 4) for a in (mine, theirs))
    else:
        t, j = (a.block_lists_super(64, 2, 4) for a in (mine, theirs))
    _same(t, j)
    return tuple(torch.from_numpy(a) for a in t), tuple(jnp.asarray(a) for a in j)


@pytest.mark.parametrize("blocks", [(64, 192), (192, 320)])
def test_coarse_op_on_radial_lists_of_odd_tiles_matches_jax(blocks):
    """The coarse op on both packages' radial lists (equal) at tile sizes
    that are odd multiples of 64, as the card's coarse walk pairs the 64-key
    halves of two entries: block_k 192 or 320 leaves a ragged last KV tile of
    128 of the 2048 keys. sdpa_gather_torch (the plain version, the oracle
    of the kernel) against the JAX package's jnp oracle on the same numpy
    inputs in f32, within 1e-5 (sums in another order)."""
    bq, bk = blocks
    mine, theirs = _pair(RADIAL32, TOKENS, FHW[0])
    t, j = (a.block_lists(bq, bk) for a in (mine, theirs))
    _same(t, j)
    assert TOKENS % bk and (t[1] < t[0].shape[1]).any()  # a ragged tail; padding entries
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((1, TOKENS, 2 * 64)).astype(np.float32) for _ in range(3))
    got = sdpa_gather_torch(*(torch.from_numpy(a) for a in (q, k, v)),
                            *(torch.from_numpy(a) for a in t), 2, 2, 64, block_q=bq, block_k=bk)
    want = sdpa_gather_jnp(*(jnp.asarray(a) for a in (q, k, v)), *(jnp.asarray(a) for a in j),
                           2, 2, 64, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    common = dict(TINY, text_len=TEXT, quant="int8", dense_layers=1)
    jcfg, tcfg = jwan.WanConfig(**common), twan.WanConfig(**common)
    jparams = jwan.wan_init_random(jax.random.key(4), jcfg)
    return jcfg, jparams, tcfg, wan_params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wan_forward_in_each_mode_matches_jax(model, mode):
    """One dense layer, one sparse layer on the mode's radial tables: the
    port's op (its plain version here) against JAX's jnp oracle inside the
    model; the tables do cut attention."""
    jcfg, jparams, tcfg, tparams = model
    jcfg, tcfg = (dataclasses.replace(c, **MODES[mode]) for c in (jcfg, tcfg))
    tmask, jmask = _mode_tables(mode, tcfg.num_attention_heads)
    rng = np.random.default_rng(8)
    video = rng.standard_normal((1, TINY["in_channels"], *FHW)).astype(np.float32)
    text = rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
    args_j = (jnp.asarray(video, jnp.bfloat16), jnp.full((1,), 500.0, jnp.float32),
              jnp.asarray(text, jnp.bfloat16))
    args_t = (torch.from_numpy(video).bfloat16(), torch.full((1,), 500.0),
              torch.from_numpy(text).bfloat16())
    want = jwan.wan_forward(jparams, jcfg, *args_j, sparse_mask=jmask)
    got = twan.wan_forward(tparams, tcfg, *args_t, sparse_mask=tmask)
    dense = twan.wan_forward(tparams, tcfg, *args_t)
    rel = lambda a, b: float(np.linalg.norm(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                             / np.linalg.norm(np.asarray(b, np.float32)))  # noqa: E731
    assert rel(got.float().numpy(), want) <= 1e-2
    assert rel(got.float().numpy(), dense.float().numpy()) > 1e-3


OPS = {"mask": "sdpa_sparse", "coarse": "sdpa_gather", "fine": "sdpa_gather_fine",
       "super": "sdpa_gather_super"}


def test_engine_in_every_sparse_mode(tmp_path, monkeypatch):
    """FASTDM_SPARSE_GATHER picks the mode per generate: each mode's tables
    reach its own sparse op (and no other), with the config synced to them;
    an unknown mode is refused."""
    from fastdm_tpu_torch.engine import FastDMEngine

    _write_wan_checkpoint(str(tmp_path), vae=False)
    radial = dict(RADIAL, dense_layers=0)  # the checkpoint's blocks all take the mask
    eng = FastDMEngine(str(tmp_path), architecture="wan2.2-t2v", use_int8=True,
                       sparse_attn_config=radial, verbose=False, device="cpu")
    called = []
    select = kernel_registry.select

    def spy(op_name, device):
        called.append(op_name)
        return select(op_name, device)

    monkeypatch.setattr(kernel_registry, "select", spy)
    rng = np.random.default_rng(9)
    pos, neg = (rng.standard_normal((1, TEXT, TINY["text_dim"])).astype(np.float32)
                for _ in range(2))
    kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg, height=64, width=128,
              num_frames=9, num_inference_steps=3, guidance_scale=4.0, seed=1)
    outs = {}
    for mode in ("super", "fine", "coarse", "mask"):
        monkeypatch.setenv("FASTDM_SPARSE_GATHER", mode)
        called.clear()
        outs[mode] = eng.generate(**kw)
        assert outs[mode].shape == (1, TINY["out_channels"], 3, 8, 16)
        assert np.isfinite(outs[mode]).all()
        sparse_ops = {op for op in called if op in OPS.values()}
        assert sparse_ops == {OPS[mode]}, (mode, sparse_ops)
        fine_blocks = {"super": (256, 32, 16), "fine": (512, 32, 16)}.get(mode)
        if fine_blocks:
            assert eng.cfg.sparse_gather_fine_blocks == fine_blocks
            assert eng.cfg.sparse_gather_superblock == (4 if mode == "super" else 1)
    # every mode allows all 96 tokens of this small video: the same latents
    for mode in ("fine", "coarse", "mask"):
        np.testing.assert_allclose(outs[mode], outs["super"], rtol=0, atol=1e-5)
    monkeypatch.setenv("FASTDM_SPARSE_GATHER", "diagonal")
    with pytest.raises(ValueError, match="FASTDM_SPARSE_GATHER"):
        eng.generate(**kw)
