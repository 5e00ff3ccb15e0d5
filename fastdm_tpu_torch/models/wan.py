"""Wan2.1 / Wan2.2 transformer core (port of fastdm_tpu/models/wan.py): text-
to-video, image-to-video by channel concatenation, and Wan2.2-TI2V's
per-token timesteps.

PyTorch layout: the blocks are nn.Modules in one nn.ModuleList walked by a
Python loop; block i < cfg.dense_layers runs dense self-attention, the rest
take the sparse mask (the JAX package stacks the two groups and scans them).
The f32 islands of the JAX module are kept: the modulation, the residual adds
and norm1/norm3/norm_out run in f32, and norm2's output is cast back before
cross-attention. RoPE tables are computed on the host in float64. Two experts
(Wan2.2-A14B) are two WanTransformer instances; the denoise loop switches
between them (pipeline/denoise_wan.py).

Sparse self-attention takes any of the four forms of the radial mask
(sparse.xsparse.RadialAttn): a 3-tuple of superblock tables (block_lists_super,
cfg.sparse_gather_superblock > 1) or of fine tables (block_lists_fine,
superblock 1), a 2-tuple of coarse lists (block_lists, tiles
cfg.sparse_gather_blocks), or a (B, H, nq, nk) block mask at 128x128 tiles
(block_mask). wan_forward_cached runs the forward under FBCache or DiCache.
With cfg.per_token_timestep (Wan2.2-TI2V-5B) the timestep may be (B, S), one
per token: the modulation becomes (B, S, 6, D) and the output shift and
scale (B, S, D); a compact (B,) timestep broadcasts as (B, 1, D).

Wan2.1-I2V's image branch: the CLIP vision tower's penultimate tokens
(encoder_hidden_states_image, (B, 257, image_dim)) pass the image embedder
(an f32 LayerNorm, a bf16 linear, exact GELU, a linear and an f32 LayerNorm,
in f32 as JAX runs them; a first-last-frame checkpoint's pos_embed first)
and are placed before the text tokens; in each block's cross-attention the
first S_enc - text_len context tokens go through add_k (then norm_added_k) and
add_v, the block linears' format, and their attention is added to the text
attention inside each token chunk. A context of text_len tokens or fewer
takes the text path alone: an image checkpoint driven without an image.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.kernels import (
    gather_fine_attention,
    gather_sparse_attention,
    gather_super_attention,
    qk_norm_rope,
    qk_norm_rope2,
    rms_norm,
    scaled_dot_product_attention,
    sparse_scaled_dot_product_attention,
)
from fastdm_tpu_torch.layers.embeddings import (
    PixArtTextProjection,
    TimestepEmbedding,
    get_timestep_embedding,
    rope_1d_freqs,
)
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.layers.normalization import fp32_layer_norm
from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random, qlinear_slice_out
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Wan2.2-A14B's published transformer (Wan-AI/Wan2.2-T2V-A14B-Diffusers,
    transformer/config.json) by default, as the JAX WanConfig."""

    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    image_dim: Optional[int] = None          # Wan2.1 I2V image branch: with the image encoder
    added_kv_proj_dim: Optional[int] = None  # Wan2.1 I2V image-KV branch: the same
    text_len: int = 512                      # fixed text context length
    dense_layers: int = 0                    # the first N blocks attend densely
    # > 0: run the FFN, the output projections and the cross-attention over
    # chunks of this many tokens when it divides the sequence (exact; bounds
    # the (tokens, ffn_dim) intermediates). The engine derives it.
    ffn_chunk_tokens: int = 0
    # project q, k, v separately (column slices of the fused QKV weight, per
    # token chunk) and use the two-operand qk_norm_rope2: no (S, 3D) buffer
    split_qkv_proj: bool = False
    # (block_q, block_k) tiles of the coarse gather lists (a 2-tuple mask)
    sparse_gather_blocks: Tuple[int, int] = (512, 1024)
    # (block_q, group, fine) of the fine and superblock gather tables; fine = the radial mask's
    # block_size (the engine syncs it); group counts fine blocks, so a
    # superblock table is padded to group // superblock entries
    sparse_gather_fine_blocks: Tuple[int, int, int] = (512, 32, 64)
    # a 3-tuple sparse mask holds superblock tables of this many fine blocks
    # per entry when > 1 (gather_super_attention), fine tables when 1
    # (gather_fine_attention)
    sparse_gather_superblock: int = 1
    per_token_timestep: bool = False         # Wan2.2-TI2V: a (B, S) timestep, temb per token
    quant: Optional[str] = "int8"            # block linears: None/"bf16" | "int8" | "fp8"

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def _param(t: Optional[Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------- modules


class WanSelfAttention(nn.Module):
    """Fused q|k|v projection, full-width q/k RMSNorm weights (D,), output."""

    def __init__(self, qkv: QLinear, norm_q: Tensor, norm_k: Tensor, to_out: QLinear):
        super().__init__()
        self.qkv, self.to_out = qkv, to_out
        self.norm_q, self.norm_k = _param(norm_q), _param(norm_k)


class WanCrossAttention(nn.Module):
    """q from the video tokens, fused k|v from the text context; with
    Wan2.1-I2V's image branch also add_k, add_v and norm_added_k for the
    image context."""

    def __init__(self, q: QLinear, kv: QLinear, norm_q: Tensor, norm_k: Tensor, to_out: QLinear,
                 add_k: Optional[QLinear] = None, add_v: Optional[QLinear] = None,
                 norm_added_k: Optional[Tensor] = None):
        super().__init__()
        self.q, self.kv, self.to_out = q, kv, to_out
        self.norm_q, self.norm_k = _param(norm_q), _param(norm_k)
        self.add_k, self.add_v = add_k, add_v
        self.norm_added_k = _param(norm_added_k)


class WanImageEmbedder(nn.Module):
    """condition_embedder.image_embedder: norm1 (f32 LayerNorm, eps 1e-5),
    ff.net.0.proj and ff.net.2 (bf16 linears), norm2, and the optional
    pos_embed (1, 2 * S, image_dim) of first-last-frame checkpoints."""

    def __init__(self, norm1: Tuple[Tensor, Tensor], proj: QLinear, out: QLinear,
                 norm2: Tuple[Tensor, Tensor], pos_embed: Optional[Tensor] = None):
        super().__init__()
        self.norm1_gamma, self.norm1_beta = _param(norm1[0]), _param(norm1[1])
        self.proj, self.out = proj, out
        self.norm2_gamma, self.norm2_beta = _param(norm2[0]), _param(norm2[1])
        self.pos_embed = _param(pos_embed)


class WanBlock(nn.Module):
    def __init__(self, scale_shift_table: Tensor, attn1: WanSelfAttention,
                 attn2: WanCrossAttention, ffn: FeedForward,
                 norm2: Optional[Tuple[Tensor, Tensor]] = None):
        super().__init__()
        self.scale_shift_table = _param(scale_shift_table)  # (6, D) f32
        self.attn1, self.attn2, self.ffn = attn1, attn2, ffn
        self.norm2_gamma = _param(None if norm2 is None else norm2[0])
        self.norm2_beta = _param(None if norm2 is None else norm2[1])


class WanTransformer(nn.Module):
    """The Wan denoiser's parameters; the forward is wan_forward()."""

    def __init__(self, *, patch_embedding: QLinear, time_embedder: TimestepEmbedding,
                 time_proj: QLinear, text_embedder: PixArtTextProjection,
                 scale_shift_table: Tensor, proj_out: QLinear, blocks: List[WanBlock],
                 image_embedder: Optional[WanImageEmbedder] = None):
        super().__init__()
        self.patch_embedding = patch_embedding
        self.time_embedder, self.time_proj = time_embedder, time_proj
        self.text_embedder = text_embedder
        self.image_embedder = image_embedder
        self.scale_shift_table = _param(scale_shift_table)  # (2, D) f32
        self.proj_out = proj_out
        self.blocks = nn.ModuleList(blocks)


# ---------------------------------------------------------------- params


def wan_init_random(seed: int, cfg: WanConfig, device="cuda") -> WanTransformer:
    """Random-weight Wan transformer (benchmarks and smoke runs without
    checkpoints): every weight drawn by a torch.Generator seeded with `seed`
    on `device`, straight into its storage dtype (qlinear_random): the seven
    linears of each block in cfg.quant, the embedders and the output head in
    bf16, unit q/k norm weights, modulation tables ~ N(0, 1/D) in f32, as the
    JAX wan_init_random; with cfg.image_dim the image embedder (bf16
    linears, unit / zero f32 norms), with cfg.added_kv_proj_dim each block's
    add_k / add_v in cfg.quant and a unit norm_added_k. The JAX and torch
    generators give different numbers for the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, q = cfg.inner_dim, cfg.quant

    def lin(k, n, quant=None):
        return qlinear_random(gen, k, n, quant=quant, device=dev)

    def table(rows):
        return torch.randn(rows, d, generator=gen, device=dev) / d**0.5

    def ones(dtype=torch.bfloat16):
        return torch.ones(d, dtype=dtype, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        norm2 = (ones(torch.float32), torch.zeros(d, device=dev)) if cfg.cross_attn_norm else None
        added = {}
        if cfg.added_kv_proj_dim is not None:
            added = dict(add_k=lin(cfg.added_kv_proj_dim, d, q),
                         add_v=lin(cfg.added_kv_proj_dim, d, q), norm_added_k=ones())
        blocks.append(WanBlock(
            table(6),
            WanSelfAttention(lin(d, 3 * d, q), ones(), ones(), lin(d, d, q)),
            WanCrossAttention(lin(d, d, q), lin(d, 2 * d, q), ones(), ones(), lin(d, d, q),
                              **added),
            FeedForward(lin(d, cfg.ffn_dim, q), lin(cfg.ffn_dim, d, q)), norm2))
    image_embedder = None
    if cfg.image_dim is not None:
        e = cfg.image_dim
        image_embedder = WanImageEmbedder(
            (torch.ones(e, device=dev), torch.zeros(e, device=dev)), lin(e, e), lin(e, d),
            (torch.ones(d, device=dev), torch.zeros(d, device=dev)))
    return WanTransformer(
        patch_embedding=lin(cfg.in_channels * math.prod(cfg.patch_size), d),
        time_embedder=TimestepEmbedding(lin(cfg.freq_dim, d), lin(d, d)),
        time_proj=lin(d, 6 * d),
        text_embedder=PixArtTextProjection(lin(cfg.text_dim, d), lin(d, d)),
        scale_shift_table=table(2),
        proj_out=lin(d, cfg.out_channels * math.prod(cfg.patch_size)),
        blocks=blocks, image_embedder=image_embedder)


def wan_load(src: TensorSource, cfg: WanConfig) -> WanTransformer:
    """Load a diffusers Wan transformer checkpoint onto src.device (port of
    the JAX wan_load): the conv3d patch embedding becomes a (C*pt*ph*pw, D)
    bf16 linear, attn1 q|k|v and attn2 k|v are fused, the block linears are
    quantized to cfg.quant, Wan2.1-I2V's add_k / add_v too; the image
    embedder (and its pos_embed) loads when the checkpoint holds one."""
    q = cfg.quant
    conv_w = src.tensor("patch_embedding.weight", torch.float32)  # (D, C, pt, ph, pw)
    # patch vector order (C, pt, ph, pw) matches wan_patchify
    patch_w = conv_w.reshape(conv_w.shape[0], -1).t().to(torch.bfloat16).contiguous()
    blocks = []
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        norm2 = None
        if cfg.cross_attn_norm:
            norm2 = (src.tensor(f"{p}.norm2.weight", torch.float32),
                     src.tensor(f"{p}.norm2.bias", torch.float32))
        added = {}
        if f"{p}.attn2.add_k_proj.weight" in src:
            added = dict(add_k=src.linear(f"{p}.attn2.add_k_proj", q),
                         add_v=src.linear(f"{p}.attn2.add_v_proj", q),
                         norm_added_k=src.tensor(f"{p}.attn2.norm_added_k.weight"))
        blocks.append(WanBlock(
            src.tensor(f"{p}.scale_shift_table", torch.float32).reshape(6, -1),
            WanSelfAttention(
                src.fused_linear([f"{p}.attn1.to_q", f"{p}.attn1.to_k", f"{p}.attn1.to_v"], q),
                src.tensor(f"{p}.attn1.norm_q.weight"), src.tensor(f"{p}.attn1.norm_k.weight"),
                src.linear(f"{p}.attn1.to_out.0", q)),
            WanCrossAttention(
                src.linear(f"{p}.attn2.to_q", q),
                src.fused_linear([f"{p}.attn2.to_k", f"{p}.attn2.to_v"], q),
                src.tensor(f"{p}.attn2.norm_q.weight"), src.tensor(f"{p}.attn2.norm_k.weight"),
                src.linear(f"{p}.attn2.to_out.0", q), **added),
            FeedForward(src.linear(f"{p}.ffn.net.0.proj", q), src.linear(f"{p}.ffn.net.2", q)),
            norm2))
    ce = "condition_embedder"
    image_embedder = None
    ie = f"{ce}.image_embedder"
    if f"{ie}.norm1.weight" in src:
        image_embedder = WanImageEmbedder(
            (src.tensor(f"{ie}.norm1.weight", torch.float32),
             src.tensor(f"{ie}.norm1.bias", torch.float32)),
            src.linear(f"{ie}.ff.net.0.proj", None), src.linear(f"{ie}.ff.net.2", None),
            (src.tensor(f"{ie}.norm2.weight", torch.float32),
             src.tensor(f"{ie}.norm2.bias", torch.float32)),
            src.tensor(f"{ie}.pos_embed") if f"{ie}.pos_embed" in src else None)
    model = WanTransformer(
        patch_embedding=QLinear(patch_w, src.tensor("patch_embedding.bias")),
        time_embedder=TimestepEmbedding(src.linear(f"{ce}.time_embedder.linear_1", None),
                                        src.linear(f"{ce}.time_embedder.linear_2", None)),
        time_proj=src.linear(f"{ce}.time_proj", None),
        text_embedder=PixArtTextProjection(src.linear(f"{ce}.text_embedder.linear_1", None),
                                           src.linear(f"{ce}.text_embedder.linear_2", None)),
        scale_shift_table=src.tensor("scale_shift_table", torch.float32).reshape(2, -1),
        proj_out=src.linear("proj_out", None),
        blocks=blocks, image_embedder=image_embedder)
    src.assert_consumed()
    return model


# ---------------------------------------------------------------- forward


def _chunks(s: int, ct: int):
    """Token ranges of the chunked path, or None when chunking is off or
    does not divide s (the JAX module's rule)."""
    if ct and s > ct and s % ct == 0:
        return [(i, i + ct) for i in range(0, s, ct)]
    return None


def _wan_self_attention(attn: WanSelfAttention, x: Tensor, cos: Tensor, sin: Tensor,
                        cfg: WanConfig, sparse_mask) -> Tensor:
    d, hd = cfg.inner_dim, cfg.attention_head_dim
    if cfg.split_qkv_proj:
        # three column-sliced projections, per token chunk, and the
        # two-operand norm+rope: no (S, 3D) buffer exists
        qp, kp, vp = (qlinear_slice_out(attn.qkv, i * d, (i + 1) * d) for i in range(3))
        ranges = _chunks(x.shape[1], cfg.ffn_chunk_tokens) or [(0, x.shape[1])]
        qs, ks, vs = [], [], []
        for lo, hi in ranges:
            xc = x[:, lo:hi]
            qc, kc = qk_norm_rope2(qp(xc), kp(xc), attn.norm_q, attn.norm_k, hd, cos[lo:hi],
                                   sin[lo:hi], False, cfg.eps)
            qs.append(qc)
            ks.append(kc)
            vs.append(vp(xc))
        q, k, v = (t[0] if len(t) == 1 else torch.cat(t, dim=1) for t in (qs, ks, vs))
    else:
        qkv = attn.qkv(x)
        # q and k are normalized and rotated straight out of the fused
        # projection; v stays a strided view of it
        q, k = qk_norm_rope(qkv, attn.norm_q, attn.norm_k, hd, cos, sin, False, cfg.eps,
                            inner_dim=d)
        v = qkv[..., 2 * d:]
    return _wan_self_attention_core(attn, x, q, k, v, cfg, sparse_mask)


def _wan_self_attention_core(attn: WanSelfAttention, x: Tensor, q: Tensor, k: Tensor,
                             v: Tensor, cfg: WanConfig, sparse_mask) -> Tensor:
    h, hd = cfg.num_attention_heads, cfg.attention_head_dim
    if sparse_mask is None:
        out = scaled_dot_product_attention(q, k, v, h, h, hd, False, hd**-0.5)
    elif isinstance(sparse_mask, (tuple, list)) and len(sparse_mask) == 3:
        idx, val, rows = sparse_mask
        bq, grp, fine = cfg.sparse_gather_fine_blocks
        sb = cfg.sparse_gather_superblock
        if sb > 1:
            out = gather_super_attention(q, k, v, idx, val, rows, h, h, hd, scale=hd**-0.5,
                                         block_q=bq, group=max(1, grp // sb), fine=fine,
                                         superblock=sb)
        else:
            out = gather_fine_attention(q, k, v, idx, val, rows, h, h, hd, scale=hd**-0.5,
                                        block_q=bq, group=grp, fine=fine)
    elif isinstance(sparse_mask, (tuple, list)):
        idx, cnt = sparse_mask
        bq, bk = cfg.sparse_gather_blocks
        out = gather_sparse_attention(q, k, v, idx, cnt, h, h, hd, scale=hd**-0.5, block_q=bq,
                                      block_k=bk)
    else:
        out = sparse_scaled_dot_product_attention(q, k, v, h, h, hd, False, hd**-0.5,
                                                  sparse_mask=sparse_mask, block_q=128,
                                                  block_k=128)
    return attn.to_out(out.to(x.dtype), chunk_tokens=cfg.ffn_chunk_tokens)


def _wan_cross_attention(attn: WanCrossAttention, x: Tensor, encoder: Tensor,
                         cfg: WanConfig) -> Tensor:
    """Text cross-attention; with add_k and a context longer than text_len
    (fastdm_tpu/models/wan.py:355-360: a shorter one would give the image
    softmax no keys) the first S_enc - text_len tokens are image context,
    whose attention is added to the text attention."""
    d, h, hd = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim
    ct = cfg.ffn_chunk_tokens
    ctx_img, ctx_txt = None, encoder
    if attn.add_k is not None and encoder.shape[1] > cfg.text_len:
        img_len = encoder.shape[1] - cfg.text_len
        ctx_img, ctx_txt = encoder[:, :img_len], encoder[:, img_len:]
    q = rms_norm(attn.q(x, chunk_tokens=ct), attn.norm_q, cfg.eps)
    kv = attn.kv(ctx_txt)
    k = rms_norm(kv[..., :d], attn.norm_k, cfg.eps)
    v = kv[..., d:]
    k_img = v_img = None
    if ctx_img is not None:
        k_img = rms_norm(attn.add_k(ctx_img), attn.norm_added_k, cfg.eps)
        v_img = attn.add_v(ctx_img)

    def xattn(qc):
        o = scaled_dot_product_attention(qc, k, v, h, h, hd, False, hd**-0.5)
        if k_img is not None:
            o = o + scaled_dot_product_attention(qc, k_img, v_img, h, h, hd, False, hd**-0.5)
        return o

    ranges = _chunks(q.shape[1], ct)
    if ranges is None:
        out = xattn(q)
    else:  # rows are independent: the context is the same for every chunk
        out = torch.cat([xattn(q[:, lo:hi]) for lo, hi in ranges], dim=1)
    return attn.to_out(out.to(x.dtype), chunk_tokens=ct)


def wan_block(block: WanBlock, hidden: Tensor, encoder: Tensor, temb6: Tensor, cos: Tensor,
              sin: Tensor, cfg: WanConfig, sparse_mask) -> Tensor:
    """temb6: (B, 6, D), or (B, S, 6, D) with cfg.per_token_timestep (S may be
    1: a compact timestep); the modulation and the residual adds in f32."""
    mod = block.scale_shift_table[None] + temb6.float()
    if cfg.per_token_timestep:  # six (B, S, D)
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = (
            mod[..., i, :] for i in range(6))
    else:
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = (
            mod[:, i][:, None] for i in range(6))
    dt = hidden.dtype

    h32 = fp32_layer_norm(hidden, eps=cfg.eps)
    norm_h = (h32 * (1 + scale_msa) + shift_msa).to(dt)
    attn_out = _wan_self_attention(block.attn1, norm_h, cos, sin, cfg, sparse_mask)
    hidden = (hidden.float() + attn_out.float() * gate_msa).to(dt)

    if block.norm2_gamma is not None:
        # cast back before cross-attention, unlike norm1/norm3/norm_out
        norm_h = fp32_layer_norm(hidden, block.norm2_gamma, block.norm2_beta, cfg.eps).to(dt)
    else:
        norm_h = hidden
    hidden = hidden + _wan_cross_attention(block.attn2, norm_h, encoder, cfg)

    h32 = fp32_layer_norm(hidden, eps=cfg.eps)
    norm_h = (h32 * (1 + c_scale) + c_shift).to(dt)
    ff_out = block.ffn(norm_h, "gelu-approximate", chunk_tokens=cfg.ffn_chunk_tokens)
    return (hidden.float() + ff_out.float() * c_gate).to(dt)


def wan_run_blocks(params: WanTransformer, cfg: WanConfig, hidden: Tensor, encoder: Tensor,
                   temb6: Tensor, cos: Tensor, sin: Tensor, sparse_mask=None,
                   start_block: int = 0, end_block: Optional[int] = None) -> Tensor:
    """Blocks [start_block, end_block) in order (all by default); blocks
    below cfg.dense_layers ignore the mask."""
    for i in range(start_block, len(params.blocks) if end_block is None else end_block):
        mask = None if i < cfg.dense_layers else sparse_mask
        hidden = wan_block(params.blocks[i], hidden, encoder, temb6, cos, sin, cfg, mask)
    return hidden


def wan_patchify(params: WanTransformer, cfg: WanConfig, video: Tensor) -> Tensor:
    """(B, C, F, H, W) -> (B, N, D) patch tokens: the conv3d as a per-patch
    matmul on (C, pt, ph, pw)-ordered patch vectors."""
    b, c, f, h, w = video.shape
    pt, ph, pw = cfg.patch_size
    x = video.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    x = x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)
    return params.patch_embedding(x.to(torch.bfloat16))


def wan_unpatchify(cfg: WanConfig, tokens: Tensor, f: int, h: int, w: int) -> Tensor:
    """(B, N, C*prod(p)) -> (B, C, F, H, W)."""
    b = tokens.shape[0]
    pt, ph, pw = cfg.patch_size
    x = tokens.reshape(b, f // pt, h // ph, w // pw, pt, ph, pw, cfg.out_channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, cfg.out_channels, f, h, w)


def wan_condition(params: WanTransformer, cfg: WanConfig, timestep: Tensor,
                  encoder_text: Tensor, encoder_image: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (temb (N, D), temb6 (N, 6D), encoder (B, S_img + S_txt, D)); the
    timestep is flattened: N = B, or B*S for a per-token (B, S) timestep.
    encoder_image, CLIP image tokens (B, S_img, image_dim), goes through the
    image embedder in f32 (its bf16 linears take the f32 LayerNorm output,
    as JAX's) and is placed before the text tokens."""
    t_proj = get_timestep_embedding(timestep.reshape(-1).float(), cfg.freq_dim,
                                    flip_sin_to_cos=True, downscale_freq_shift=0.0)
    temb = params.time_embedder(t_proj.float()).to(encoder_text.dtype)
    t6 = params.time_proj(F.silu(temb))
    encoder = params.text_embedder(encoder_text)
    if encoder_image is not None:
        ie = params.image_embedder
        if ie is None:
            raise ValueError("encoder_hidden_states_image needs a Wan transformer with the "
                             "image embedder (image_dim in its config)")
        x = encoder_image
        if ie.pos_embed is not None:  # first-last-frame: the two images' tokens in one row
            x = x.reshape(-1, 2 * x.shape[1], x.shape[2]) + ie.pos_embed
        x = fp32_layer_norm(x, ie.norm1_gamma, ie.norm1_beta, 1e-5)
        x = F.gelu(ie.proj(x))
        x = fp32_layer_norm(ie.out(x), ie.norm2_gamma, ie.norm2_beta, 1e-5)
        encoder = torch.cat([x.to(encoder.dtype), encoder], dim=1)
    return temb, t6, encoder


def _wan_embed(params: WanTransformer, cfg: WanConfig, hidden_states: Tensor, timestep: Tensor,
               encoder_hidden_states: Tensor, encoder_hidden_states_image, rope_cos, rope_sin):
    """The preamble the plain and cached forwards share: RoPE tables (when
    not given), patchify, conditioning -> (hidden, temb, temb6, encoder, cos,
    sin); temb6 is (B, 6, D), or (B, S, 6, D) and temb (B, S, D) with
    cfg.per_token_timestep (S = 1 for a compact timestep)."""
    b, _, f, h, w = hidden_states.shape
    if rope_cos is None:
        rope_cos, rope_sin = wan_rope_cos_sin(cfg, f, h, w, device=hidden_states.device)
    hidden = wan_patchify(params, cfg, hidden_states)
    temb, t6, encoder = wan_condition(params, cfg, timestep, encoder_hidden_states,
                                      encoder_hidden_states_image)
    if cfg.per_token_timestep:
        return (hidden, temb.reshape(b, -1, cfg.inner_dim), t6.reshape(b, -1, 6, cfg.inner_dim),
                encoder, rope_cos, rope_sin)
    return hidden, temb, t6.reshape(b, 6, cfg.inner_dim), encoder, rope_cos, rope_sin


def _wan_output(params: WanTransformer, cfg: WanConfig, hidden: Tensor, temb: Tensor,
                fhw) -> Tensor:
    """Output modulation (norm_out stays f32 through it; per token with
    cfg.per_token_timestep), projection, unpatchify."""
    if cfg.per_token_timestep:
        mod = params.scale_shift_table[None, None] + temb.float()[:, :, None, :]
        shift, scale = mod[:, :, 0], mod[:, :, 1]
    else:
        mod = params.scale_shift_table[None] + temb.float()[:, None, :]
        shift, scale = mod[:, 0][:, None], mod[:, 1][:, None]
    h32 = fp32_layer_norm(hidden, eps=cfg.eps)
    hidden = (h32 * (1 + scale) + shift).to(hidden.dtype)
    return wan_unpatchify(cfg, params.proj_out(hidden), *fhw)


def wan_forward(
    params: WanTransformer, cfg: WanConfig,
    hidden_states: Tensor,          # (B, C, F, H, W) video latent
    timestep: Tensor,               # (B,) or per token (B, S), in units of sigma * 1000
    encoder_hidden_states: Tensor,  # (B, text_len, text_dim)
    encoder_hidden_states_image: Optional[Tensor] = None,
    rope_cos: Optional[Tensor] = None,
    rope_sin: Optional[Tensor] = None,
    sparse_mask=None,
) -> Tensor:
    """Denoiser forward -> (B, C_out, F, H, W)."""
    hidden, temb, t6, encoder, cos, sin = _wan_embed(
        params, cfg, hidden_states, timestep, encoder_hidden_states,
        encoder_hidden_states_image, rope_cos, rope_sin)
    hidden = wan_run_blocks(params, cfg, hidden, encoder, t6, cos, sin, sparse_mask)
    return _wan_output(params, cfg, hidden, temb, hidden_states.shape[2:])


def wan_forward_cached(
    params: WanTransformer, cfg: WanConfig, cache_cfg, cache_state, step: int,
    total_steps: int, hidden_states: Tensor, timestep: Tensor, encoder_hidden_states: Tensor,
    encoder_hidden_states_image: Optional[Tensor] = None, rope_cos: Optional[Tensor] = None,
    rope_sin: Optional[Tensor] = None, sparse_mask=None,
):
    """wan_forward under FBCache or DiCache (caching/xcaching.py cached_run)
    -> (output, new cache state). The probe is the output of the first block
    (FBCache) or of the first probe_depth blocks (DiCache); the rest of the
    blocks run only on a computed step. Dense layers take no mask in either
    part."""
    from fastdm_tpu_torch.caching.config import DiCacheConfig, FBCacheConfig
    from fastdm_tpu_torch.caching.xcaching import cached_run

    if not isinstance(cache_cfg, (FBCacheConfig, DiCacheConfig)):
        raise ValueError(f"Wan caching supports FBCache / DiCache, got {type(cache_cfg).__name__}")
    hidden, temb, t6, encoder, cos, sin = _wan_embed(
        params, cfg, hidden_states, timestep, encoder_hidden_states,
        encoder_hidden_states_image, rope_cos, rope_sin)
    depth = 1 if isinstance(cache_cfg, FBCacheConfig) else cache_cfg.probe_depth

    def probe_fn(hh, ee):
        hh = wan_run_blocks(params, cfg, hh, ee, t6, cos, sin, sparse_mask, end_block=depth)
        return hh, (hh, ee)

    def rest_fn(hh, ee):
        return wan_run_blocks(params, cfg, hh, ee, t6, cos, sin, sparse_mask, start_block=depth)

    hidden, new_state = cached_run(cache_cfg, cache_state, step, total_steps, hidden, encoder,
                                   probe_fn, rest_fn)
    return _wan_output(params, cfg, hidden, temb, hidden_states.shape[2:]), new_state


# ---------------------------------------------------------------- rope


def wan_rope_cos_sin(cfg: WanConfig, f: int, h: int, w: int,
                     device="cuda") -> Tuple[Tensor, Tensor]:
    """3D RoPE tables (port of the JAX wan_rope_cos_sin): head_dim splits into
    h_dim = w_dim = 2*(d//6) and t_dim = d - h_dim - w_dim, per-pair angles
    concatenated (t, h, w) in float64 on the host; returns (cos, sin), each
    (N, d/2) float32 on `device`."""
    d = cfg.attention_head_dim
    pt, ph, pw = cfg.patch_size
    pf, phh, pww = f // pt, h // ph, w // pw
    h_dim = w_dim = 2 * (d // 6)
    t_dim = d - h_dim - w_dim
    at = rope_1d_freqs(t_dim, np.arange(pf))
    ah = rope_1d_freqs(h_dim, np.arange(phh))
    aw = rope_1d_freqs(w_dim, np.arange(pww))
    a = np.concatenate([
        np.broadcast_to(at[:, None, None, :], (pf, phh, pww, at.shape[-1])),
        np.broadcast_to(ah[None, :, None, :], (pf, phh, pww, ah.shape[-1])),
        np.broadcast_to(aw[None, None, :, :], (pf, phh, pww, aw.shape[-1])),
    ], axis=-1).reshape(pf * phh * pww, -1)
    dev = resolve_device(device)
    return (torch.from_numpy(np.cos(a).astype(np.float32)).to(dev),
            torch.from_numpy(np.sin(a).astype(np.float32)).to(dev))
