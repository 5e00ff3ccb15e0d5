"""SD3.5 MMDiT transformer core (port of fastdm_tpu/models/sd35.py).

PyTorch layout: the 24 joint blocks of SD3.5-medium are heterogeneous
(blocks 0-12 dual-attention, 13-22 standard, 23 context_pre_only); they are
kept as the JAX package groups them, in three segments: the dual blocks and
the standard blocks in two nn.ModuleLists (either may be empty: SD3.0 and
SD3.5-large have no dual blocks), walked by a Python loop in place of
lax.scan, and the last block. Patchify is a reshape and a linear (a stride-p
conv is a per-patch linear). The cropped 2D sin-cos position table is built
on the host once per resolution.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.attention import JointAttention, attention_apply
from fastdm_tpu_torch.layers.embeddings import (
    CombinedTimestepTextProj,
    TimestepEmbedding,
    sincos_pos_embed_2d,
)
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.layers.normalization import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    SD35AdaLayerNormZeroX,
    layer_norm,
)
from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SD3Config:
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 384
    num_dual_layers: int = 13  # layers [0, 13) use dual attention (SD3.5-medium)
    quant: Optional[str] = "int8"  # None/"bf16" | "int8" | "fp8" | "int4" | "int4p", as JAX

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


# ---------------------------------------------------------------- modules


class SD3JointBlock(nn.Module):
    """One joint block (forward = the port of sd3_joint_block) in one of three
    forms: dual (attn2 and the 9-chunk norm1), standard, and last
    (context_pre_only: norm1_context is an AdaLayerNormContinuous, no
    to_add_out and no ff_context; the context still gives q, k and v)."""

    def __init__(self, norm1: nn.Module, norm1_context: nn.Module, attn: JointAttention,
                 ff: FeedForward, attn2: Optional[JointAttention] = None,
                 ff_context: Optional[FeedForward] = None):
        super().__init__()
        self.norm1, self.norm1_context = norm1, norm1_context
        self.attn, self.attn2 = attn, attn2
        self.ff, self.ff_context = ff, ff_context

    @property
    def dual(self) -> bool:
        return self.attn2 is not None

    @property
    def last(self) -> bool:
        return self.ff_context is None

    def forward(self, hidden: Tensor, encoder: Tensor, temb: Tensor,
                cfg: SD3Config) -> Tuple[Tensor, Optional[Tensor]]:
        heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
        if self.dual:
            (h_norm, gate_msa, shift_mlp, scale_mlp, gate_mlp, h_norm2,
             gate_msa2) = self.norm1(hidden, temb)
        else:
            h_norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden, temb)
        if self.last:
            e_norm = self.norm1_context(encoder, temb)
        else:
            e_norm, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
                encoder, temb)

        attn_out, ctx_attn_out = attention_apply(
            self.attn, h_norm, e_norm, heads=heads, head_dim=hd, context_pre_only=self.last)
        hidden = hidden + gate_msa[:, None] * attn_out
        if self.dual:
            attn2_out = attention_apply(self.attn2, h_norm2, None, heads=heads, head_dim=hd)
            hidden = hidden + gate_msa2[:, None] * attn2_out

        h2 = layer_norm(hidden) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        hidden = hidden + gate_mlp[:, None] * self.ff(h2, "gelu-approximate")
        if self.last:
            return hidden, None
        encoder = encoder + c_gate_msa[:, None] * ctx_attn_out
        e2 = layer_norm(encoder) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        encoder = encoder + c_gate_mlp[:, None] * self.ff_context(e2, "gelu-approximate")
        return hidden, encoder


class SD3Transformer(nn.Module):
    """The SD3 denoiser's parameters; the forward is sd3_forward().
    pos_embed_table: the checkpoint's (1, max*max, D) f32 sin-cos table, or
    None (a random init: sd3_cropped_pos_embed computes it)."""

    def __init__(self, *, patch_proj: QLinear, time_text_embed: CombinedTimestepTextProj,
                 context_embedder: QLinear, dual_blocks: List[SD3JointBlock],
                 std_blocks: List[SD3JointBlock], last_block: SD3JointBlock,
                 norm_out: AdaLayerNormContinuous, proj_out: QLinear,
                 pos_embed_table: Optional[Tensor] = None):
        super().__init__()
        self.patch_proj = patch_proj
        self.time_text_embed = time_text_embed
        self.context_embedder = context_embedder
        self.dual_blocks = nn.ModuleList(dual_blocks)
        self.std_blocks = nn.ModuleList(std_blocks)
        self.last_block = last_block
        self.norm_out, self.proj_out = norm_out, proj_out
        self.pos_embed_table = (None if pos_embed_table is None
                                else nn.Parameter(pos_embed_table, requires_grad=False))


# ---------------------------------------------------------------- params


def _sd3_block(lin, ones, cfg: SD3Config, *, dual: bool, last: bool) -> SD3JointBlock:
    """A joint block from lin(k, n, quant) and ones() (the q/k norm weights),
    in the formats of the JAX _joint_block_random: the block linears in
    cfg.quant, norm1 and norm1_context in bf16."""
    d, q = cfg.inner_dim, cfg.quant
    norm1 = SD35AdaLayerNormZeroX if dual else AdaLayerNormZero
    attn = JointAttention(
        qkv=lin(d, 3 * d, q), to_out=lin(d, d, q), add_qkv=lin(d, 3 * d, q),
        to_add_out=None if last else lin(d, d, q), norm_q=ones(), norm_k=ones(),
        norm_added_q=ones(), norm_added_k=ones())
    return SD3JointBlock(
        norm1(lin(d, (9 if dual else 6) * d, None)),
        AdaLayerNormContinuous(lin(d, 2 * d, None)) if last
        else AdaLayerNormZero(lin(d, 6 * d, None)),
        attn, FeedForward(lin(d, 4 * d, q), lin(4 * d, d, q)),
        attn2=JointAttention(qkv=lin(d, 3 * d, q), to_out=lin(d, d, q), norm_q=ones(),
                             norm_k=ones()) if dual else None,
        ff_context=None if last else FeedForward(lin(d, 4 * d, q), lin(4 * d, d, q)))


def sd3_init_random(seed: int, cfg: SD3Config, device="cuda") -> SD3Transformer:
    """Random-weight SD3 (benchmarks and smoke runs without checkpoints):
    every weight drawn by a torch.Generator seeded with `seed`, on `device`,
    straight into its storage dtype (qlinear_random; unit q/k norm weights),
    as the JAX sd3_init_random: the block linears, norm_out and proj_out in
    cfg.quant, the block AdaLN modulations, patch_proj, context_embedder and
    the time/text embedders in bf16; no position table (it is computed). The
    JAX and torch generators give different numbers for the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, q, p = cfg.inner_dim, cfg.quant, cfg.patch_size

    def lin(k, n, quant=None):
        return qlinear_random(gen, k, n, quant=quant, device=dev)

    def ones():
        return torch.ones(cfg.attention_head_dim, dtype=torch.bfloat16, device=dev)

    tte = CombinedTimestepTextProj(TimestepEmbedding(lin(256, d), lin(d, d)),
                                   TimestepEmbedding(lin(cfg.pooled_projection_dim, d),
                                                     lin(d, d)))
    nd = cfg.num_dual_layers
    return SD3Transformer(
        patch_proj=lin(cfg.in_channels * p * p, d), time_text_embed=tte,
        context_embedder=lin(cfg.joint_attention_dim, cfg.caption_projection_dim),
        dual_blocks=[_sd3_block(lin, ones, cfg, dual=True, last=False) for _ in range(nd)],
        std_blocks=[_sd3_block(lin, ones, cfg, dual=False, last=False)
                    for _ in range(nd, cfg.num_layers - 1)],
        last_block=_sd3_block(lin, ones, cfg, dual=False, last=True),
        norm_out=AdaLayerNormContinuous(lin(d, 2 * d, q)),
        proj_out=lin(d, p * p * cfg.out_channels, q))


def _load_attn(src: TensorSource, p: str, q, *, with_context: bool,
               context_pre_only: bool) -> JointAttention:
    kw = {}
    if with_context:  # the context gives q, k and v in every block, the last one too
        kw = dict(add_qkv=src.fused_linear([f"{p}.add_q_proj", f"{p}.add_k_proj",
                                            f"{p}.add_v_proj"], q),
                  to_add_out=None if context_pre_only else src.linear(f"{p}.to_add_out", q),
                  norm_added_q=src.tensor(f"{p}.norm_added_q.weight"),
                  norm_added_k=src.tensor(f"{p}.norm_added_k.weight"))
    return JointAttention(qkv=src.fused_linear([f"{p}.to_q", f"{p}.to_k", f"{p}.to_v"], q),
                          to_out=src.linear(f"{p}.to_out.0", q),
                          norm_q=src.tensor(f"{p}.norm_q.weight"),
                          norm_k=src.tensor(f"{p}.norm_k.weight"), **kw)


def sd3_load(src: TensorSource, cfg: SD3Config) -> SD3Transformer:
    """Load a diffusers SD3 / SD3.5 transformer checkpoint onto src.device as
    the JAX sd3_load does: the patch conv (D, C, p, p) becomes a (C*p*p, D)
    bf16 linear in JAX's order, pos_embed.pos_embed is kept in f32, the block
    linears, norm_out and proj_out are quantized to cfg.quant. Every tensor
    must be claimed."""
    q = cfg.quant
    conv_w = src.tensor("pos_embed.proj.weight", torch.float32)  # (D, C, p, p)
    patch_proj = QLinear(conv_w.reshape(conv_w.shape[0], -1).t().to(torch.bfloat16).contiguous(),
                         src.tensor("pos_embed.proj.bias"))

    def mlp_embed(p):
        return TimestepEmbedding(src.linear(f"{p}.linear_1", None),
                                 src.linear(f"{p}.linear_2", None))

    def block(i, dual, last):
        p = f"transformer_blocks.{i}"
        d1 = src.linear(f"{p}.norm1.linear", None)
        dc = src.linear(f"{p}.norm1_context.linear", None)
        return SD3JointBlock(
            SD35AdaLayerNormZeroX(d1) if dual else AdaLayerNormZero(d1),
            AdaLayerNormContinuous(dc) if last else AdaLayerNormZero(dc),
            _load_attn(src, f"{p}.attn", q, with_context=True, context_pre_only=last),
            FeedForward(src.linear(f"{p}.ff.net.0.proj", q), src.linear(f"{p}.ff.net.2", q)),
            attn2=_load_attn(src, f"{p}.attn2", q, with_context=False, context_pre_only=False)
            if dual else None,
            ff_context=None if last else FeedForward(
                src.linear(f"{p}.ff_context.net.0.proj", q),
                src.linear(f"{p}.ff_context.net.2", q)))

    nd = cfg.num_dual_layers
    model = SD3Transformer(
        patch_proj=patch_proj,
        pos_embed_table=src.tensor("pos_embed.pos_embed", torch.float32),
        time_text_embed=CombinedTimestepTextProj(
            mlp_embed("time_text_embed.timestep_embedder"),
            mlp_embed("time_text_embed.text_embedder")),
        context_embedder=src.linear("context_embedder", None),
        norm_out=AdaLayerNormContinuous(src.linear("norm_out.linear", q)),
        proj_out=src.linear("proj_out", q),
        dual_blocks=[block(i, True, False) for i in range(nd)],
        std_blocks=[block(i, False, False) for i in range(nd, cfg.num_layers - 1)],
        last_block=block(cfg.num_layers - 1, False, True))
    src.assert_consumed()
    return model


# ---------------------------------------------------------------- forward


def sd3_patchify(params: SD3Transformer, cfg: SD3Config, latent: Tensor,
                 pos_embed: Tensor) -> Tensor:
    """(B, C, H, W) -> (B, N, D) patch tokens plus the cropped position
    table, added in f32 and rounded once."""
    b, c, h, w = latent.shape
    p = cfg.patch_size
    x = latent.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    x = params.patch_proj(x.reshape(b, (h // p) * (w // p), c * p * p).to(torch.bfloat16))
    return (x.float() + pos_embed.float()).to(x.dtype)


def sd3_cropped_pos_embed(cfg: SD3Config, table: Optional[Tensor], h: int, w: int,
                          device="cuda") -> Tensor:
    """The (1, (h/p) * (w/p), D) f32 centre crop of the (max, max, D) sin-cos
    table for an h x w latent. Without a table (random weights) the full
    table is computed on the host in float64, as JAX does: at SD3.5's 384 x
    384 x 1536 that is 1.8 GB of float64 and seconds of host time, so callers
    build the crop once per resolution."""
    m = cfg.pos_embed_max_size
    ht, wt = h // cfg.patch_size, w // cfg.patch_size
    top, left = (m - ht) // 2, (m - wt) // 2
    if table is None:
        base = cfg.sample_size // cfg.patch_size
        full = sincos_pos_embed_2d(cfg.inner_dim, m, m, base_size=base).reshape(m, m, -1)
        crop = np.ascontiguousarray(full[top:top + ht, left:left + wt], dtype=np.float32)
        return torch.from_numpy(crop).reshape(1, ht * wt, -1).to(resolve_device(device))
    t = table.float().reshape(m, m, -1)
    return t[top:top + ht, left:left + wt].reshape(1, ht * wt, -1).to(table.device)


def _sd3_embed(params: SD3Transformer, cfg: SD3Config, hidden_states, encoder_hidden_states,
               pooled_projections, timestep, pos_embed):
    """Patch tokens, the combined time-text embedding and the context
    projection (shared by the cached and uncached forwards)."""
    hidden = sd3_patchify(params, cfg, hidden_states, pos_embed)
    temb = params.time_text_embed(timestep.float(), pooled_projections)
    encoder = params.context_embedder(encoder_hidden_states)
    return hidden, temb, encoder


def _sd3_output(params: SD3Transformer, cfg: SD3Config, hidden, temb, b, h, w) -> Tensor:
    """Output modulation, projection and unpatchify (nhwpqc -> nchpwq)."""
    hidden = params.proj_out(params.norm_out(hidden, temb))
    p = cfg.patch_size
    ht, wt = h // p, w // p
    x = hidden.reshape(b, ht, wt, p, p, cfg.out_channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, cfg.out_channels, ht * p, wt * p)


def _run_segment(blocks, cfg, hidden, encoder, temb, cn=None, start: int = 0):
    """blocks[start:], each followed by its ControlNet residual when given."""
    for i in range(start, len(blocks)):
        hidden, encoder = blocks[i](hidden, encoder, temb, cfg)
        if cn is not None:
            hidden = hidden + cn[i]
    return hidden, encoder


def sd3_run_blocks(params: SD3Transformer, cfg: SD3Config, hidden: Tensor, encoder: Tensor,
                   temb: Tensor, controlnet_block_samples: Optional[Tensor] = None,
                   start_block: int = 0) -> Tensor:
    """The dual, standard and last segments from start_block on; returns the
    image stream. ControlNet residuals come pre-expanded to (num_layers, B,
    S, D): residual i follows block i of the first two segments, and the last
    one follows the last block, in the reference's order."""
    cn = controlnet_block_samples
    nd = cfg.num_dual_layers
    if start_block < nd:
        hidden, encoder = _run_segment(params.dual_blocks, cfg, hidden, encoder, temb,
                                       None if cn is None else cn[:nd], start_block)
        start_block = nd
    hidden, encoder = _run_segment(params.std_blocks, cfg, hidden, encoder, temb,
                                   None if cn is None else cn[nd:cfg.num_layers - 1],
                                   max(start_block, nd) - nd)
    hidden, _ = params.last_block(hidden, encoder, temb, cfg)
    if cn is not None:
        hidden = hidden + cn[-1]
    return hidden


def sd3_forward(
    params: SD3Transformer, cfg: SD3Config,
    hidden_states: Tensor,          # (B, C, H, W) latent
    encoder_hidden_states: Tensor,  # (B, S_txt, joint_attention_dim)
    pooled_projections: Tensor,     # (B, pooled_projection_dim)
    timestep: Tensor,               # (B,) train-timestep units (sigma * 1000)
    pos_embed: Tensor,              # (1, N, D) cropped table (sd3_cropped_pos_embed)
    controlnet_block_samples: Optional[Tensor] = None,
) -> Tensor:
    """Denoiser forward -> (B, out_channels, H, W)."""
    b, _, h, w = hidden_states.shape
    hidden, temb, encoder = _sd3_embed(params, cfg, hidden_states, encoder_hidden_states,
                                       pooled_projections, timestep, pos_embed)
    hidden = sd3_run_blocks(params, cfg, hidden, encoder, temb, controlnet_block_samples)
    return _sd3_output(params, cfg, hidden, temb, b, h, w)


def sd3_forward_cached(
    params: SD3Transformer, cfg: SD3Config, cache_cfg, cache_state: dict, step: int,
    total_steps: int, hidden_states: Tensor, encoder_hidden_states: Tensor,
    pooled_projections: Tensor, timestep: Tensor, pos_embed: Tensor,
) -> Tuple[Tensor, dict]:
    """sd3_forward under a step-skipping cache -> (output, new_cache_state)
    (fastdm_tpu/models/sd35.py:323-385). TeaCache probes the first block's
    modulated input (the 9-chunk one when the first block is dual); FBCache
    and DiCache probe the output of a prefix that spans the segments, the
    dual blocks first, then the standard ones; a computed step runs the
    remaining blocks."""
    from fastdm_tpu_torch.caching.config import DiCacheConfig, FBCacheConfig, TeaCacheConfig
    from fastdm_tpu_torch.caching.xcaching import cached_run

    if not isinstance(cache_cfg, (TeaCacheConfig, FBCacheConfig, DiCacheConfig)):
        raise ValueError(f"unsupported cache config {type(cache_cfg).__name__}")
    b, _, h, w = hidden_states.shape
    hidden, temb, encoder = _sd3_embed(params, cfg, hidden_states, encoder_hidden_states,
                                       pooled_projections, timestep, pos_embed)
    nd = cfg.num_dual_layers

    if isinstance(cache_cfg, TeaCacheConfig):
        first = params.dual_blocks[0] if nd else params.std_blocks[0]
        start = 0

        def probe_fn(hh, ee):
            return first.norm1(hh, temb)[0], (hh, ee)
    else:
        # the prefix never holds the last block (its context_pre_only output
        # differs in shape)
        start = min(1 if isinstance(cache_cfg, FBCacheConfig) else cache_cfg.probe_depth,
                    cfg.num_layers - 1)

        def probe_fn(hh, ee):
            hh, ee = _run_segment(params.dual_blocks[:min(start, nd)], cfg, hh, ee, temb)
            hh, ee = _run_segment(params.std_blocks[:max(0, start - nd)], cfg, hh, ee, temb)
            return hh, (hh, ee)

    def rest_fn(hh, ee):
        return sd3_run_blocks(params, cfg, hh, ee, temb, start_block=start)

    hidden, new_state = cached_run(cache_cfg, cache_state, step, total_steps, hidden, encoder,
                                   probe_fn, rest_fn)
    return _sd3_output(params, cfg, hidden, temb, b, h, w), new_state
