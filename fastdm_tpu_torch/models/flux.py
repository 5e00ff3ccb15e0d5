"""FLUX.1 (dev/Krea) transformer core (port of fastdm_tpu/models/flux.py).

PyTorch layout: the 19 dual-stream (MMDiT) and 38 single-stream blocks are
nn.Modules in two nn.ModuleLists, walked by a Python loop (the JAX package
stacks them and runs lax.scan). RoPE cos/sin are computed on the host once
per resolution in float64 and handed to the forward as float32 tensors.
ControlNet residuals, stacked (L, B, S_img, D), are added to the image
stream after each block. The pipeline-parallel branch of the JAX module
arrives with parallel/.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.attention import JointAttention, attention_apply
from fastdm_tpu_torch.layers.embeddings import (
    CombinedTimestepTextProj,
    TimestepEmbedding,
    flux_rope_cos_sin,
)
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.layers.normalization import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    AdaLayerNormZeroSingle,
    layer_norm,
)
from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    patch_size: int = 1
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    mlp_ratio: float = 4.0
    quant: Optional[str] = "int8"  # None/"bf16" | "int8" | "fp8" | "int4" | "int4p", as JAX
    # also quantize the AdaLN modulation projections (bf16 otherwise), as
    # fastdm_tpu/models/flux.py:56-60
    quant_mods: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.inner_dim * self.mlp_ratio)


# ---------------------------------------------------------------- modules


class FluxDualBlock(nn.Module):
    """MMDiT block: image and context streams with joint attention; forward
    is the port of flux_dual_block."""

    def __init__(self, norm1: AdaLayerNormZero, norm1_context: AdaLayerNormZero,
                 attn: JointAttention, ff: FeedForward, ff_context: FeedForward):
        super().__init__()
        self.norm1, self.norm1_context = norm1, norm1_context
        self.attn = attn
        self.ff, self.ff_context = ff, ff_context

    def forward(self, hidden: Tensor, encoder: Tensor, temb: Tensor, cos: Tensor,
                sin: Tensor, cfg: FluxConfig) -> Tuple[Tensor, Tensor]:
        h_norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden, temb)
        e_norm, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
            encoder, temb)
        attn_out, ctx_attn_out = attention_apply(
            self.attn, h_norm, e_norm, heads=cfg.num_attention_heads,
            head_dim=cfg.attention_head_dim, rope_cos=cos, rope_sin=sin,
            context_pre_only=False)
        hidden = hidden + gate_msa[:, None] * attn_out
        h2 = layer_norm(hidden) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        hidden = hidden + gate_mlp[:, None] * self.ff(h2, "gelu-approximate")
        encoder = encoder + c_gate_msa[:, None] * ctx_attn_out
        e2 = layer_norm(encoder) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        encoder = encoder + c_gate_mlp[:, None] * self.ff_context(e2, "gelu-approximate")
        return hidden, encoder


class FluxSingleBlock(nn.Module):
    """Single-stream block (forward = the port of flux_single_block);
    q|k|v|mlp_in share one matmul of the normalized input (qkv_mlp), the MLP
    gate is exact erf GELU."""

    def __init__(self, norm: AdaLayerNormZeroSingle, qkv_mlp: QLinear, proj_out: QLinear,
                 attn: JointAttention):
        super().__init__()
        self.norm = norm
        self.qkv_mlp, self.proj_out = qkv_mlp, proj_out
        self.attn = attn

    def forward(self, hidden: Tensor, temb: Tensor, cos: Tensor, sin: Tensor,
                cfg: FluxConfig) -> Tensor:
        h_norm, gate = self.norm(hidden, temb)
        fused = self.qkv_mlp(h_norm)
        # a tp shard holds its heads' q|k|v, then its slice of the mlp
        inner = cfg.inner_dim // (self.attn.tp.size if self.attn.tp is not None else 1)
        qkv = fused[..., :3 * inner]
        mlp = F.gelu(fused[..., 3 * inner:])
        attn_out = attention_apply(
            self.attn, h_norm, None, heads=cfg.num_attention_heads,
            head_dim=cfg.attention_head_dim, rope_cos=cos, rope_sin=sin, pre_only=True,
            qkv_override=qkv)
        return hidden + gate[:, None] * self.proj_out(torch.cat([attn_out, mlp], dim=-1))


class FluxTransformer(nn.Module):
    """The FLUX denoiser's parameters; the forward is flux_forward()."""

    def __init__(self, *, x_embedder: QLinear, context_embedder: QLinear,
                 time_text_embed: CombinedTimestepTextProj, dual_blocks: List[FluxDualBlock],
                 single_blocks: List[FluxSingleBlock], norm_out: AdaLayerNormContinuous,
                 proj_out: QLinear):
        super().__init__()
        self.x_embedder, self.context_embedder = x_embedder, context_embedder
        self.time_text_embed = time_text_embed
        self.dual_blocks = nn.ModuleList(dual_blocks)
        self.single_blocks = nn.ModuleList(single_blocks)
        self.norm_out, self.proj_out = norm_out, proj_out


# ---------------------------------------------------------------- params


def flux_init_random(seed: int, cfg: FluxConfig, device="cuda") -> FluxTransformer:
    """Random-weight FLUX (benchmarks and smoke runs without checkpoints): every
    weight is drawn by a torch.Generator seeded with `seed`, on `device`,
    straight into its storage dtype (qlinear_random; unit q/k norm weights),
    as the JAX flux_init_random: the block projections in cfg.quant, the
    AdaLN modulations too when cfg.quant_mods, the embedders and the output
    head in bf16. The JAX and torch generators give different numbers for the
    same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd, mlp = cfg.inner_dim, cfg.attention_head_dim, cfg.mlp_hidden_dim
    q, qm = cfg.quant, cfg.quant if cfg.quant_mods else None

    def lin(k, n, quant=None):
        return qlinear_random(gen, k, n, quant=quant, device=dev)

    def ones():
        return torch.ones(hd, dtype=torch.bfloat16, device=dev)

    def mlp_embed(k):
        return TimestepEmbedding(lin(k, d), lin(d, d))

    tte = CombinedTimestepTextProj(
        mlp_embed(256), mlp_embed(cfg.pooled_projection_dim),
        mlp_embed(256) if cfg.guidance_embeds else None)
    dual = [FluxDualBlock(
        AdaLayerNormZero(lin(d, 6 * d, qm)), AdaLayerNormZero(lin(d, 6 * d, qm)),
        JointAttention(qkv=lin(d, 3 * d, q), add_qkv=lin(d, 3 * d, q), to_out=lin(d, d, q),
                       to_add_out=lin(d, d, q), norm_q=ones(), norm_k=ones(),
                       norm_added_q=ones(), norm_added_k=ones()),
        FeedForward(lin(d, mlp, q), lin(mlp, d, q)), FeedForward(lin(d, mlp, q), lin(mlp, d, q)))
        for _ in range(cfg.num_layers)]
    single = [FluxSingleBlock(
        AdaLayerNormZeroSingle(lin(d, 3 * d, qm)), lin(d, 3 * d + mlp, q), lin(d + mlp, d, q),
        JointAttention(norm_q=ones(), norm_k=ones()))
        for _ in range(cfg.num_single_layers)]
    return FluxTransformer(
        x_embedder=lin(cfg.in_channels, d), context_embedder=lin(cfg.joint_attention_dim, d),
        time_text_embed=tte, dual_blocks=dual, single_blocks=single,
        norm_out=AdaLayerNormContinuous(lin(d, 2 * d)),
        proj_out=lin(d, cfg.patch_size**2 * cfg.out_channels))


def flux_dual_block_load(src: TensorSource, p: str, q, qm) -> FluxDualBlock:
    """The dual-stream block of checkpoint prefix p, its projections in q
    and its AdaLN modulations in qm (shared with the FLUX ControlNet)."""
    return FluxDualBlock(
        AdaLayerNormZero(src.linear(f"{p}.norm1.linear", qm)),
        AdaLayerNormZero(src.linear(f"{p}.norm1_context.linear", qm)),
        JointAttention(
            qkv=src.fused_linear([f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v"], q),
            add_qkv=src.fused_linear(
                [f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj", f"{p}.attn.add_v_proj"], q),
            to_out=src.linear(f"{p}.attn.to_out.0", q),
            to_add_out=src.linear(f"{p}.attn.to_add_out", q),
            norm_q=src.tensor(f"{p}.attn.norm_q.weight"),
            norm_k=src.tensor(f"{p}.attn.norm_k.weight"),
            norm_added_q=src.tensor(f"{p}.attn.norm_added_q.weight"),
            norm_added_k=src.tensor(f"{p}.attn.norm_added_k.weight")),
        FeedForward(src.linear(f"{p}.ff.net.0.proj", q), src.linear(f"{p}.ff.net.2", q)),
        FeedForward(src.linear(f"{p}.ff_context.net.0.proj", q),
                    src.linear(f"{p}.ff_context.net.2", q)))


def flux_single_block_load(src: TensorSource, p: str, q, qm) -> FluxSingleBlock:
    """The single-stream block of checkpoint prefix p: q|k|v|mlp_in
    concatenated along N."""
    return FluxSingleBlock(
        AdaLayerNormZeroSingle(src.linear(f"{p}.norm.linear", qm)),
        src.fused_linear([f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v",
                          f"{p}.proj_mlp"], q),
        src.linear(f"{p}.proj_out", q),
        JointAttention(norm_q=src.tensor(f"{p}.attn.norm_q.weight"),
                       norm_k=src.tensor(f"{p}.attn.norm_k.weight")))


def flux_load(src: TensorSource, cfg: FluxConfig) -> FluxTransformer:
    """Load a diffusers FLUX transformer checkpoint onto src.device, quantizing
    the block projections to cfg.quant (and the AdaLN modulations when
    cfg.quant_mods) as the JAX flux_load does; under tensor parallelism each
    block is built whole and then cut to this rank's shard (src.block)."""
    q = cfg.quant
    qm = q if cfg.quant_mods else None

    def mlp_embed(p):
        return TimestepEmbedding(src.linear(f"{p}.linear_1", None),
                                 src.linear(f"{p}.linear_2", None))

    tte = CombinedTimestepTextProj(
        mlp_embed("time_text_embed.timestep_embedder"),
        mlp_embed("time_text_embed.text_embedder"),
        mlp_embed("time_text_embed.guidance_embedder") if cfg.guidance_embeds else None)

    dual = []
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        if not src.holds("transformer_blocks", i):
            dual.append(src.elsewhere("transformer_blocks", i))
            continue
        dual.append(src.block(f"dual_blocks.{i}", flux_dual_block_load(src, p, q, qm)))

    single = []
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        if not src.holds("single_transformer_blocks", i):
            single.append(src.elsewhere("single_transformer_blocks", i))
            continue
        single.append(src.block(f"single_blocks.{i}", flux_single_block_load(src, p, q, qm)))

    model = FluxTransformer(
        x_embedder=src.linear("x_embedder", None),
        context_embedder=src.linear("context_embedder", None),
        time_text_embed=tte, dual_blocks=dual, single_blocks=single,
        norm_out=AdaLayerNormContinuous(src.linear("norm_out.linear", None)),
        proj_out=src.linear("proj_out", None))
    src.assert_consumed()
    return model


# ---------------------------------------------------------------- forward


def _flux_embed(params: FluxTransformer, cfg: FluxConfig, hidden_states, encoder_hidden_states,
                pooled_projections, timestep, guidance):
    """x/context embedders and the combined time-text-guidance embedding."""
    if cfg.guidance_embeds and guidance is None:
        raise ValueError("cfg.guidance_embeds=True (FLUX-dev style) requires guidance=")
    hidden = params.x_embedder(hidden_states)
    temb = params.time_text_embed(
        timestep.float() * 1000.0, pooled_projections,
        guidance.float() * 1000.0 if cfg.guidance_embeds else None)
    encoder = params.context_embedder(encoder_hidden_states)
    return hidden, temb, encoder


def cn_sample_interval(samples: Tensor, num_layers: int) -> int:
    """Layer i of num_layers takes samples[i // interval] of a stack of
    L_cn residuals, interval = ceil(num_layers / L_cn) (the diffusers
    interval indexing of the JAX expand_cn_samples; a stack of num_layers
    gives interval 1)."""
    return -(-num_layers // samples.shape[0])


def _run_dual(params: FluxTransformer, cfg: FluxConfig, hidden, encoder, temb, cos, sin,
              start: int = 0, stop: Optional[int] = None,
              controlnet_block_samples: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Dual blocks [start, stop) (the JAX _scan_dual's start / stop); block i
    adds its ControlNet residual to the image stream after it."""
    n = len(params.dual_blocks)
    cn = controlnet_block_samples
    for i in range(start, n if stop is None else min(stop, n)):
        hidden, encoder = params.dual_blocks[i](hidden, encoder, temb, cos, sin, cfg)
        if cn is not None:
            hidden = hidden + cn[i // cn_sample_interval(cn, n)]
    return hidden, encoder


def flux_run_blocks(params: FluxTransformer, cfg: FluxConfig, hidden, encoder, temb, cos,
                    sin, controlnet_block_samples: Optional[Tensor] = None,
                    controlnet_single_block_samples: Optional[Tensor] = None,
                    start_dual: int = 0) -> Tensor:
    """Dual then single blocks; returns the final image-stream hidden.
    controlnet_*: stacked (L_cn, B, S_img, D) residuals or None, spread
    over the blocks by cn_sample_interval; a single block's residual is
    added in place to the image part of the joint stream. start_dual skips
    the first dual blocks (a cache probe already ran them).

    While a pipeline is active (parallel/pp_state) and pp divides both stack
    depths, the whole uncached stack runs through the GPipe schedule, the
    batch dim as its microbatch stream (JAX's _pp_applicable and
    _flux_run_blocks_pp, fastdm_tpu/models/flux.py:363-435); with ControlNet
    residuals or a probe's prefix it stays sequential, as in JAX."""
    from fastdm_tpu_torch.parallel import pp_state
    from fastdm_tpu_torch.parallel.pipeline import pipelined

    pipe = pp_state.get_pp_pipeline()
    if (start_dual == 0 and controlnet_block_samples is None
            and controlnet_single_block_samples is None
            and pipelined(pipe, params.dual_blocks, params.single_blocks)):
        return _flux_run_blocks_pp(params, cfg, hidden, encoder, temb, cos, sin, pipe)
    hidden, encoder = _run_dual(params, cfg, hidden, encoder, temb, cos, sin, start_dual,
                                controlnet_block_samples=controlnet_block_samples)
    ctx_len = encoder.shape[1]
    joint = torch.cat([encoder, hidden], dim=1)
    cns, n = controlnet_single_block_samples, len(params.single_blocks)
    for i, block in enumerate(params.single_blocks):
        joint = block(joint, temb, cos, sin, cfg)
        if cns is not None:
            joint[:, ctx_len:] += cns[i // cn_sample_interval(cns, n)]
    return joint[:, ctx_len:]


def _flux_run_blocks_pp(params: FluxTransformer, cfg: FluxConfig, hidden, encoder, temb, cos,
                        sin, pipe) -> Tensor:
    """GPipe over the dual then the single stack: each batch entry a
    microbatch, temb riding in its state (it is per sample)."""
    from fastdm_tpu_torch.parallel.pipeline import gpipe_run_blocks, join_microbatches, \
        split_microbatches

    def dual_fn(block, state):
        h, e, t = state
        return (*block(h, e, t, cos, sin, cfg), t)

    def single_fn(block, state):
        j, t = state
        return block(j, t, cos, sin, cfg), t

    ctx_len = encoder.shape[1]
    states = gpipe_run_blocks(dual_fn, params.dual_blocks,
                              split_microbatches(hidden, encoder, temb), pipe)
    states = gpipe_run_blocks(single_fn, params.single_blocks,
                              [(torch.cat([e, h], dim=1), t) for h, e, t in states], pipe)
    return join_microbatches(states)[:, ctx_len:]


def flux_forward(
    params: FluxTransformer, cfg: FluxConfig,
    hidden_states: Tensor,          # (B, S_img, in_channels) packed latents
    encoder_hidden_states: Tensor,  # (B, S_txt, joint_attention_dim)
    pooled_projections: Tensor,     # (B, pooled_projection_dim)
    timestep: Tensor,               # (B,) in [0, 1]
    rope_cos: Tensor,               # (S_txt + S_img, head_dim / 2)
    rope_sin: Tensor,
    guidance: Optional[Tensor] = None,
    controlnet_block_samples: Optional[Tensor] = None,
    controlnet_single_block_samples: Optional[Tensor] = None,
) -> Tensor:
    """Denoiser forward -> (B, S_img, patch^2 * out_channels)."""
    hidden, temb, encoder = _flux_embed(params, cfg, hidden_states, encoder_hidden_states,
                                        pooled_projections, timestep, guidance)
    hidden = flux_run_blocks(params, cfg, hidden, encoder, temb, rope_cos, rope_sin,
                             controlnet_block_samples, controlnet_single_block_samples)
    return params.proj_out(params.norm_out(hidden, temb))


def flux_forward_cached(
    params: FluxTransformer, cfg: FluxConfig, cache_cfg, cache_state: dict, step: int,
    total_steps: int, hidden_states: Tensor, encoder_hidden_states: Tensor,
    pooled_projections: Tensor, timestep: Tensor, rope_cos: Tensor, rope_sin: Tensor,
    guidance: Optional[Tensor] = None, controlnet_block_samples: Optional[Tensor] = None,
    controlnet_single_block_samples: Optional[Tensor] = None,
) -> Tuple[Tensor, dict]:
    """flux_forward under a step-skipping cache -> (output, new_cache_state)
    (fastdm_tpu/models/flux.py:525-561). TeaCache probes block 0's modulated
    input, FBCache dual block 0's output, DiCache the output of the first
    probe_depth dual blocks (each with its ControlNet residual); a computed
    step runs the remaining blocks."""
    from fastdm_tpu_torch.caching.config import DiCacheConfig, FBCacheConfig, TeaCacheConfig
    from fastdm_tpu_torch.caching.xcaching import cached_run

    if isinstance(cache_cfg, TeaCacheConfig):
        start = 0
    elif isinstance(cache_cfg, FBCacheConfig):
        start = 1
    elif isinstance(cache_cfg, DiCacheConfig):
        start = cache_cfg.probe_depth
    else:
        raise ValueError(f"unsupported cache config {type(cache_cfg).__name__}")
    hidden, temb, encoder = _flux_embed(params, cfg, hidden_states, encoder_hidden_states,
                                        pooled_projections, timestep, guidance)
    cn, cns = controlnet_block_samples, controlnet_single_block_samples

    def probe_fn(h, e):
        if isinstance(cache_cfg, TeaCacheConfig):
            probe, *_ = params.dual_blocks[0].norm1(h, temb)
            return probe, (h, e)
        h, e = _run_dual(params, cfg, h, e, temb, rope_cos, rope_sin, stop=start,
                         controlnet_block_samples=cn)
        return h, (h, e)

    def rest_fn(h, e):
        return flux_run_blocks(params, cfg, h, e, temb, rope_cos, rope_sin, cn, cns,
                               start_dual=start)

    hidden, new_state = cached_run(cache_cfg, cache_state, step, total_steps, hidden, encoder,
                                   probe_fn, rest_fn)
    return params.proj_out(params.norm_out(hidden, temb)), new_state


# ---------------------------------------------------------------- helpers


def flux_img_ids(height_tokens: int, width_tokens: int) -> np.ndarray:
    """Packed-latent position ids, (H*W, 3) — axis0=0, axis1=row, axis2=col."""
    ids = np.zeros((height_tokens, width_tokens, 3), np.float64)
    ids[..., 1] = np.arange(height_tokens)[:, None]
    ids[..., 2] = np.arange(width_tokens)[None, :]
    return ids.reshape(-1, 3)


def flux_rope_cache(cfg: FluxConfig, txt_len: int, height_tokens: int, width_tokens: int,
                    ref_tokens_hw=None, device="cuda") -> Tuple[Tensor, Tensor]:
    """(cos, sin) for the joint [txt, img(, refs)] sequence; text ids are all
    zero. ref_tokens_hw adds Kontext reference-image id blocks: one (h, w)
    pair or a sequence of them, reference i on id-plane i + 1."""
    blocks = [np.zeros((txt_len, 3), np.float64), flux_img_ids(height_tokens, width_tokens)]
    if ref_tokens_hw is not None:
        refs = ref_tokens_hw
        if refs and not isinstance(refs[0], (tuple, list)):
            refs = (refs,)  # one (h, w) pair
        for i, (rh, rw) in enumerate(refs):
            ref_ids = flux_img_ids(rh, rw)
            ref_ids[:, 0] = float(i + 1)
            blocks.append(ref_ids)
    return flux_rope_cos_sin(np.concatenate(blocks, axis=0), cfg.axes_dims_rope, device=device)
