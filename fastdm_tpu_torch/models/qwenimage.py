"""Qwen-Image transformer core (port of fastdm_tpu/models/qwenimage.py, the
text-to-image parts).

PyTorch layout: the 60 homogeneous dual-stream blocks are nn.Modules in one
nn.ModuleList, walked by a Python loop (the JAX package stacks them and runs
lax.scan). The complex QwenEmbedRope becomes a host-side float64 (cos, sin)
table per resolution: per-axis angles with scale_rope's centred (negative)
image positions and text positions from max(h/2, w/2) on. The modulation
projections are quantized only under cfg.quant_mods. The pipeline-parallel
block schedule of the JAX module arrives with parallel/.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.kernels import rms_norm
from fastdm_tpu_torch.layers.attention import JointAttention, qwen_attention_apply
from fastdm_tpu_torch.layers.embeddings import TimestepEmbedding, get_timestep_embedding
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.layers.normalization import AdaLayerNormContinuous, layer_norm
from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    patch_size: int = 2
    in_channels: int = 64
    out_channels: int = 16  # packed: patch^2 * out == in == 64 (diffusers config)
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    scale_rope: bool = True
    quant: Optional[str] = "int8"  # None/"bf16" | "int8" | "fp8" | "int4" | "int4p", as JAX
    quant_mods: bool = False  # also quantize img_mod / txt_mod (bf16 otherwise)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


# ---------------------------------------------------------------- modules


def _modulate(x: Tensor, mod: Tensor, eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """layer_norm (no affine) and the (shift, scale, gate) modulation ->
    (modulated x, gate[:, None])."""
    shift, scale, gate = mod.chunk(3, dim=-1)
    y = layer_norm(x, eps=eps) * (1 + scale[:, None]) + shift[:, None]
    return y, gate[:, None]


class QwenBlock(nn.Module):
    """Dual-stream block; forward is the port of qwen_block."""

    def __init__(self, img_mod: QLinear, txt_mod: QLinear, attn: JointAttention,
                 img_mlp: FeedForward, txt_mlp: FeedForward):
        super().__init__()
        self.img_mod, self.txt_mod = img_mod, txt_mod
        self.attn = attn
        self.img_mlp, self.txt_mlp = img_mlp, txt_mlp

    def forward(self, hidden: Tensor, encoder: Tensor, temb: Tensor, cos: Tensor, sin: Tensor,
                cfg: QwenImageConfig) -> Tuple[Tensor, Tensor]:
        img_mod1, img_mod2 = self.img_mod(F.silu(temb)).chunk(2, dim=-1)
        txt_mod1, txt_mod2 = self.txt_mod(F.silu(temb)).chunk(2, dim=-1)
        img_m, img_gate1 = _modulate(hidden, img_mod1)
        txt_m, txt_gate1 = _modulate(encoder, txt_mod1)
        img_attn, txt_attn = qwen_attention_apply(
            self.attn, img_m, txt_m, heads=cfg.num_attention_heads,
            head_dim=cfg.attention_head_dim, rope_cos=cos, rope_sin=sin)
        hidden = hidden + img_gate1 * img_attn
        encoder = encoder + txt_gate1 * txt_attn
        img_m2, img_gate2 = _modulate(hidden, img_mod2)
        hidden = hidden + img_gate2 * self.img_mlp(img_m2, "gelu-approximate")
        txt_m2, txt_gate2 = _modulate(encoder, txt_mod2)
        encoder = encoder + txt_gate2 * self.txt_mlp(txt_m2, "gelu-approximate")
        return hidden, encoder


class QwenImageTransformer(nn.Module):
    """The Qwen-Image denoiser's parameters; the forward is qwen_forward()."""

    def __init__(self, *, img_in: QLinear, txt_in: QLinear, txt_norm: Tensor,
                 timestep_embedder: TimestepEmbedding, blocks: List[QwenBlock],
                 norm_out: AdaLayerNormContinuous, proj_out: QLinear):
        super().__init__()
        self.img_in, self.txt_in = img_in, txt_in
        self.txt_norm = nn.Parameter(txt_norm, requires_grad=False)
        self.timestep_embedder = timestep_embedder
        self.blocks = nn.ModuleList(blocks)
        self.norm_out, self.proj_out = norm_out, proj_out


# ---------------------------------------------------------------- params


def qwen_init_random(seed: int, cfg: QwenImageConfig, device="cuda") -> QwenImageTransformer:
    """Random-weight Qwen-Image (benchmarks and smoke runs without
    checkpoints): every weight drawn by a torch.Generator seeded with `seed`,
    on `device`, straight into its storage dtype (qlinear_random; unit norm
    weights), as the JAX qwen_init_random: the block linears in cfg.quant,
    img_mod / txt_mod too when cfg.quant_mods, the embedders, norm_out and
    proj_out in bf16. The JAX and torch generators give different numbers for
    the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, q = cfg.inner_dim, cfg.quant
    qm = q if cfg.quant_mods else None

    def lin(k, n, quant=None):
        return qlinear_random(gen, k, n, quant=quant, device=dev)

    def ones(n=cfg.attention_head_dim):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    blocks = [QwenBlock(
        lin(d, 6 * d, qm), lin(d, 6 * d, qm),
        JointAttention(qkv=lin(d, 3 * d, q), add_qkv=lin(d, 3 * d, q), to_out=lin(d, d, q),
                       to_add_out=lin(d, d, q), norm_q=ones(), norm_k=ones(),
                       norm_added_q=ones(), norm_added_k=ones()),
        FeedForward(lin(d, 4 * d, q), lin(4 * d, d, q)),
        FeedForward(lin(d, 4 * d, q), lin(4 * d, d, q))) for _ in range(cfg.num_layers)]
    return QwenImageTransformer(
        img_in=lin(cfg.in_channels, d), txt_in=lin(cfg.joint_attention_dim, d),
        txt_norm=ones(cfg.joint_attention_dim),
        timestep_embedder=TimestepEmbedding(lin(256, d), lin(d, d)), blocks=blocks,
        norm_out=AdaLayerNormContinuous(lin(d, 2 * d)),
        proj_out=lin(d, cfg.patch_size**2 * cfg.out_channels))


def qwen_load(src: TensorSource, cfg: QwenImageConfig) -> QwenImageTransformer:
    """Load a diffusers Qwen-Image transformer checkpoint onto src.device as
    the JAX qwen_load does: the block linears quantized to cfg.quant,
    img_mod / txt_mod too when cfg.quant_mods. Every tensor must be claimed."""
    q = cfg.quant
    qm = q if cfg.quant_mods else None
    blocks = []
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        if not src.holds("transformer_blocks", i):
            blocks.append(src.elsewhere("transformer_blocks", i))
            continue
        a = f"{p}.attn"
        blocks.append(src.block(f"blocks.{i}", QwenBlock(
            src.linear(f"{p}.img_mod.1", qm), src.linear(f"{p}.txt_mod.1", qm),
            JointAttention(
                qkv=src.fused_linear([f"{a}.to_q", f"{a}.to_k", f"{a}.to_v"], q),
                add_qkv=src.fused_linear([f"{a}.add_q_proj", f"{a}.add_k_proj",
                                          f"{a}.add_v_proj"], q),
                norm_q=src.tensor(f"{a}.norm_q.weight"), norm_k=src.tensor(f"{a}.norm_k.weight"),
                norm_added_q=src.tensor(f"{a}.norm_added_q.weight"),
                norm_added_k=src.tensor(f"{a}.norm_added_k.weight"),
                to_out=src.linear(f"{a}.to_out.0", q), to_add_out=src.linear(f"{a}.to_add_out", q)),
            FeedForward(src.linear(f"{p}.img_mlp.net.0.proj", q),
                        src.linear(f"{p}.img_mlp.net.2", q)),
            FeedForward(src.linear(f"{p}.txt_mlp.net.0.proj", q),
                        src.linear(f"{p}.txt_mlp.net.2", q)))))
    model = QwenImageTransformer(
        img_in=src.linear("img_in", None), txt_in=src.linear("txt_in", None),
        txt_norm=src.tensor("txt_norm.weight"),
        timestep_embedder=TimestepEmbedding(
            src.linear("time_text_embed.timestep_embedder.linear_1", None),
            src.linear("time_text_embed.timestep_embedder.linear_2", None)),
        blocks=blocks, norm_out=AdaLayerNormContinuous(src.linear("norm_out.linear", None)),
        proj_out=src.linear("proj_out", None))
    src.assert_consumed()
    return model


# ---------------------------------------------------------------- forward


def _qwen_embed(params: QwenImageTransformer, hidden_states, encoder_hidden_states, timestep):
    """img_in, txt_norm (the rmsnorm kernel) + txt_in, and the timestep MLP
    on the sinusoid of the raw sigma scaled by 1000."""
    hidden = params.img_in(hidden_states)
    encoder = params.txt_in(rms_norm(encoder_hidden_states, params.txt_norm, 1e-6))
    t_proj = get_timestep_embedding(timestep.float(), 256, flip_sin_to_cos=True,
                                    downscale_freq_shift=0.0, scale=1000.0)
    temb = params.timestep_embedder(t_proj.to(hidden.dtype))
    return hidden, encoder, temb


def qwen_run_blocks(params: QwenImageTransformer, cfg: QwenImageConfig, hidden, encoder, temb,
                    cos, sin, start_block: int = 0, stop_block: Optional[int] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Blocks [start_block, stop_block) -> (image stream, text stream).
    While a pipeline is active (parallel/pp_state), the whole stack (no probe
    prefix, depth divisible by pp) runs through the GPipe schedule, each
    batch entry a microbatch with its temb (JAX's qwen_run_blocks /
    _qwen_run_blocks_pp, fastdm_tpu/models/qwenimage.py:188-250)."""
    from fastdm_tpu_torch.parallel import pp_state
    from fastdm_tpu_torch.parallel.pipeline import pipelined

    pipe = pp_state.get_pp_pipeline()
    if (start_block == 0 and stop_block in (None, len(params.blocks))
            and pipelined(pipe, params.blocks)):
        from fastdm_tpu_torch.parallel.pipeline import gpipe_run_blocks, join_microbatches, \
            split_microbatches

        def block_fn(block, state):
            h, e, t = state
            return (*block(h, e, t, cos, sin, cfg), t)

        states = gpipe_run_blocks(block_fn, params.blocks,
                                  split_microbatches(hidden, encoder, temb), pipe)
        return join_microbatches(states, 0), join_microbatches(states, 1)
    for block in params.blocks[start_block:stop_block]:
        hidden, encoder = block(hidden, encoder, temb, cos, sin, cfg)
    return hidden, encoder


def qwen_forward(
    params: QwenImageTransformer, cfg: QwenImageConfig,
    hidden_states: Tensor,          # (B, S_img, in_channels) packed latents
    encoder_hidden_states: Tensor,  # (B, S_txt, joint_attention_dim)
    timestep: Tensor,               # (B,) in [0, 1] (sigma)
    rope_cos: Tensor,               # (S_txt + S_img, head_dim / 2)
    rope_sin: Tensor,
) -> Tensor:
    """Denoiser forward -> (B, S_img, patch^2 * out_channels)."""
    hidden, encoder, temb = _qwen_embed(params, hidden_states, encoder_hidden_states, timestep)
    hidden, _ = qwen_run_blocks(params, cfg, hidden, encoder, temb, rope_cos, rope_sin)
    return params.proj_out(params.norm_out(hidden, temb))


def qwen_forward_cached(
    params: QwenImageTransformer, cfg: QwenImageConfig, cache_cfg, cache_state: dict,
    step: int, total_steps: int, hidden_states: Tensor, encoder_hidden_states: Tensor,
    timestep: Tensor, rope_cos: Tensor, rope_sin: Tensor,
) -> Tuple[Tensor, dict]:
    """qwen_forward under a step-skipping cache -> (output, new_cache_state)
    (fastdm_tpu/models/qwenimage.py:264-317). TeaCache probes block 0's
    TEXT-stream modulated input (a txt_mod linear of its own, quantized under
    quant_mods); FBCache and DiCache the output of the first 1 / probe_depth
    blocks; a computed step runs the remaining blocks."""
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
    hidden, encoder, temb = _qwen_embed(params, hidden_states, encoder_hidden_states, timestep)

    def probe_fn(hh, ee):
        if isinstance(cache_cfg, TeaCacheConfig):
            txt_mod1, _ = params.blocks[0].txt_mod(F.silu(temb)).chunk(2, dim=-1)
            return _modulate(ee, txt_mod1)[0], (hh, ee)
        hh, ee = qwen_run_blocks(params, cfg, hh, ee, temb, rope_cos, rope_sin, stop_block=start)
        return hh, (hh, ee)

    def rest_fn(hh, ee):
        return qwen_run_blocks(params, cfg, hh, ee, temb, rope_cos, rope_sin,
                               start_block=start)[0]

    hidden, new_state = cached_run(cache_cfg, cache_state, step, total_steps, hidden, encoder,
                                   probe_fn, rest_fn)
    return params.proj_out(params.norm_out(hidden, temb)), new_state


# ---------------------------------------------------------------- rope


def qwen_rope_cos_sin(cfg: QwenImageConfig, frame: int, height: int, width: int, txt_len: int,
                      extra_shapes: Tuple[Tuple[int, int, int], ...] = (),
                      device="cuda") -> Tuple[Tensor, Tensor]:
    """(cos, sin) of the joint [text, image] sequence, each (txt_len +
    sum(f*h*w), sum(axes_dims_rope) / 2) float32 on `device`, one entry per
    rotation pair (interleaved application), from float64 angles.

    scale_rope centres the H/W positions: rows get [-(h - h//2), ..., -1, 0,
    ..., h//2 - 1]; the text starts at max(h//2, w//2) over every image entry.
    extra_shapes: more (frame, h, w) image entries after the main one (the
    edit model's source images); entry i's frame axis starts at position i."""
    theta = 10000.0
    a0, a1, a2 = cfg.axes_dims_rope

    def angles(dim, pos):
        inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        return np.outer(np.asarray(pos, np.float64), inv)

    imgs, max_vid = [], 0
    for idx, (f, h, w) in enumerate([(frame, height, width), *extra_shapes]):
        f_pos = np.arange(idx, idx + f)
        if cfg.scale_rope:
            h_pos = np.concatenate([np.arange(-(h - h // 2), 0), np.arange(h // 2)])
            w_pos = np.concatenate([np.arange(-(w - w // 2), 0), np.arange(w // 2)])
            max_vid = max(h // 2, w // 2, max_vid)
        else:
            h_pos, w_pos = np.arange(h), np.arange(w)
            max_vid = max(h, w, max_vid)
        af = angles(a0, f_pos)[:, None, None, :] * np.ones((1, h, w, 1))
        ah = angles(a1, h_pos)[None, :, None, :] * np.ones((f, 1, w, 1))
        aw = angles(a2, w_pos)[None, None, :, :] * np.ones((f, h, 1, 1))
        imgs.append(np.concatenate([af, ah, aw], axis=-1).reshape(f * h * w, -1))
    txt_pos = np.arange(max_vid, max_vid + txt_len)
    txt = np.concatenate([angles(a0, txt_pos), angles(a1, txt_pos), angles(a2, txt_pos)], axis=-1)
    a = np.concatenate([txt, *imgs], axis=0)
    dev = resolve_device(device)
    return (torch.from_numpy(np.cos(a).astype(np.float32)).to(dev),
            torch.from_numpy(np.sin(a).astype(np.float32)).to(dev))
