"""ControlNets of SDXL and FLUX (port of fastdm_tpu/models/controlnets.py).

Both run the base models' own modules:
  * the SDXL ControlNet is the UNet's down and mid path (models/sdxl.py
    SDXLStage / SDXLResnet / SDXLTransformer2D) plus the 4-conv hint encoder
    and one 1x1 zero conv per skip; it returns 9 down residuals and 1 mid
    residual, NCHW, for sdxl_forward. The addition-, class- and
    encoder-projection variants are chosen by what the checkpoint holds, as
    in JAX;
  * the FLUX ControlNet runs N dual and M single blocks (models/flux.py),
    keeps each block's image-stream output and applies the stacked
    zero-linear heads: (L, B, S, D) x (L, D, D) products of bf16 operands
    summed in f32, plus the f32 bias, times the scale, then one cast, as
    JAX's einsum with preferred_element_type f32. Union checkpoints prepend
    one mode token to the text stream; raw-hint checkpoints encode the
    conditioning image with the hint encoder and pack it into 2x2 patches.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.conv2d import conv2d
from fastdm_tpu_torch.layers.embeddings import (
    AttentionPooling,
    CombinedTimestepTextProj,
    TextImageProjection,
    TextImageTimeEmbedding,
    TextTimeEmbedding,
    TimestepEmbedding,
    get_timestep_embedding,
)
from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random
from fastdm_tpu_torch.models.flux import (
    FluxConfig,
    FluxDualBlock,
    FluxSingleBlock,
    flux_dual_block_load,
    flux_init_random,
    flux_single_block_load,
)
from fastdm_tpu_torch.models.loader import TensorSource
from fastdm_tpu_torch.models.sdxl import (
    SDXLConfig,
    SDXLStage,
    _conv,
    _norm,
    _RandomParts,
    _resnet_load,
    _t2d_load,
    frozen_params,
)

Tensor = torch.Tensor


# ================================================================== SDXL


class ControlNetCondEmbedding(nn.Module):
    """The 4-conv hint encoder, image space -> latent space (forward = the
    port of controlnet_cond_embedding_apply): SiLU after conv_in and after
    each block, the odd blocks at stride 2 with the JAX package's "SAME"
    padding (0 before, 1 after an even size), then conv_out."""

    def __init__(self, conv_in: nn.ParameterDict, blocks: List[nn.ParameterDict],
                 conv_out: nn.ParameterDict):
        super().__init__()
        self.conv_in, self.conv_out = conv_in, conv_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, cond: Tensor) -> Tensor:
        """cond: (B, 3, H, W) -> (B, C, H / 8, W / 8) bf16."""
        x = F.silu(conv2d(self.conv_in, cond.to(torch.bfloat16)))
        for i, blk in enumerate(self.blocks):
            x = F.silu(conv2d(blk, x, stride=1 if i % 2 == 0 else 2))
        return conv2d(self.conv_out, x)


class SDXLControlNet(nn.Module):
    """The SDXL ControlNet's parameters; the forward is
    sdxl_controlnet_forward(). add_embedding is a TimestepEmbedding
    ("text_time", SDXL), TextTimeEmbedding ("text") or TextImageTimeEmbedding
    ("text_image"); class_embedding a {"weight"} table or a
    TimestepEmbedding; encoder_hid_proj a QLinear ("text_proj") or a
    TextImageProjection ("text_image_proj")."""

    def __init__(self, *, conv_in: nn.ParameterDict, time_embedding: TimestepEmbedding,
                 cond_embedding: ControlNetCondEmbedding, down: List[SDXLStage], mid: SDXLStage,
                 controlnet_down_blocks: List[nn.ParameterDict],
                 controlnet_mid_block: nn.ParameterDict, add_embedding: Optional[nn.Module] = None,
                 class_embedding: Optional[nn.Module] = None,
                 encoder_hid_proj: Optional[nn.Module] = None):
        super().__init__()
        self.conv_in, self.time_embedding = conv_in, time_embedding
        self.add_embedding, self.class_embedding = add_embedding, class_embedding
        self.encoder_hid_proj = encoder_hid_proj
        self.cond_embedding = cond_embedding
        self.down = nn.ModuleList(down)
        self.mid = mid
        self.controlnet_down_blocks = nn.ModuleList(controlnet_down_blocks)
        self.controlnet_mid_block = controlnet_mid_block


def _sdxl_cn_embeddings(params: SDXLControlNet, cfg: SDXLConfig, timestep, encoder_hidden_states,
                        text_embeds, time_ids, class_labels, class_embed_sinusoidal,
                        image_embeds) -> Tuple[Tensor, Tensor]:
    """(emb, ctx): the time embedding plus the class and addition embeddings
    the checkpoint holds, and the (projected) cross-attention context."""
    b = timestep.shape[0]
    dt = torch.bfloat16
    t_emb = get_timestep_embedding(timestep, cfg.block_channels[0], flip_sin_to_cos=True,
                                   downscale_freq_shift=0.0)
    emb = params.time_embedding(t_emb.to(dt))

    ce = params.class_embedding
    if ce is not None:
        if class_labels is None:
            raise ValueError("this ControlNet checkpoint has a class_embedding: pass "
                             "class_labels to sdxl_controlnet_forward")
        if isinstance(ce, TimestepEmbedding):  # the "timestep" / "projection" MLP
            labels = class_labels
            if class_embed_sinusoidal:
                labels = get_timestep_embedding(labels, cfg.block_channels[0],
                                                flip_sin_to_cos=True, downscale_freq_shift=0.0)
            class_emb = ce(labels.to(dt))
        else:  # an nn.Embedding table
            class_emb = ce["weight"][class_labels]
        emb = emb + class_emb.to(emb.dtype)

    ae = params.add_embedding
    if isinstance(ae, TextTimeEmbedding):
        emb = emb + ae(encoder_hidden_states.to(dt), cfg.addition_embed_num_heads)
    elif isinstance(ae, TextImageTimeEmbedding):
        if image_embeds is None:
            raise ValueError("addition_embed_type 'text_image' needs image_embeds")
        emb = emb + ae(encoder_hidden_states.to(dt), image_embeds.to(dt))
    elif ae is not None:  # "text_time" (SDXL)
        time_embeds = get_timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                             flip_sin_to_cos=True,
                                             downscale_freq_shift=0.0).reshape(b, -1)
        add_embeds = torch.cat([text_embeds.float(), time_embeds], dim=-1)
        emb = emb + ae(add_embeds.to(dt))

    ctx = encoder_hidden_states.to(dt)
    ehp = params.encoder_hid_proj
    if isinstance(ehp, TextImageProjection):
        if image_embeds is None:
            raise ValueError("encoder_hid_dim_type 'text_image_proj' needs image_embeds")
        ctx = ehp(ctx, image_embeds.to(dt))
    elif ehp is not None:  # "text_proj"
        ctx = ehp(ctx)
    return emb, ctx


def sdxl_controlnet_forward(
    params: SDXLControlNet, cfg: SDXLConfig,
    sample: Tensor,                 # (B, 4, H, W) latent
    timestep: Tensor,
    encoder_hidden_states: Tensor,
    text_embeds: Tensor,
    time_ids: Tensor,
    controlnet_cond: Tensor,        # (B, 3, 8H, 8W) hint image, NCHW
    conditioning_scale: float = 1.0,
    guess_mode: bool = False,
    class_labels: Optional[Tensor] = None,
    class_embed_sinusoidal: bool = False,
    image_embeds: Optional[Tensor] = None,
    global_pool_conditions: bool = False,
) -> Tuple[List[Tensor], Tensor]:
    """-> (9 down residuals, mid residual), NCHW. guess_mode scales the
    residuals by logspace(-1, 0, 10) * conditioning_scale in f32 (so they
    come out f32, as JAX's bf16 x f32 product); global_pool_conditions
    mean-pools each residual over its spatial dims."""
    emb, ctx = _sdxl_cn_embeddings(params, cfg, timestep, encoder_hidden_states, text_embeds,
                                   time_ids, class_labels, class_embed_sinusoidal, image_embeds)
    g = cfg.norm_groups
    x = conv2d(params.conv_in, sample.to(torch.bfloat16))
    x = x + params.cond_embedding(controlnet_cond)
    skips = [x]
    for stage in params.down:
        for i, r in enumerate(stage.resnets):
            x = r(x, emb, g)
            if stage.attns is not None:
                x = stage.attns[i](x, ctx, cfg, None, cfg.ip_adapter_scale)
            skips.append(x)
        if stage.downsample is not None:
            x = conv2d(stage.downsample, x, stride=2)
            skips.append(x)
    mid = params.mid
    x = mid.resnets[0](x, emb, g)
    x = mid.attns[0](x, ctx, cfg, None, cfg.ip_adapter_scale)
    x = mid.resnets[1](x, emb, g)

    down = [conv2d(zc, s) for zc, s in zip(params.controlnet_down_blocks, skips)]
    mid_sample = conv2d(params.controlnet_mid_block, x)
    if guess_mode and not global_pool_conditions:
        scales = torch.logspace(-1, 0, len(down) + 1, dtype=torch.float32) * conditioning_scale
        down = [s.float() * float(sc) for s, sc in zip(down, scales[:-1])]
        mid_sample = mid_sample.float() * float(scales[-1])
    else:
        down = [s * conditioning_scale for s in down]
        mid_sample = mid_sample * conditioning_scale
    if global_pool_conditions:
        down = [s.mean(dim=(2, 3), keepdim=True) for s in down]
        mid_sample = mid_sample.mean(dim=(2, 3), keepdim=True)
    return down, mid_sample


def sdxl_controlnet_skip_channels(cfg: SDXLConfig) -> Tuple[int, ...]:
    """Channels of the 9 down residuals: conv_in, down0's two resnets and
    downsample; down1's two and downsample; down2's two."""
    c0, c1, c2 = cfg.block_channels
    return (c0, c0, c0, c0, c1, c1, c1, c2, c2)


def sdxl_controlnet_init_random(seed: int, cfg: SDXLConfig,
                                cond_channels: Tuple[int, ...] = (16, 32, 96, 256),
                                device="cuda") -> SDXLControlNet:
    """Random SDXL ControlNet ("text_time", as diffusers' SDXL ControlNets),
    drawn as sdxl_init_random draws the UNet's down and mid path, plus the
    hint encoder and zero convs drawn nonzero (N(0, 1) * 0.03, so that the
    residuals show), by a torch.Generator seeded with `seed` on `device`
    (port of sdxl_controlnet_init_random)."""
    r = _RandomParts(seed, cfg, resolve_device(device))
    c0, _, c2 = cfg.block_channels
    e = cond_channels
    down, mid = r.down_mid()
    return SDXLControlNet(
        conv_in=r.conv(3, cfg.in_channels, c0), time_embedding=r.embedding(c0),
        add_embedding=r.embedding(cfg.add_embedding_in_dim), down=down, mid=mid,
        cond_embedding=ControlNetCondEmbedding(
            r.conv(3, 3, e[0]), [r.conv(3, e[i // 2], e[(i + 1) // 2]) for i in range(6)],
            r.conv(3, e[3], c0)),
        controlnet_down_blocks=[r.conv(1, c, c) for c in sdxl_controlnet_skip_channels(cfg)],
        controlnet_mid_block=r.conv(1, c2, c2))


def _cn_add_embedding(src: TensorSource) -> Optional[nn.Module]:
    """The checkpoint's addition_embed_type variant, from its keys."""
    if "add_embedding.linear_1.weight" in src:  # "text_time" (SDXL)
        return TimestepEmbedding(src.linear("add_embedding.linear_1", None),
                                 src.linear("add_embedding.linear_2", None))
    if "add_embedding.pool.positional_embedding" in src:  # "text"
        pool = "add_embedding.pool"
        return TextTimeEmbedding(
            _norm(src, "add_embedding.norm1"),
            AttentionPooling(src.tensor(f"{pool}.positional_embedding"),
                             *(src.linear(f"{pool}.{n}", None)
                               for n in ("q_proj", "k_proj", "v_proj"))),
            src.linear("add_embedding.proj", None), _norm(src, "add_embedding.norm2"))
    if "add_embedding.text_proj.weight" in src:  # "text_image"
        return TextImageTimeEmbedding(src.linear("add_embedding.text_proj", None),
                                      _norm(src, "add_embedding.text_norm"),
                                      src.linear("add_embedding.image_proj", None))
    return None


def _cn_class_embedding(src: TensorSource) -> Optional[nn.Module]:
    """class_embed_type: an nn.Embedding table or a TimestepEmbedding MLP
    (whether labels go through the sinusoid first comes from config.json:
    the forward's class_embed_sinusoidal)."""
    if "class_embedding.weight" in src:
        return frozen_params(weight=src.tensor("class_embedding.weight"))
    if "class_embedding.linear_1.weight" in src:
        return TimestepEmbedding(src.linear("class_embedding.linear_1", None),
                                 src.linear("class_embedding.linear_2", None))
    return None


def _cn_encoder_hid(src: TensorSource) -> Optional[nn.Module]:
    """encoder_hid_dim_type: one linear ("text_proj") or "text_image_proj"."""
    if "encoder_hid_proj.weight" in src:
        return src.linear("encoder_hid_proj", None)
    if "encoder_hid_proj.image_embeds.weight" in src:
        return TextImageProjection(src.linear("encoder_hid_proj.image_embeds", None),
                                   src.linear("encoder_hid_proj.text_proj", None))
    return None


def _cond_embedding_load(src: TensorSource, prefix: str, n_blocks: int) -> ControlNetCondEmbedding:
    return ControlNetCondEmbedding(_conv(src, f"{prefix}.conv_in"),
                                   [_conv(src, f"{prefix}.blocks.{i}") for i in range(n_blocks)],
                                   _conv(src, f"{prefix}.conv_out"))


def sdxl_controlnet_load(src: TensorSource, cfg: SDXLConfig) -> SDXLControlNet:
    """Load a diffusers SDXL ControlNet checkpoint onto src.device, the block,
    proj_in / proj_out and time_emb_proj linears in cfg.quant (name map of
    fastdm_tpu/models/controlnets.py sdxl_controlnet_load); every tensor must
    be claimed."""
    q = cfg.quant
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]

    def resnets(p):
        return [_resnet_load(src, f"{p}.resnets.{j}", q) for j in range(2)]

    def attns(p, n, n_layers, path):
        return [_t2d_load(src, f"{p}.attentions.{j}", n_layers, q, False, f"{path}.attns.{j}")
                for j in range(n)]

    model = SDXLControlNet(
        conv_in=_conv(src, "conv_in"),
        time_embedding=TimestepEmbedding(src.linear("time_embedding.linear_1", None),
                                         src.linear("time_embedding.linear_2", None)),
        cond_embedding=_cond_embedding_load(src, "controlnet_cond_embedding", 6),
        add_embedding=_cn_add_embedding(src), class_embedding=_cn_class_embedding(src),
        encoder_hid_proj=_cn_encoder_hid(src),
        down=[SDXLStage(resnets("down_blocks.0"),
                        downsample=_conv(src, "down_blocks.0.downsamplers.0.conv")),
              SDXLStage(resnets("down_blocks.1"), attns("down_blocks.1", 2, n1, "down.1"),
                        downsample=_conv(src, "down_blocks.1.downsamplers.0.conv")),
              SDXLStage(resnets("down_blocks.2"), attns("down_blocks.2", 2, n2, "down.2"))],
        mid=SDXLStage(resnets("mid_block"), attns("mid_block", 1, n2, "mid")),
        controlnet_down_blocks=[_conv(src, f"controlnet_down_blocks.{i}") for i in range(9)],
        controlnet_mid_block=_conv(src, "controlnet_mid_block"))
    src.assert_consumed()
    return model


# ================================================================== FLUX


@dataclasses.dataclass(frozen=True)
class FluxControlNetConfig(FluxConfig):
    num_layers: int = 5
    num_single_layers: int = 0
    guidance_embeds: bool = False


class FluxControlNet(nn.Module):
    """The FLUX ControlNet's parameters; the forward is
    flux_controlnet_forward(). controlnet_blocks / controlnet_single_blocks:
    the stacked zero-linear heads {"w": (L, D, D) bf16 in (in, out) layout,
    "bias": (L, D) f32}."""

    def __init__(self, *, x_embedder: QLinear, context_embedder: QLinear,
                 time_text_embed: CombinedTimestepTextProj, controlnet_x_embedder: QLinear,
                 dual_blocks: List[FluxDualBlock], single_blocks: List[FluxSingleBlock],
                 controlnet_blocks: Optional[nn.ParameterDict] = None,
                 controlnet_single_blocks: Optional[nn.ParameterDict] = None,
                 input_hint_block: Optional[ControlNetCondEmbedding] = None,
                 controlnet_mode_embedder: Optional[Tensor] = None):
        super().__init__()
        self.x_embedder, self.context_embedder = x_embedder, context_embedder
        self.time_text_embed = time_text_embed
        self.controlnet_x_embedder = controlnet_x_embedder
        self.input_hint_block = input_hint_block
        self.dual_blocks = nn.ModuleList(dual_blocks)
        self.single_blocks = nn.ModuleList(single_blocks)
        self.controlnet_blocks = controlnet_blocks
        self.controlnet_single_blocks = controlnet_single_blocks
        self.controlnet_mode_embedder = (None if controlnet_mode_embedder is None else
                                         nn.Parameter(controlnet_mode_embedder,
                                                      requires_grad=False))


# the process-wide TF32 switch is saved, set and restored under this lock: the
# virtual tp ranks (parallel/tensor_parallel.py) call _zero_heads from threads
_TF32_SWITCH = threading.Lock()


def _zero_heads(samples: Tensor, heads: nn.ParameterDict, scale: float) -> Tensor:
    """Stacked per-layer zero linears (L, B, S, D) x (L, D, D): bf16 operands
    multiplied with f32 accumulation, the f32 bias, the scale, then one cast
    to the samples' dtype. The product runs in TF32 whatever the global
    setting: a bf16 value is exact in TF32, so the tensor cores give the
    exact products the f32 CUDA-core GEMM gives."""
    with _TF32_SWITCH:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = torch.matmul(samples.to(torch.bfloat16).float(),
                               heads["w"].to(torch.bfloat16).float()[:, None])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    out = out + heads["bias"].float()[:, None, None, :]
    return (out * scale).to(samples.dtype)


def flux_controlnet_forward(
    params: FluxControlNet, cfg: FluxControlNetConfig,
    hidden_states: Tensor,          # (B, S_img, in_channels) packed latents
    controlnet_cond: Tensor,        # packed hint (B, S_img, in_channels), or raw (B, 3, H, W)
    encoder_hidden_states: Tensor,
    pooled_projections: Tensor,
    timestep: Tensor,
    rope_cos: Tensor,
    rope_sin: Tensor,
    guidance: Optional[Tensor] = None,
    conditioning_scale: float = 1.0,
    control_mode: Optional[int] = None,
) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """-> stacked (num_layers, B, S_img, D) and (num_single_layers, B, S_img,
    D) residuals, scaled, for flux_forward's controlnet arguments (None for
    an empty stack). A raw-hint ControlNet (input_hint_block) takes the
    conditioning IMAGE in [-1, 1], NCHW. With control_mode a union
    checkpoint prepends its mode token to the text stream: rope_cos / sin
    must then cover txt_len + 1 + S_img ids."""
    hidden = params.x_embedder(hidden_states)
    if params.input_hint_block is not None:
        # 2x2 patches with (c, ph, pw) channel order, as JAX's NHWC packing
        # (ps = 2 hard-coded there too): FLUX's latent packing
        from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents

        controlnet_cond = flux_pack_latents(params.input_hint_block(controlnet_cond))
    hidden = hidden + params.controlnet_x_embedder(controlnet_cond)
    # gated on the parameters, not the config: a guidance-distilled
    # checkpoint without guidance raises
    use_guidance = params.time_text_embed.guidance_embedder is not None
    if use_guidance and guidance is None:
        raise ValueError("this FLUX ControlNet checkpoint is guidance-distilled; pass guidance=")
    temb = params.time_text_embed(timestep.float() * 1000.0, pooled_projections,
                                  guidance.float() * 1000.0 if use_guidance else None)
    encoder = params.context_embedder(encoder_hidden_states)
    if control_mode is not None and params.controlnet_mode_embedder is not None:
        mode = params.controlnet_mode_embedder[control_mode].to(encoder.dtype)
        encoder = torch.cat([mode.expand(encoder.shape[0], 1, -1), encoder], dim=1)

    block_samples = single_block_samples = None
    if cfg.num_layers:
        outs = []
        for block in params.dual_blocks:
            hidden, encoder = block(hidden, encoder, temb, rope_cos, rope_sin, cfg)
            outs.append(hidden)
        block_samples = _zero_heads(torch.stack(outs), params.controlnet_blocks,
                                    conditioning_scale)
    if cfg.num_single_layers:
        ctx_len = encoder.shape[1]
        joint = torch.cat([encoder, hidden], dim=1)
        outs = []
        for block in params.single_blocks:
            joint = block(joint, temb, rope_cos, rope_sin, cfg)
            outs.append(joint[:, ctx_len:])
        single_block_samples = _zero_heads(torch.stack(outs), params.controlnet_single_blocks,
                                           conditioning_scale)
    return block_samples, single_block_samples


def _heads_random(gen, n: int, d: int, dev) -> nn.ParameterDict:
    w = torch.randn(n, d, d, generator=gen, device=dev, dtype=torch.bfloat16).mul_(0.02)
    return frozen_params(w=w, bias=torch.zeros(n, d, device=dev))


def flux_controlnet_init_random(seed: int, cfg: FluxControlNetConfig, device="cuda",
                                num_modes: int = 0) -> FluxControlNet:
    """Random FLUX ControlNet (port of flux_controlnet_init_random): the
    trunk drawn as flux_init_random draws a FLUX of cfg's depth, then
    controlnet_x_embedder, the zero heads (N(0, 1) * 0.02, so that the
    residuals show) and, for num_modes > 0, a union mode table (N(0, 1) *
    0.1 in bf16), by torch.Generators seeded with `seed` on `device`."""
    dev = resolve_device(device)
    base = flux_init_random(seed, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    d = cfg.inner_dim
    modes = None
    if num_modes:
        modes = torch.randn(num_modes, d, generator=gen, device=dev,
                            dtype=torch.bfloat16).mul_(0.1)
    return FluxControlNet(
        x_embedder=base.x_embedder, context_embedder=base.context_embedder,
        time_text_embed=base.time_text_embed,
        controlnet_x_embedder=qlinear_random(gen, cfg.in_channels, d, device=dev),
        dual_blocks=list(base.dual_blocks), single_blocks=list(base.single_blocks),
        controlnet_blocks=_heads_random(gen, cfg.num_layers, d, dev) if cfg.num_layers else None,
        controlnet_single_blocks=(_heads_random(gen, cfg.num_single_layers, d, dev)
                                  if cfg.num_single_layers else None),
        controlnet_mode_embedder=modes)


def flux_controlnet_load(src: TensorSource, cfg: FluxControlNetConfig) -> FluxControlNet:
    """Load a diffusers FLUX ControlNet checkpoint (InstantX / XLabs layouts)
    onto src.device: the FLUX trunk without norm_out / proj_out, quantized as
    flux_load quantizes it, plus controlnet_x_embedder, the zero heads, a
    union mode table and a raw-hint input_hint_block where present. A flat
    Sequential input_hint_block ('input_hint_block.0.weight') is refused, as
    in JAX."""
    if "input_hint_block.0.weight" in src:
        raise NotImplementedError(
            "this FLUX ControlNet's input_hint_block uses a flat Sequential layout; only the "
            "diffusers ControlNetConditioningEmbedding layout (conv_in/blocks.N/conv_out) is "
            "supported")
    q = cfg.quant
    qm = q if cfg.quant_mods else None

    def mlp(p):
        return TimestepEmbedding(src.linear(f"{p}.linear_1", None),
                                 src.linear(f"{p}.linear_2", None))

    params = dict(x_embedder=src.linear("x_embedder", None),
                  context_embedder=src.linear("context_embedder", None),
                  controlnet_x_embedder=src.linear("controlnet_x_embedder", None))
    if "input_hint_block.conv_in.weight" in src:
        n_blocks = 0
        while f"input_hint_block.blocks.{n_blocks}.weight" in src:
            n_blocks += 1
        params["input_hint_block"] = _cond_embedding_load(src, "input_hint_block", n_blocks)
    guidance = "time_text_embed.guidance_embedder.linear_1.weight" in src
    tte = CombinedTimestepTextProj(
        mlp("time_text_embed.timestep_embedder"), mlp("time_text_embed.text_embedder"),
        mlp("time_text_embed.guidance_embedder") if guidance else None)

    # the trunk's blocks, each built whole, as this rank keeps it (src.block: its tp shard)
    dual = [src.block(f"dual_blocks.{i}",
                      flux_dual_block_load(src, f"transformer_blocks.{i}", q, qm))
            for i in range(cfg.num_layers)]
    single = [src.block(f"single_blocks.{i}",
                        flux_single_block_load(src, f"single_transformer_blocks.{i}", q, qm))
              for i in range(cfg.num_single_layers)]

    def zero_heads(prefix):
        ws, bs, i = [], [], 0
        while f"{prefix}.{i}.weight" in src:
            ws.append(src.tensor(f"{prefix}.{i}.weight", torch.float32).t().to(torch.bfloat16))
            bs.append(src.tensor(f"{prefix}.{i}.bias", torch.float32))
            i += 1
        return frozen_params(w=torch.stack(ws), bias=torch.stack(bs)) if ws else None

    model = FluxControlNet(
        time_text_embed=tte, dual_blocks=dual, single_blocks=single,
        controlnet_blocks=zero_heads("controlnet_blocks"),
        controlnet_single_blocks=zero_heads("controlnet_single_blocks"),
        controlnet_mode_embedder=(src.tensor("controlnet_mode_embedder.weight")
                                  if "controlnet_mode_embedder.weight" in src else None),
        **params)
    src.assert_consumed()
    return model
