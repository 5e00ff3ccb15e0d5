"""SDXL-base UNet core (port of fastdm_tpu/models/sdxl.py: SDXLConfig,
_attention, _basic_block, _transformer2d, _resnet, sdxl_forward, sdxl_load,
sdxl_init_random).

PyTorch layout: NCHW activations and (out, in, kh, kw) conv weights (the JAX
package runs NHWC with HWIO weights); the BasicTransformerBlocks of each
Transformer2DModel are nn.Modules in an nn.ModuleList walked by a Python loop
(JAX stacks them and runs lax.scan). Convs and GroupNorms are
fastdm_tpu_torch.layers.conv2d; the stride-2 downsamplers pad as the JAX
package's "SAME" does (0 before, 1 after for an even size), not as diffusers'
Downsample2D (1 on both sides). The linears of the blocks, proj_in/proj_out
and the resnets' time_emb_proj are QLinears in cfg.quant; the time and add
embedders stay bf16. The self-attention's q|k|v and the cross-attention's k|v
are fused projections; the feed-forward is GEGLU through the gelu_and_mul
kernel; attention is the sdpa kernel. IP-Adapter: an optional fused k|v
projection of image tokens on every cross-attention, attached from an
IP-Adapter checkpoint by sdxl_attach_ip_adapter (the image projections are
layers/ip_adapter.py). The SDXL ControlNet, which runs this module's down
and mid stages, is models/controlnets.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.kernels import scaled_dot_product_attention
from fastdm_tpu_torch.layers.conv2d import conv2d, group_norm, upsample_nearest2x
from fastdm_tpu_torch.layers.embeddings import TimestepEmbedding, get_timestep_embedding
from fastdm_tpu_torch.layers.feedforward import FeedForward
from fastdm_tpu_torch.layers.normalization import layer_norm
from fastdm_tpu_torch.layers.qlinear import QLinear, qlinear_random
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor

_GN_EPS = 1e-5
_LN_EPS = 1e-5
_T2D_GN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280)
    cross_attention_dim: int = 2048
    attn_layers: Tuple[int, ...] = (0, 2, 10)  # per down block; mid uses attn_layers[2]
    head_dim: int = 64
    addition_time_embed_dim: int = 256
    time_embed_dim: int = 1280
    add_embedding_in_dim: int = 2816  # 1280 pooled text + 6 * 256 time ids
    addition_embed_num_heads: int = 64
    norm_groups: int = 32
    quant: Optional[str] = "int8"  # None/"bf16" | "int8" | "fp8", as the JAX SDXLConfig
    ip_adapter: bool = False
    ip_adapter_scale: float = 0.6


def frozen_params(**tensors: Tensor) -> nn.ParameterDict:
    """A conv ({"w", "b"}) or norm ({"gamma", "beta"}) as frozen parameters,
    indexable like the JAX package's dicts."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


# ---------------------------------------------------------------- modules


class SDXLAttention(nn.Module):
    """Self-attention (fused qkv) or cross-attention (q + fused kv, optional
    IP-Adapter k|v), then the output projection. tp: the tp group of a layer
    split by heads (parallel/tensor_parallel.py): its projections then hold
    heads / tp.size heads."""

    tp = None

    def __init__(self, out: QLinear, qkv: Optional[QLinear] = None, q: Optional[QLinear] = None,
                 kv: Optional[QLinear] = None, ipadp_kv: Optional[QLinear] = None):
        super().__init__()
        self.qkv, self.q, self.kv, self.ipadp_kv, self.out = qkv, q, kv, ipadp_kv, out

    def forward(self, x: Tensor, ctx: Optional[Tensor], head_dim: int,
                ip_embeds: Optional[Tensor] = None, ip_scale: float = 0.6) -> Tensor:
        """x (B, S, C) tokens -> (B, S, C) (port of _attention)."""
        c = x.shape[-1] // (self.tp.size if self.tp is not None else 1)
        heads = c // head_dim
        if self.qkv is not None:
            qkv = self.qkv(x)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        else:
            q = self.q(x)
            kv = self.kv(ctx)
            k, v = kv[..., :c], kv[..., c:]
        out = scaled_dot_product_attention(q, k, v, heads, heads, head_dim, False, head_dim**-0.5)
        if ip_embeds is not None and self.ipadp_kv is not None:
            ip_kv = self.ipadp_kv(ip_embeds)
            ip_out = scaled_dot_product_attention(q, ip_kv[..., :c], ip_kv[..., c:], heads, heads,
                                                  head_dim, False, head_dim**-0.5)
            out = out + ip_scale * ip_out
        return self.out(out.to(x.dtype))


class SDXLTransformerBlock(nn.Module):
    """BasicTransformerBlock: LN + self-attention, LN + cross-attention,
    LN + GEGLU feed-forward, each residual (port of _basic_block)."""

    def __init__(self, norm1: nn.ParameterDict, attn1: SDXLAttention, norm2: nn.ParameterDict,
                 attn2: SDXLAttention, norm3: nn.ParameterDict, ff: FeedForward):
        super().__init__()
        self.norm1, self.attn1 = norm1, attn1
        self.norm2, self.attn2 = norm2, attn2
        self.norm3, self.ff = norm3, ff

    def forward(self, x: Tensor, ctx: Tensor, cfg: SDXLConfig, ip_embeds: Optional[Tensor],
                ip_scale: float) -> Tensor:
        h = layer_norm(x, self.norm1["gamma"], self.norm1["beta"], _LN_EPS)
        x = x + self.attn1(h, None, cfg.head_dim)
        h = layer_norm(x, self.norm2["gamma"], self.norm2["beta"], _LN_EPS)
        x = x + self.attn2(h, ctx, cfg.head_dim, ip_embeds, ip_scale)
        h = layer_norm(x, self.norm3["gamma"], self.norm3["beta"], _LN_EPS)
        return x + self.ff(h, "geglu")


class SDXLTransformer2D(nn.Module):
    """GroupNorm -> tokens -> proj_in -> blocks -> proj_out, plus the
    residual (port of _transformer2d)."""

    def __init__(self, norm: nn.ParameterDict, proj_in: QLinear,
                 blocks: List[SDXLTransformerBlock], proj_out: QLinear):
        super().__init__()
        self.norm, self.proj_in, self.proj_out = norm, proj_in, proj_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: Tensor, ctx: Tensor, cfg: SDXLConfig, ip_embeds: Optional[Tensor],
                ip_scale: float) -> Tensor:
        b, c, hh, ww = x.shape
        h = group_norm(self.norm, x, cfg.norm_groups, eps=_T2D_GN_EPS)
        h = self.proj_in(h.flatten(2).transpose(1, 2))  # (B, H*W, C) tokens
        for block in self.blocks:
            h = block(h, ctx, cfg, ip_embeds, ip_scale)
        h = self.proj_out(h)
        return h.transpose(1, 2).reshape(b, c, hh, ww) + x


class SDXLResnet(nn.Module):
    """ResnetBlock2D with the time embedding added after conv1 (port of
    _resnet); GroupNorm eps 1e-5."""

    def __init__(self, norm1: nn.ParameterDict, conv1: nn.ParameterDict, time_emb_proj: QLinear,
                 norm2: nn.ParameterDict, conv2: nn.ParameterDict,
                 shortcut: Optional[nn.ParameterDict] = None):
        super().__init__()
        self.norm1, self.conv1, self.time_emb_proj = norm1, conv1, time_emb_proj
        self.norm2, self.conv2, self.shortcut = norm2, conv2, shortcut

    def forward(self, x: Tensor, temb: Tensor, groups: int) -> Tensor:
        h = conv2d(self.conv1, F.silu(group_norm(self.norm1, x, groups, eps=_GN_EPS)))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, :, None, None].to(h.dtype)
        h = conv2d(self.conv2, F.silu(group_norm(self.norm2, h, groups, eps=_GN_EPS)))
        if self.shortcut is not None:
            x = conv2d(self.shortcut, x)
        return x + h


class SDXLStage(nn.Module):
    """One down / mid / up block: resnets, optional Transformer2Ds (one per
    resnet; the mid block has one for two resnets) and an optional stride-2
    downsample or 2x upsample conv."""

    def __init__(self, resnets: List[SDXLResnet], attns: Optional[List[SDXLTransformer2D]] = None,
                 downsample: Optional[nn.ParameterDict] = None,
                 upsample: Optional[nn.ParameterDict] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attns = nn.ModuleList(attns) if attns else None
        self.downsample, self.upsample = downsample, upsample


class SDXLUNet(nn.Module):
    """The SDXL denoiser's parameters; the forward is sdxl_forward(). down:
    the three down blocks (plain resnets, then two Transformer2D stages), up:
    the three up blocks (two Transformer2D stages, then plain resnets)."""

    def __init__(self, *, conv_in: nn.ParameterDict, time_embedding: TimestepEmbedding,
                 add_embedding: TimestepEmbedding, down: List[SDXLStage], mid: SDXLStage,
                 up: List[SDXLStage], conv_norm_out: nn.ParameterDict, conv_out: nn.ParameterDict):
        super().__init__()
        self.conv_in = conv_in
        self.time_embedding, self.add_embedding = time_embedding, add_embedding
        self.down = nn.ModuleList(down)
        self.mid = mid
        self.up = nn.ModuleList(up)
        self.conv_norm_out, self.conv_out = conv_norm_out, conv_out


# ---------------------------------------------------------------- forward


def sdxl_forward(
    params: SDXLUNet, cfg: SDXLConfig,
    sample: Tensor,                 # (B, 4, H, W) latent
    timestep: Tensor,               # (B,) train-timestep units
    encoder_hidden_states: Tensor,  # (B, 77, 2048)
    text_embeds: Tensor,            # (B, 1280) pooled
    time_ids: Tensor,               # (B, 6)
    ip_embeds: Optional[Tensor] = None,
    down_block_additional_residuals: Optional[List[Tensor]] = None,
    mid_block_additional_residual: Optional[Tensor] = None,
    ip_scale: Optional[float] = None,
) -> Tensor:
    """UNet forward -> (B, 4, H, W) bf16. The ControlNet residuals are NCHW,
    like every activation of the port (the JAX function takes them NHWC);
    ip_scale overrides cfg.ip_adapter_scale."""
    b = sample.shape[0]
    dt = torch.bfloat16
    scale = cfg.ip_adapter_scale if ip_scale is None else ip_scale
    t_emb = get_timestep_embedding(timestep, cfg.block_channels[0], flip_sin_to_cos=True,
                                   downscale_freq_shift=0.0)
    emb = params.time_embedding(t_emb.to(dt))
    time_embeds = get_timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                         flip_sin_to_cos=True,
                                         downscale_freq_shift=0.0).reshape(b, -1)
    add_embeds = torch.cat([text_embeds.float(), time_embeds], dim=-1)
    emb = emb + params.add_embedding(add_embeds.to(dt))
    ctx = encoder_hidden_states.to(dt)
    g = cfg.norm_groups

    x = conv2d(params.conv_in, sample.to(dt))
    skips = [x]
    for stage in params.down:
        for i, r in enumerate(stage.resnets):
            x = r(x, emb, g)
            if stage.attns is not None:
                x = stage.attns[i](x, ctx, cfg, ip_embeds, scale)
            skips.append(x)
        if stage.downsample is not None:
            x = conv2d(stage.downsample, x, stride=2)
            skips.append(x)
    if down_block_additional_residuals is not None:
        skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_additional_residuals)]

    mid = params.mid
    x = mid.resnets[0](x, emb, g)
    x = mid.attns[0](x, ctx, cfg, ip_embeds, scale)
    x = mid.resnets[1](x, emb, g)
    if mid_block_additional_residual is not None:
        x = x + mid_block_additional_residual.to(x.dtype)

    for stage in params.up:
        for i, r in enumerate(stage.resnets):
            x = r(torch.cat([x, skips.pop()], dim=1), emb, g)
            if stage.attns is not None:
                x = stage.attns[i](x, ctx, cfg, ip_embeds, scale)
        if stage.upsample is not None:
            x = conv2d(stage.upsample, upsample_nearest2x(x))

    x = group_norm(params.conv_norm_out, x, g, eps=_GN_EPS)
    return conv2d(params.conv_out, F.silu(x))


# ---------------------------------------------------------------- loading


def _norm(src: TensorSource, p: str) -> nn.ParameterDict:
    return frozen_params(gamma=src.tensor(f"{p}.weight"), beta=src.tensor(f"{p}.bias"))


def _conv(src: TensorSource, p: str) -> nn.ParameterDict:
    return frozen_params(**src.conv(p))


def _resnet_load(src: TensorSource, p: str, q) -> SDXLResnet:
    shortcut = _conv(src, f"{p}.conv_shortcut") if f"{p}.conv_shortcut.weight" in src else None
    return SDXLResnet(_norm(src, f"{p}.norm1"), _conv(src, f"{p}.conv1"),
                      src.linear(f"{p}.time_emb_proj", q), _norm(src, f"{p}.norm2"),
                      _conv(src, f"{p}.conv2"), shortcut)


def _t2d_load(src: TensorSource, p: str, n_layers: int, q, ip_adapter: bool,
              path: str) -> SDXLTransformer2D:
    """A Transformer2D of checkpoint prefix p at module path `path`; each
    block built whole, as this rank keeps it (src.block: its tp shard)."""
    blocks = []
    for j in range(n_layers):
        bp = f"{p}.transformer_blocks.{j}"
        ip = None
        if ip_adapter and f"{bp}.attn2.processor.to_k_ip.0.weight" in src:
            ip = src.fused_linear([f"{bp}.attn2.processor.to_k_ip.0",
                                   f"{bp}.attn2.processor.to_v_ip.0"], q)
        blocks.append(src.block(f"{path}.blocks.{j}", SDXLTransformerBlock(
            _norm(src, f"{bp}.norm1"),
            SDXLAttention(src.linear(f"{bp}.attn1.to_out.0", q), qkv=src.fused_linear(
                [f"{bp}.attn1.to_q", f"{bp}.attn1.to_k", f"{bp}.attn1.to_v"], q)),
            _norm(src, f"{bp}.norm2"),
            SDXLAttention(src.linear(f"{bp}.attn2.to_out.0", q),
                          q=src.linear(f"{bp}.attn2.to_q", q),
                          kv=src.fused_linear([f"{bp}.attn2.to_k", f"{bp}.attn2.to_v"], q),
                          ipadp_kv=ip),
            _norm(src, f"{bp}.norm3"),
            FeedForward(src.linear(f"{bp}.ff.net.0.proj", q), src.linear(f"{bp}.ff.net.2", q)))))
    return SDXLTransformer2D(_norm(src, f"{p}.norm"), src.linear(f"{p}.proj_in", q), blocks,
                             src.linear(f"{p}.proj_out", q))


def sdxl_load(src: TensorSource, cfg: SDXLConfig) -> SDXLUNet:
    """Load a diffusers SDXL UNet checkpoint onto src.device, the block,
    proj_in/out and time_emb_proj linears quantized to cfg.quant (name map of
    fastdm_tpu/models/sdxl.py:214-325); under tensor parallelism each block
    is built whole and then cut to this rank's shard (src.block)."""
    q = cfg.quant
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]

    def mlp(p):
        return TimestepEmbedding(src.linear(f"{p}.linear_1", None),
                                 src.linear(f"{p}.linear_2", None))

    def resnets(p, n):
        return [_resnet_load(src, f"{p}.resnets.{j}", q) for j in range(n)]

    def attns(p, n, n_layers, path):
        return [_t2d_load(src, f"{p}.attentions.{j}", n_layers, q, cfg.ip_adapter,
                          f"{path}.attns.{j}") for j in range(n)]

    down = [SDXLStage(resnets("down_blocks.0", 2),
                      downsample=_conv(src, "down_blocks.0.downsamplers.0.conv")),
            SDXLStage(resnets("down_blocks.1", 2), attns("down_blocks.1", 2, n1, "down.1"),
                      downsample=_conv(src, "down_blocks.1.downsamplers.0.conv")),
            SDXLStage(resnets("down_blocks.2", 2), attns("down_blocks.2", 2, n2, "down.2"))]
    mid = SDXLStage(resnets("mid_block", 2), attns("mid_block", 1, n2, "mid"))
    up = [SDXLStage(resnets("up_blocks.0", 3), attns("up_blocks.0", 3, n2, "up.0"),
                    upsample=_conv(src, "up_blocks.0.upsamplers.0.conv")),
          SDXLStage(resnets("up_blocks.1", 3), attns("up_blocks.1", 3, n1, "up.1"),
                    upsample=_conv(src, "up_blocks.1.upsamplers.0.conv")),
          SDXLStage(resnets("up_blocks.2", 3))]
    model = SDXLUNet(conv_in=_conv(src, "conv_in"), time_embedding=mlp("time_embedding"),
                     add_embedding=mlp("add_embedding"), down=down, mid=mid, up=up,
                     conv_norm_out=_norm(src, "conv_norm_out"), conv_out=_conv(src, "conv_out"))
    src.assert_consumed()
    return model


# ---------------------------------------------------------------- random init


class _RandomParts:
    """The random-weight draws of sdxl_init_random, shared with the SDXL
    ControlNet's init (models/controlnets.py): one torch.Generator seeded
    with `seed` on `dev`, drawn in call order."""

    def __init__(self, seed: int, cfg: SDXLConfig, dev: torch.device):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg, self.dev = cfg, dev

    def lin(self, k, n, quant="cfg", bias=True) -> QLinear:
        quant = self.cfg.quant if quant == "cfg" else quant
        return qlinear_random(self.gen, k, n, bias=bias, quant=quant, device=self.dev)

    def conv(self, k, cin, cout) -> nn.ParameterDict:
        w = torch.randn(cout, cin, k, k, generator=self.gen, device=self.dev,
                        dtype=torch.bfloat16)
        return frozen_params(w=w.mul_(0.03), b=torch.zeros(cout, device=self.dev))

    def norm(self, c) -> nn.ParameterDict:
        return frozen_params(gamma=torch.ones(c, dtype=torch.bfloat16, device=self.dev),
                             beta=torch.zeros(c, dtype=torch.bfloat16, device=self.dev))

    def resnet(self, cin, cout) -> SDXLResnet:
        conv, norm = self.conv, self.norm
        return SDXLResnet(norm(cin), conv(3, cin, cout), self.lin(self.cfg.time_embed_dim, cout),
                          norm(cout), conv(3, cout, cout),
                          conv(1, cin, cout) if cin != cout else None)

    def t2d(self, c, n_layers, ip_adapter: bool = False) -> SDXLTransformer2D:
        lin, norm, ctx = self.lin, self.norm, self.cfg.cross_attention_dim
        blocks = [SDXLTransformerBlock(
            norm(c), SDXLAttention(lin(c, c), qkv=lin(c, 3 * c, bias=False)),
            norm(c), SDXLAttention(lin(c, c), q=lin(c, c, bias=False),
                                   kv=lin(ctx, 2 * c, bias=False),
                                   ipadp_kv=lin(ctx, 2 * c) if ip_adapter else None),
            norm(c), FeedForward(lin(c, 8 * c), lin(4 * c, c))) for _ in range(n_layers)]
        return SDXLTransformer2D(norm(c), lin(c, c), blocks, lin(c, c))

    def embedding(self, k) -> TimestepEmbedding:
        te = self.cfg.time_embed_dim
        return TimestepEmbedding(self.lin(k, te, None), self.lin(te, te, None))

    def down_mid(self, ip_adapter: bool = False) -> Tuple[List[SDXLStage], SDXLStage]:
        """The three down stages and the mid stage."""
        resnet, conv = self.resnet, self.conv
        c0, c1, c2 = self.cfg.block_channels
        n1, n2 = self.cfg.attn_layers[1], self.cfg.attn_layers[2]

        def t2d(c, n):
            return self.t2d(c, n, ip_adapter)

        down = [SDXLStage([resnet(c0, c0), resnet(c0, c0)], downsample=conv(3, c0, c0)),
                SDXLStage([resnet(c0, c1), resnet(c1, c1)], [t2d(c1, n1), t2d(c1, n1)],
                          downsample=conv(3, c1, c1)),
                SDXLStage([resnet(c1, c2), resnet(c2, c2)], [t2d(c2, n2), t2d(c2, n2)])]
        return down, SDXLStage([resnet(c2, c2), resnet(c2, c2)], [t2d(c2, n2)])


def sdxl_init_random(seed: int, cfg: SDXLConfig, device="cuda") -> SDXLUNet:
    """Random-weight SDXL UNet (benchmarks and smoke runs without checkpoints),
    drawn by a torch.Generator seeded with `seed` on `device`, as the JAX
    sdxl_init_random: conv weights N(0, 1) * 0.03 in bf16 with zero f32
    biases, unit LayerNorm / GroupNorm affines, the linears straight into
    their storage dtype (qlinear_random): the blocks', proj_in/out and
    time_emb_proj in cfg.quant, the time and add embedders in bf16. The JAX
    and torch generators give different numbers for the same seed."""
    r = _RandomParts(seed, cfg, resolve_device(device))
    resnet, conv, norm = r.resnet, r.conv, r.norm
    c0, c1, c2 = cfg.block_channels
    n1, n2 = cfg.attn_layers[1], cfg.attn_layers[2]

    def t2d(c, n):
        return r.t2d(c, n, cfg.ip_adapter)

    down, mid = r.down_mid(cfg.ip_adapter)
    up = [SDXLStage([resnet(2 * c2, c2), resnet(2 * c2, c2), resnet(c2 + c1, c2)],
                    [t2d(c2, n2) for _ in range(3)], upsample=conv(3, c2, c2)),
          SDXLStage([resnet(c2 + c1, c1), resnet(2 * c1, c1), resnet(c1 + c0, c1)],
                    [t2d(c1, n1) for _ in range(3)], upsample=conv(3, c1, c1)),
          SDXLStage([resnet(c1 + c0, c0), resnet(2 * c0, c0), resnet(2 * c0, c0)])]
    return SDXLUNet(
        conv_in=conv(3, cfg.in_channels, c0), time_embedding=r.embedding(c0),
        add_embedding=r.embedding(cfg.add_embedding_in_dim),
        down=down, mid=mid, up=up, conv_norm_out=norm(c0), conv_out=conv(3, c0, cfg.out_channels))


# ---------------------------------------------------------------- IP-Adapter


def sdxl_attach_ip_adapter(params: SDXLUNet, src: TensorSource, cfg: SDXLConfig):
    """Attach an IP-Adapter checkpoint to a loaded UNet (each cross-attention's
    ipadp_kv, the fused to_k_ip | to_v_ip in cfg.quant) and return its image
    projection: ImageProjection for the `image_proj.proj` layout
    (ip-adapter_sdxl: num_tokens = out_dim // cross_attention_dim),
    IPAdapterPlusProjection for the `image_proj.latents` resampler
    (ip-adapter-plus: heads = hidden // 64). Port of
    fastdm_tpu/models/sdxl.py sdxl_attach_ip_adapter.

    The checkpoint's 'ip_adapter.{i}' index enumerates the UNet's attention
    processors in diffusers' registration order: the down blocks, then the UP
    blocks, the mid block LAST (UNet2DConditionModel creates both empty
    ModuleLists before it assigns mid_block); attn1 then attn2 per
    BasicTransformerBlock, so the cross-attention weights sit on odd
    indices. Under tensor parallelism each k | v is cut to the rank's heads
    as it is attached."""
    from fastdm_tpu_torch.layers.ip_adapter import (
        ImageProjection,
        IPAdapterPlusProjection,
        ResamplerBlock,
    )
    from fastdm_tpu_torch.parallel.tensor_parallel import shard_ip_adapter_kv

    paths = {id(m): p for p, m in params.named_modules()}
    idx = 0
    for t2d in [a for stage in (*params.down, *params.up, params.mid)
                for a in (stage.attns or [])]:
        for blk in t2d.blocks:
            idx += 1  # the attn1 (self-attention) processor's slot
            blk.attn2.ipadp_kv = src.fused_linear(
                [f"ip_adapter.{idx}.to_k_ip", f"ip_adapter.{idx}.to_v_ip"], cfg.quant)
            shard_ip_adapter_kv(blk.attn2, paths[id(blk.attn2)], cfg.head_dim)
            idx += 1

    if "image_proj.proj.weight" in src:
        proj = src.linear("image_proj.proj", None)
        out = ImageProjection(proj, _norm(src, "image_proj.norm"),
                              proj.w.shape[1] // cfg.cross_attention_dim)
    elif "image_proj.latents" in src:
        # official layout: layers.{i}.0.{norm1, norm2, to_q, to_kv, to_out}
        # (attention) and layers.{i}.1.{0, 1, 3} (LayerNorm, Linear, Linear)
        layers, i = [], 0
        while f"image_proj.layers.{i}.0.to_q.weight" in src:
            p = f"image_proj.layers.{i}"
            layers.append(ResamplerBlock(
                _norm(src, f"{p}.0.norm1"), _norm(src, f"{p}.0.norm2"),
                src.linear(f"{p}.0.to_q", None), src.linear(f"{p}.0.to_kv", None),
                src.linear(f"{p}.0.to_out", None), _norm(src, f"{p}.1.0"),
                src.linear(f"{p}.1.1", None), src.linear(f"{p}.1.3", None)))
            i += 1
        latents = src.tensor("image_proj.latents")
        out = IPAdapterPlusProjection(
            latents, src.linear("image_proj.proj_in", None), layers,
            src.linear("image_proj.proj_out", None), _norm(src, "image_proj.norm_out"),
            heads=latents.shape[-1] // 64, head_dim=64)
    else:
        raise NotImplementedError("unrecognized image_proj layout in the IP-Adapter checkpoint")
    src.assert_consumed()
    return out
