"""AutoencoderKL decoder (port of fastdm_tpu/pipeline/vae.py: vae_decode,
_decoder_core, vae_load, vae_decoder_random).

Params are a plain nested dict of tensors, as in the JAX package; convs hold
PyTorch's (out, in, kh, kw) layout. Activations are NCHW inside; the public
contract is the JAX one: (B, C_lat, H, W) latents in, (B, 8H, 8W, 3) float32
image in [-1, 1] out. The mid-block spatial attention stays the plain
softmax(q k^T) v it is in JAX (vae.py:61-78) — not an sdpa call there either —
computed over query chunks so its float32 logits stay bounded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.conv2d import conv2d, group_norm, upsample_nearest2x
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor

_ATTN_QUERY_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16            # 4 for SDXL, 16 for FLUX/SD3.5
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611       # FLUX
    shift_factor: float = 0.1159         # FLUX
    mid_block_add_attention: bool = True


def _resnet(p, x: Tensor, groups: int) -> Tensor:
    """GroupNorm + SiLU + conv, twice, with the residual (no temb)."""
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)))
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x)
    return x + h


def _proj(p, t: Tensor) -> Tensor:
    """bf16 operands, f32 product + f32 bias, one rounding to bf16."""
    return torch.addmm(p["b"].float(), t.float().reshape(-1, t.shape[-1]),
                       p["w"].float()).reshape(*t.shape[:-1], -1).to(torch.bfloat16)


def _spatial_attention(p, x: Tensor, groups: int) -> Tensor:
    """Single-head spatial self-attention of the mid block."""
    b, c, h, w = x.shape
    y = group_norm(p["norm"], x, groups).flatten(2).transpose(1, 2)  # (B, HW, C)
    q, k, v = _proj(p["q"], y), _proj(p["k"], y), _proj(p["v"], y)
    kt, vf = k.float().transpose(1, 2), v.float()
    out = torch.empty(b, h * w, c, dtype=torch.float32, device=x.device)
    for i in range(0, h * w, _ATTN_QUERY_CHUNK):  # softmax is per row: exact
        logits = torch.bmm(q[:, i:i + _ATTN_QUERY_CHUNK].float(), kt)
        probs = torch.softmax(logits * (c**-0.5), dim=-1).to(v.dtype)
        out[:, i:i + _ATTN_QUERY_CHUNK] = torch.bmm(probs.float(), vf)
    o = _proj(p["out"], out.to(torch.bfloat16))
    return x + o.transpose(1, 2).reshape(b, c, h, w)


def vae_decode(params: Dict, cfg: VAEConfig, latents: Tensor) -> Tensor:
    """(B, C_lat, H, W) latents -> (B, 8H, 8W, 3) float32 image in [-1, 1];
    applies z / scale + shift first, as diffusers' pipeline does."""
    z = latents.float() / cfg.scaling_factor + cfg.shift_factor
    return _decoder_core(params, cfg, z.to(torch.bfloat16))


@torch.inference_mode()
def _decoder_core(params: Dict, cfg: VAEConfig, x: Tensor) -> Tensor:
    """Decoder on already-scaled NCHW bf16 latents -> (B, 8H, 8W, 3) f32."""
    if "post_quant_conv" in params:
        x = conv2d(params["post_quant_conv"], x)
    g = cfg.norm_num_groups
    x = conv2d(params["conv_in"], x)
    x = _resnet(params["mid"]["resnet0"], x, g)
    if cfg.mid_block_add_attention:
        x = _spatial_attention(params["mid"]["attn"], x, g)
    x = _resnet(params["mid"]["resnet1"], x, g)
    for blk in params["up"]:
        for r in range(cfg.layers_per_block + 1):
            x = _resnet(blk[f"resnet{r}"], x, g)
        if "upsample" in blk:
            x = conv2d(blk["upsample"], upsample_nearest2x(x))
    x = group_norm(params["norm_out"], x, g)
    x = conv2d(params["conv_out"], F.silu(x))
    return x.float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------- loading


def _take_conv(src: TensorSource, prefix: str) -> Dict[str, Tensor]:
    w = src.tensor(f"{prefix}.weight", torch.float32)
    b = src.tensor(f"{prefix}.bias", torch.float32)
    if w.dim() == 4:
        return {"w": w.to(torch.bfloat16), "b": b}
    # attention projections are stored as (out, in) linears
    return {"w": w.t().contiguous().to(torch.bfloat16), "b": b}


def _take_norm(src: TensorSource, prefix: str) -> Dict[str, Tensor]:
    return {"gamma": src.tensor(f"{prefix}.weight", torch.float32),
            "beta": src.tensor(f"{prefix}.bias", torch.float32)}


def _take_resnet(src: TensorSource, prefix: str) -> Dict:
    p = {"norm1": _take_norm(src, f"{prefix}.norm1"), "conv1": _take_conv(src, f"{prefix}.conv1"),
         "norm2": _take_norm(src, f"{prefix}.norm2"), "conv2": _take_conv(src, f"{prefix}.conv2")}
    if f"{prefix}.conv_shortcut.weight" in src:
        p["shortcut"] = _take_conv(src, f"{prefix}.conv_shortcut")
    return p


def _take_attn(src: TensorSource, prefix: str) -> Dict:
    return {"norm": _take_norm(src, f"{prefix}.group_norm"),
            "q": _take_conv(src, f"{prefix}.to_q"), "k": _take_conv(src, f"{prefix}.to_k"),
            "v": _take_conv(src, f"{prefix}.to_v"), "out": _take_conv(src, f"{prefix}.to_out.0")}


def vae_load(src: TensorSource, cfg: VAEConfig) -> Dict:
    """Load a diffusers AutoencoderKL checkpoint onto src.device. The encoder
    half, when present, is loaded as well (the image-to-image slice runs it)."""
    n = len(cfg.block_out_channels)
    params: Dict = {
        "conv_in": _take_conv(src, "decoder.conv_in"),
        "mid": {"resnet0": _take_resnet(src, "decoder.mid_block.resnets.0"),
                "resnet1": _take_resnet(src, "decoder.mid_block.resnets.1")},
        "norm_out": _take_norm(src, "decoder.conv_norm_out"),
        "conv_out": _take_conv(src, "decoder.conv_out"),
        "up": [],
    }
    if cfg.mid_block_add_attention:
        params["mid"]["attn"] = _take_attn(src, "decoder.mid_block.attentions.0")
    for i in range(n):
        blk = {f"resnet{r}": _take_resnet(src, f"decoder.up_blocks.{i}.resnets.{r}")
               for r in range(cfg.layers_per_block + 1)}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in src:
            blk["upsample"] = _take_conv(src, f"decoder.up_blocks.{i}.upsamplers.0.conv")
        params["up"].append(blk)
    if "post_quant_conv.weight" in src:
        params["post_quant_conv"] = _take_conv(src, "post_quant_conv")
    if "encoder.conv_in.weight" in src:
        enc: Dict = {
            "conv_in": _take_conv(src, "encoder.conv_in"),
            "mid": {"resnet0": _take_resnet(src, "encoder.mid_block.resnets.0"),
                    "resnet1": _take_resnet(src, "encoder.mid_block.resnets.1")},
            "norm_out": _take_norm(src, "encoder.conv_norm_out"),
            "conv_out": _take_conv(src, "encoder.conv_out"),
            "down": [],
        }
        if cfg.mid_block_add_attention:
            enc["mid"]["attn"] = _take_attn(src, "encoder.mid_block.attentions.0")
        for i in range(n):
            blk = {f"resnet{r}": _take_resnet(src, f"encoder.down_blocks.{i}.resnets.{r}")
                   for r in range(cfg.layers_per_block)}
            if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in src:
                blk["downsample"] = _take_conv(src, f"encoder.down_blocks.{i}.downsamplers.0.conv")
            enc["down"].append(blk)
        if "quant_conv.weight" in src:
            enc["quant_conv"] = _take_conv(src, "quant_conv")
        params["encoder"] = enc
    src.assert_consumed()
    return params


# ---------------------------------------------------------------- random init


def vae_decoder_random(seed: int, cfg: VAEConfig, device="cuda") -> Dict:
    """Random decoder params drawn by a torch.Generator on `device` (conv
    weights N(0,1)*0.05 bf16, biases N(0,1)*0.01 f32, attention projections
    N(0,1)*0.02, unit norms, as the JAX vae_decoder_random)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def conv(k, cin, cout):
        return {"w": randn((cout, cin, k, k), torch.bfloat16) * 0.05,
                "b": randn((cout,), torch.float32) * 0.01}

    def norm(c):
        return {"gamma": torch.ones(c, device=dev), "beta": torch.zeros(c, device=dev)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
             "norm2": norm(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(1, cin, cout)
        return p

    def lin(c):
        return {"w": randn((c, c), torch.bfloat16) * 0.02, "b": torch.zeros(c, device=dev)}

    chans = list(reversed(cfg.block_out_channels))
    top = chans[0]
    params: Dict = {
        "conv_in": conv(3, cfg.latent_channels, top),
        "mid": {"resnet0": resnet(top, top),
                "attn": {"norm": norm(top), "q": lin(top), "k": lin(top), "v": lin(top),
                         "out": lin(top)},
                "resnet1": resnet(top, top)},
        "norm_out": norm(chans[-1]),
        "conv_out": conv(3, chans[-1], cfg.out_channels),
        "post_quant_conv": conv(1, cfg.latent_channels, cfg.latent_channels),
        "up": [],
    }
    prev = top
    for i, c in enumerate(chans):
        blk = {f"resnet{r}": resnet(prev if r == 0 else c, c)
               for r in range(cfg.layers_per_block + 1)}
        if i < len(chans) - 1:
            blk["upsample"] = conv(3, c, c)
        params["up"].append(blk)
        prev = c
    return params
