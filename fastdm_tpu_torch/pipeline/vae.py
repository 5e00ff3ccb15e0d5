"""AutoencoderKL decoder and encoder (port of fastdm_tpu/pipeline/vae.py:
vae_decode, _decoder_core, the tiled and sliced decodes, vae_encode and its
tiled form, vae_load, vae_decoder_random; vae_encoder_random draws the
encoder half the same way).

Params are a plain nested dict of tensors, as in the JAX package; convs hold
PyTorch's (out, in, kh, kw) layout. Activations are NCHW inside; the public
contract is the JAX one: (B, C_lat, H, W) latents in, (B, 8H, 8W, 3) float32
image in [-1, 1] out, and the reverse for the encoder. The mid-block spatial
attention stays the plain softmax(q k^T) v it is in JAX (vae.py:61-78) — not
an sdpa call there either — computed over query chunks so its float32 logits
stay bounded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


# ------------------------------------------------------- tiling / slicing
#
# diffusers' AutoencoderKL.tiled_decode / tiled_encode and enable_vae_slicing,
# as the JAX package owns them: overlapping tiles (64-latent / 512-pixel tiles,
# 25% overlap), a linear f32 cross-fade over the overlap band, then each tile
# cropped to its non-blended extent. Peak decode memory is that of one tile.


def _blend_v(a: Tensor, b: Tensor, extent: int) -> Tensor:
    """Cross-fade b's top rows into a's bottom rows (NHWC, dim 1)."""
    extent = min(a.shape[1], b.shape[1], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent)[None, :, None, None]
    head = a[:, a.shape[1] - extent:].float() * (1 - w) + b[:, :extent].float() * w
    return torch.cat([head.to(b.dtype), b[:, extent:]], dim=1)


def _blend_h(a: Tensor, b: Tensor, extent: int) -> Tensor:
    """Cross-fade b's left columns into a's right columns (NHWC, dim 2)."""
    extent = min(a.shape[2], b.shape[2], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent)[None, None, :, None]
    head = a[:, :, a.shape[2] - extent:].float() * (1 - w) + b[:, :, :extent].float() * w
    return torch.cat([head.to(b.dtype), b[:, :, extent:]], dim=2)


def _stitch(rows, blend_extent: int, row_limit: int) -> Tensor:
    """Blend every NHWC tile into its upper and left neighbours, crop each to
    row_limit and join them."""
    out_rows = []
    for i, row in enumerate(rows):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend_extent)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend_extent)
            result_row.append(tile[:, :row_limit, :row_limit])
        out_rows.append(torch.cat(result_row, dim=2))
    return torch.cat(out_rows, dim=1)


@torch.inference_mode()
def vae_decode_tiled(params: Dict, cfg: VAEConfig, latents: Tensor, tile_latent_size: int = 64,
                     overlap_factor: float = 0.25) -> Tensor:
    """Tiled decode (diffusers AutoencoderKL.tiled_decode): (B, C_lat, H, W)
    latents -> (B, 8H, 8W, 3) float32; latents of at most one tile decode
    whole."""
    x = (latents.float() / cfg.scaling_factor + cfg.shift_factor).to(torch.bfloat16)
    h, w = x.shape[2], x.shape[3]
    if h <= tile_latent_size and w <= tile_latent_size:
        return _decoder_core(params, cfg, x)
    sf = 2 ** (len(cfg.block_out_channels) - 1)                  # pixels per latent
    overlap = int(tile_latent_size * (1 - overlap_factor))       # latent step
    blend_extent = int(tile_latent_size * sf * overlap_factor)   # pixel fade band
    row_limit = tile_latent_size * sf - blend_extent             # pixels kept a tile
    rows = [[_decoder_core(params, cfg, x[:, :, i:i + tile_latent_size,
                                          j:j + tile_latent_size])
             for j in range(0, w, overlap)] for i in range(0, h, overlap)]
    return _stitch(rows, blend_extent, row_limit)[:, :h * sf, :w * sf].float()


@torch.inference_mode()
def vae_encode_tiled(params: Dict, cfg: VAEConfig, image: Tensor, tile_sample_size: int = 512,
                     overlap_factor: float = 0.25) -> Tensor:
    """Tiled deterministic encode (diffusers tiled_encode): (B, H, W, 3) in
    [-1, 1] -> (B, C_lat, H/8, W/8) scaled latents, blended after scaling
    (the scale and shift are affine, so they commute with the cross-fade);
    images of at most one tile encode whole."""
    h, w = image.shape[1], image.shape[2]
    if h <= tile_sample_size and w <= tile_sample_size:
        return vae_encode(params, cfg, image)
    sf = 2 ** (len(cfg.block_out_channels) - 1)                  # pixels per latent
    overlap = int(tile_sample_size * (1 - overlap_factor))       # pixel step
    lat_tile = tile_sample_size // sf
    blend_extent = int(lat_tile * overlap_factor)                # latent fade band
    row_limit = lat_tile - blend_extent
    rows = [[vae_encode(params, cfg, image[:, i:i + tile_sample_size,
                                           j:j + tile_sample_size]).permute(0, 2, 3, 1)
             for j in range(0, w, overlap)] for i in range(0, h, overlap)]
    out = _stitch(rows, blend_extent, row_limit)[:, :h // sf, :w // sf]
    return out.permute(0, 3, 1, 2)


def vae_decode_sliced(params: Dict, cfg: VAEConfig, latents: Tensor) -> Tensor:
    """Batch-sliced decode (diffusers enable_vae_slicing): one sample at a
    time, so peak activation memory does not grow with the batch."""
    if latents.shape[0] == 1:
        return vae_decode(params, cfg, latents)
    return torch.cat([vae_decode(params, cfg, latents[i:i + 1])
                      for i in range(latents.shape[0])])


@torch.inference_mode()
def vae_encode(params: Dict, cfg: VAEConfig, image: Tensor,
               sample_noise: Optional[Tensor] = None) -> Tensor:
    """The encoder subtree's (B, H, W, 3) image in [-1, 1] -> (B, C_lat, H/8,
    W/8) float32 scaled latents (z - shift) * scale. Deterministic (the
    posterior mean) unless sample_noise, (B, H/8, W/8, C_lat) as in JAX, is
    given: mean + exp(0.5 * clip(logvar, -30, 20)) * noise."""
    g = cfg.norm_num_groups
    x = conv2d(params["conv_in"], image.permute(0, 3, 1, 2).to(torch.bfloat16))
    for blk in params["down"]:
        for r in range(cfg.layers_per_block):
            x = _resnet(blk[f"resnet{r}"], x, g)
        if "downsample" in blk:
            # diffusers' geometry: pad (0, 1, 0, 1), then a VALID stride-2 conv
            # (not the SDXL UNet's XLA "SAME", layers/conv2d.py same_padding)
            x = conv2d(blk["downsample"], F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    x = _resnet(params["mid"]["resnet0"], x, g)
    if cfg.mid_block_add_attention:
        x = _spatial_attention(params["mid"]["attn"], x, g)
    x = _resnet(params["mid"]["resnet1"], x, g)
    x = group_norm(params["norm_out"], x, g)
    x = conv2d(params["conv_out"], F.silu(x))
    if "quant_conv" in params:
        x = conv2d(params["quant_conv"], x)
    mean, logvar = x.float().chunk(2, dim=1)
    if sample_noise is not None:
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        mean = mean + std * sample_noise.float().permute(0, 3, 1, 2)
    return (mean - cfg.shift_factor) * cfg.scaling_factor


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


def _random_parts(seed: int, device):
    """Random-weight makers on one torch.Generator, as the JAX init draws
    them: conv weights N(0,1)*0.05 bf16, biases N(0,1)*0.01 f32, attention
    projections N(0,1)*0.02 with zero biases, unit norms."""
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

    def mid(c):
        return {"resnet0": resnet(c, c),
                "attn": {"norm": norm(c), "q": lin(c), "k": lin(c), "v": lin(c), "out": lin(c)},
                "resnet1": resnet(c, c)}

    return conv, norm, resnet, mid


def vae_decoder_random(seed: int, cfg: VAEConfig, device="cuda") -> Dict:
    """Random decoder params drawn by a torch.Generator on `device`, laid out
    as the JAX vae_decoder_random's (_random_parts says how)."""
    conv, norm, resnet, mid = _random_parts(seed, device)
    chans = list(reversed(cfg.block_out_channels))
    top = chans[0]
    params: Dict = {
        "conv_in": conv(3, cfg.latent_channels, top),
        "mid": mid(top),
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


def vae_encoder_random(seed: int, cfg: VAEConfig, device="cuda") -> Dict:
    """Random encoder params (the subtree vae_load puts under "encoder",
    quant_conv included), drawn as vae_decoder_random; for runs without a
    checkpoint, as the decoder's."""
    conv, norm, resnet, mid = _random_parts(seed, device)
    chans = list(cfg.block_out_channels)
    enc: Dict = {"conv_in": conv(3, cfg.in_channels, chans[0]), "down": []}
    prev = chans[0]
    for i, c in enumerate(chans):
        blk = {f"resnet{r}": resnet(prev if r == 0 else c, c)
               for r in range(cfg.layers_per_block)}
        if i < len(chans) - 1:
            blk["downsample"] = conv(3, c, c)
        enc["down"].append(blk)
        prev = c
    enc.update(mid=mid(chans[-1]), norm_out=norm(chans[-1]),
               conv_out=conv(3, chans[-1], 2 * cfg.latent_channels),
               quant_conv=conv(1, 2 * cfg.latent_channels, 2 * cfg.latent_channels))
    return enc
