"""Wan 3D causal VAE decoder (port of fastdm_tpu/pipeline/wan_vae.py:
wan_vae_decode :292, wan_vae_decode_chunked :444, wan_vae_load :535 and the
random init :623, the decoder half).

AutoencoderKLWan (Wan2.1 layout, which Wan2.2-A14B ships): causal 3D
convolutions (zero temporal padding in front only), channel RMS norms,
per-frame spatial attention in the mid block, upsamplers that halve the
channels and a 2x-channel temporal conv whose output interleaves into doubled
frames; the first latent frame bypasses every temporal conv, giving the
causal 1 + 4(F-1) frame layout. wan_vae_decode runs the whole sequence at
once; wan_vae_decode_chunked walks one latent frame at a time with per-conv
caches of the last input frames (the same windows, peak activations of one
latent frame) — the engine's path above 8 latent frames.

Inside, activations are NCDHW and convolution weights keep the checkpoint's
(out, in, kt, kh, kw) layout; the public contract is the JAX one: (B, C_z, F,
H, W) latents in, (B, 1+4(F-1), 8H, 8W, 3) float32 in [-1, 1] out. The
compute dtype is the `dtype` argument (the JAX module's global _DTYPE):
operands are rounded to it, each convolution takes f32 products and sums of
those values with the f32 bias added before one rounding to `dtype`, norms run
in f32. Convolutions and the per-frame attention are plain PyTorch (none is a
Pallas kernel in JAX). On the card the f32 convolution goes through cuDNN;
decode sets cuDNN's TF32 flag for its duration: on for bfloat16, where every
operand is exact in TF32 and the sums stay f32, off for float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    patch_size: int = 1        # 2 in the Wan2.2-TI2V residual VAE: a later slice
    is_residual: bool = False  # the Wan2.2-TI2V residual VAE: a later slice

    @property
    def decoder_dims(self) -> Tuple[int, ...]:
        # (384, 384, 384, 192, 96) for the defaults
        m = tuple(self.dim_mult)
        return tuple(self.base_dim * u for u in (m[-1],) + m[::-1])


def _check_cfg(cfg: WanVAEConfig) -> None:
    if cfg.is_residual or cfg.patch_size != 1:
        raise NotImplementedError(
            "the residual / patchified Wan2.2-TI2V VAE is not in this slice of the port "
            "(the Wan2.1-layout AutoencoderKLWan of Wan2.2-A14B is); it arrives with ti2v")


@contextlib.contextmanager
def _cudnn_tf32(enabled: bool):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(p, x: Tensor, front_pad: int, dtype) -> Tensor:
    """3D conv of NCDHW x with `front_pad` zero frames in front and SAME
    spatial padding; 2D kernels (out, in, kh, kw) run per frame. f32 products
    and sums of dtype-rounded operands, f32 bias, one rounding to dtype."""
    w = p["w"]
    if w.dim() == 4:
        w = w[:, :, None]
    kh, kw = w.shape[-2:]
    x = x.to(dtype).float()
    if front_pad:
        x = F.pad(x, (0, 0, 0, 0, front_pad, 0))
    out = F.conv3d(x, w.to(dtype).float(), p["b"].float(), padding=(0, kh // 2, kw // 2))
    return out.to(dtype)


def _causal_conv3d(p, x: Tensor, dtype) -> Tensor:
    return _conv(p, x, p["w"].shape[2] - 1, dtype)


def _rms_norm_channel(p, x: Tensor) -> Tensor:
    """F.normalize over channels * sqrt(C) * gamma (+ bias), in f32."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=1, keepdim=True) + 1e-12)
    y = y * p["gamma"].float().reshape(1, -1, 1, 1, 1)
    if "bias" in p:
        y = y + p["bias"].float().reshape(1, -1, 1, 1, 1)
    return y.to(x.dtype)


def _linear(p, t: Tensor, dtype) -> Tensor:
    """(..., C_in) @ (C_in, C_out) in f32 from dtype operands, + f32 bias."""
    y = torch.addmm(p["b"].float(), t.to(dtype).float().reshape(-1, t.shape[-1]),
                    p["w"].to(dtype).float())
    return y.reshape(*t.shape[:-1], -1)


def _attn_block(p, x: Tensor, dtype) -> Tensor:
    """Per-frame single-head spatial self-attention with 1x1 qkv/proj."""
    b, c, t, hh, ww = x.shape
    y = _rms_norm_channel(p["norm"], x).permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, c)
    qkv = _linear(p["qkv"], y, dtype).to(dtype)
    q, k, v = qkv.float().chunk(3, dim=-1)
    probs = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (c**-0.5), dim=-1).to(dtype)
    o = torch.bmm(probs.float(), v).to(dtype)
    o = _linear(p["proj"], o, dtype).to(x.dtype)
    return x + o.reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)


def _res_block(p, x: Tensor, conv) -> Tensor:
    """RMS + SiLU + causal conv, twice, with the 1x1x1 conv shortcut; `conv`
    (name, params, x) runs each kt=3 convolution (full or cached walk)."""
    h = conv("c1", p["conv1"], F.silu(_rms_norm_channel(p["norm1"], x)))
    h = conv("c2", p["conv2"], F.silu(_rms_norm_channel(p["norm2"], h)))
    if "shortcut" in p:
        x = conv("sc", p["shortcut"], x)
    return x + h


def _interleave_frames(y: Tensor) -> Tensor:
    """(B, 2C, T, H, W) -> (B, C, 2T, H, W): channel block j of frame t
    becomes frame 2t + j (the torch decoder's temporal upsample layout)."""
    b, c2, t, h, w = y.shape
    y = y.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5)
    return y.reshape(b, c2 // 2, 2 * t, h, w)


def _upsample_spatial(p, x: Tensor, dtype) -> Tensor:
    """Nearest 2x per frame, then the 3x3 conv that halves the channels."""
    x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return _conv(p, x, 0, dtype)


def _decode_core(params: Dict, x: Tensor, conv, t_up, dtype) -> Tensor:
    """The decoder on x (NCDHW, dtype); conv(name, p, x) and t_up(name, p, x)
    give the full-sequence or the cached semantics."""
    if "post_quant_conv" in params:
        x = _conv(params["post_quant_conv"], x, 0, dtype)
    dec = params["decoder"]
    x = conv("conv_in", dec["conv_in"], x)
    sub = lambda pre: (lambda n, p, y: conv(f"{pre}.{n}", p, y))  # noqa: E731
    x = _res_block(dec["mid"]["res0"], x, sub("mid.r0"))
    x = _attn_block(dec["mid"]["attn"], x, dtype)
    x = _res_block(dec["mid"]["res1"], x, sub("mid.r1"))
    for i, blk in enumerate(dec["up"]):
        for j, r in enumerate(blk["resnets"]):
            x = _res_block(r, x, sub(f"up{i}.r{j}"))
        if "time_conv" in blk:
            x = t_up(f"up{i}.t", blk["time_conv"], x)
        if "upsample" in blk:
            x = _upsample_spatial(blk["upsample"], x, dtype)
    x = _rms_norm_channel(dec["norm_out"], x)
    return conv("conv_out", dec["conv_out"], F.silu(x))


def _prepare(cfg: WanVAEConfig, latents: Tensor, dtype) -> Tensor:
    _check_cfg(cfg)
    z = latents.float()
    if cfg.latents_mean is not None:
        mean = torch.tensor(cfg.latents_mean, dtype=torch.float32, device=z.device)
        std = torch.tensor(cfg.latents_std, dtype=torch.float32, device=z.device)
        z = z * std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)
    return z.to(dtype)


def _to_frames(x: Tensor) -> Tensor:
    return x.float().permute(0, 2, 3, 4, 1).contiguous()  # (B, F, H, W, 3)


@torch.inference_mode()
def wan_vae_decode(params: Dict, cfg: WanVAEConfig, latents: Tensor,
                   dtype=torch.bfloat16) -> Tensor:
    """(B, C_z, F, H, W) latents -> (B, 1+4(F-1), 8H, 8W, 3) float32 in
    [-1, 1], the whole sequence at once."""
    x = _prepare(cfg, latents, dtype)

    def conv(name, p, y):
        return _causal_conv3d(p, y, dtype)

    def t_up(name, p, y):
        # frame 0 passes through; frames 1.. run the causal conv to 2C
        # channels that interleave into two frames each
        if y.shape[2] == 1:
            return y
        return torch.cat([y[:, :, :1], _interleave_frames(_causal_conv3d(p, y[:, :, 1:], dtype))],
                         dim=2)

    with _cudnn_tf32(dtype == torch.bfloat16):
        return _to_frames(_decode_core(params, x, conv, t_up, dtype))


@torch.inference_mode()
def wan_vae_decode_chunked(params: Dict, cfg: WanVAEConfig, latents: Tensor,
                           dtype=torch.bfloat16) -> Tensor:
    """wan_vae_decode walking one latent frame at a time: every kt=3 causal
    conv keeps its last two input frames (zeros before the first), and the
    temporal upsamplers skip frame 0. The same convolution windows as the full
    decode; peak activations of one latent frame (4 output frames)."""
    x = _prepare(cfg, latents, dtype)
    caches: Dict[str, Tensor] = {}

    def conv(name, p, y):
        kt = p["w"].shape[2]
        if kt == 1:
            return _conv(p, y, 0, dtype)
        hist = caches.get(name)
        if hist is None:
            hist = torch.zeros_like(y[:, :, :1]).expand(-1, -1, kt - 1, -1, -1)
        inp = torch.cat([hist.to(y.dtype), y], dim=2)
        caches[name] = inp[:, :, -(kt - 1):]
        return _conv(p, inp, 0, dtype)

    def t_up(name, p, y):
        if first:  # frame 0 bypasses the temporal conv; its history starts at zero
            return y
        return _interleave_frames(conv(name, p, y))

    frames = []
    with _cudnn_tf32(dtype == torch.bfloat16):
        for f in range(x.shape[2]):
            first = f == 0
            frames.append(_to_frames(_decode_core(params, x[:, :, f:f + 1], conv, t_up, dtype)))
    return torch.cat(frames, dim=1)


# ---------------------------------------------------------------- loading


def wan_vae_load(src: TensorSource, cfg: WanVAEConfig, dtype=torch.bfloat16) -> Dict:
    """Load the decoder of a diffusers AutoencoderKLWan checkpoint (the flat
    decoder.up_blocks index space of the Wan2.1 layout: resnets and
    WanResample entries share it, resample convs at '.resample.1', temporal
    convs at '.time_conv') onto src.device, weights in `dtype`, biases and
    norm gains in f32. The encoder and quant_conv tensors are claimed and
    dropped: the encoder arrives with i2v/ti2v. Every tensor must be claimed."""
    _check_cfg(cfg)

    def conv(prefix):
        return {"w": src.tensor(f"{prefix}.weight", dtype),
                "b": src.tensor(f"{prefix}.bias", torch.float32)}

    def norm(prefix):
        p = {"gamma": src.tensor(f"{prefix}.gamma", torch.float32).reshape(-1)}
        if f"{prefix}.bias" in src:
            p["bias"] = src.tensor(f"{prefix}.bias", torch.float32).reshape(-1)
        return p

    def res(prefix):
        p = {"norm1": norm(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1"),
             "norm2": norm(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in src:
            p["shortcut"] = conv(f"{prefix}.conv_shortcut")
        return p

    def linear_1x1(prefix):  # the attention's 1x1 Conv2d as a (C_in, C_out) matmul
        return {"w": src.tensor(f"{prefix}.weight", dtype)[:, :, 0, 0].t().contiguous(),
                "b": src.tensor(f"{prefix}.bias", torch.float32)}

    m = "decoder.mid_block"
    dec: Dict = {
        "conv_in": conv("decoder.conv_in"),
        "mid": {"res0": res(f"{m}.resnets.0"),
                "attn": {"norm": norm(f"{m}.attentions.0.norm"),
                         "qkv": linear_1x1(f"{m}.attentions.0.to_qkv"),
                         "proj": linear_1x1(f"{m}.attentions.0.proj")},
                "res1": res(f"{m}.resnets.1")},
        "up": [],
    }
    n_stages, idx = len(cfg.dim_mult), 0
    for i in range(n_stages):
        blk: Dict = {"resnets": []}
        for _ in range(cfg.num_res_blocks + 1):
            blk["resnets"].append(res(f"decoder.up_blocks.{idx}"))
            idx += 1
        if i != n_stages - 1:
            p = f"decoder.up_blocks.{idx}"
            if f"{p}.time_conv.weight" in src:  # upsample3d
                blk["time_conv"] = conv(f"{p}.time_conv")
            blk["upsample"] = conv(f"{p}.resample.1")
            idx += 1
        dec["up"].append(blk)
    dec["norm_out"] = norm("decoder.norm_out")
    dec["conv_out"] = conv("decoder.conv_out")
    params: Dict = {"decoder": dec}
    if "post_quant_conv.weight" in src:
        params["post_quant_conv"] = conv("post_quant_conv")
    for name in src.names():
        if name.startswith(("encoder.", "quant_conv.")):
            src.take(name)
    src.assert_consumed()
    return params


def wan_vae_decoder_random(seed: int, cfg: WanVAEConfig, device="cuda",
                           dtype=torch.bfloat16) -> Dict:
    """Random-weight Wan VAE decoder (smoke runs without checkpoints), the
    channel flow of the JAX wan_vae_random: conv weights ~ N(0, 1) * 0.05,
    attention projections * 0.02, zero biases, unit norm gains; drawn by a
    torch.Generator seeded with `seed` on `device`."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, std=0.05):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def conv(cin, cout, kt=3, kh=3, kw=3, dims=3):
        shape = (cout, cin, kt, kh, kw) if dims == 3 else (cout, cin, kh, kw)
        return {"w": w(*shape), "b": torch.zeros(cout, device=dev)}

    def norm(c):
        return {"gamma": torch.ones(c, device=dev)}

    def res(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cin, cout), "norm2": norm(cout),
             "conv2": conv(cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(cin, cout, 1, 1, 1)
        return p

    d = cfg.decoder_dims
    top = d[0]
    t_up = tuple(reversed(cfg.temporal_downsample))
    dec: Dict = {
        "conv_in": conv(cfg.z_dim, top),
        "mid": {"res0": res(top, top),
                "attn": {"norm": norm(top),
                         "qkv": {"w": w(top, 3 * top, std=0.02),
                                 "b": torch.zeros(3 * top, device=dev)},
                         "proj": {"w": w(top, top, std=0.02), "b": torch.zeros(top, device=dev)}},
                "res1": res(top, top)},
        "up": [],
    }
    n_stages = len(cfg.dim_mult)
    for i in range(n_stages):
        cin, cout = d[i], d[i + 1]
        if i > 0:
            cin //= 2  # the previous stage's upsample conv halved the channels
        blk: Dict = {"resnets": [res(cin if r == 0 else cout, cout)
                                 for r in range(cfg.num_res_blocks + 1)]}
        if i != n_stages - 1:
            if t_up[i]:
                blk["time_conv"] = conv(cout, 2 * cout, 3, 1, 1)
            blk["upsample"] = conv(cout, cout // 2, dims=2)
        dec["up"].append(blk)
    dec["norm_out"] = norm(d[-1])
    dec["conv_out"] = conv(d[-1], 3)
    return {"decoder": dec, "post_quant_conv": conv(cfg.z_dim, cfg.z_dim, 1, 1, 1)}

