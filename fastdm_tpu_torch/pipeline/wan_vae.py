"""Wan 3D causal VAE (port of fastdm_tpu/pipeline/wan_vae.py: wan_vae_decode
:292, wan_vae_encode :331, wan_vae_decode_chunked :444, wan_vae_load :535 and
the random init :623).

AutoencoderKLWan in both layouts: the Wan2.1 one (Wan2.1, Wan2.2-A14B,
Qwen-Image) and the Wan2.2 one (is_residual, patch_size 2: Wan2.2-TI2V-5B).
Causal 3D convolutions (zero temporal padding in front only), channel RMS
norms, per-frame spatial attention in the mid blocks. The encoder has three
spatial 2x downsamples (right/bottom zero pad, stride-2 conv), the last two
also temporal: frame 0 passes through and a stride-2 valid conv covers the
whole sequence. The decoder mirrors it: upsamplers whose 2x-channel temporal
conv interleaves into doubled frames (frame 0 bypasses it), giving the
causal 1 + 4(F-1) frame layout. In the residual layout a parameter-free
shortcut goes around each stage (AvgDown3D in the encoder, DupUp3D in the
decoder, which drops its first ft-1 frames on the first chunk) and the
decoder's upsample conv keeps its channels; with patch_size p the pixels are
p x p patchified into channels before the encoder and after the decoder, so
the spatial stride is 8p. wan_vae_decode runs the whole sequence at once;
wan_vae_decode_chunked walks one latent frame at a time with per-conv caches
of the last input frames (the same windows, peak activations of one latent
frame) -- the engine's path above 8 latent frames. wan_vae_encode runs the
whole sequence, as the JAX one; its convolutions and norms take slabs of
frames so that the f32 copies of a long video stay bounded.

Inside, activations are NCDHW and convolution weights keep the checkpoint's
(out, in, kt, kh, kw) layout; the public contract is the JAX one: (B, C_z, F,
H, W) latents in, (B, 1+4(F-1), 8pH, 8pW, 3) float32 in [-1, 1] out; (B, F,
H, W, 3) video in [-1, 1] in, the normalized posterior mean (B, C_z,
1+(F-1)//4, H/8p, W/8p) float32 out. The compute dtype is the `dtype`
argument (the JAX module's global _DTYPE): operands are rounded to it, each
convolution takes f32 products and sums of those values with the f32 bias
added before one rounding to `dtype`, norms run in f32. Convolutions and the
per-frame attention are plain PyTorch (none is a Pallas kernel in JAX). On
the card the f32 convolution goes through cuDNN; decode and encode set
cuDNN's TF32 flag for their duration: on for bfloat16, where every operand
is exact in TF32 and the sums stay f32, off for float32.
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

# elements of one f32 slab that a convolution or a norm converts at a time
_SLAB_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    # Wan2.2-TI2V: pixels p x p patchified into channels around the codec
    # (spatial stride 8p; diffusers' patch_size)
    patch_size: int = 1
    # Wan2.2 layout: AvgDown3D / DupUp3D shortcuts around each stage, nested
    # down_blocks.{i} / up_blocks.{i} keys, channel-keeping upsample convs
    is_residual: bool = False

    @property
    def encoder_dims(self) -> Tuple[int, ...]:
        # (96, 96, 192, 384, 384) for the defaults
        return tuple(self.base_dim * m for m in (1,) + tuple(self.dim_mult))

    @property
    def decoder_dims(self) -> Tuple[int, ...]:
        # (384, 384, 384, 192, 96) for the defaults
        m = tuple(self.dim_mult)
        return tuple(self.base_dim * u for u in (m[-1],) + m[::-1])


@contextlib.contextmanager
def _cudnn_tf32(enabled: bool):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(p, x: Tensor, front_pad: int, dtype, t_stride: int = 1, down: bool = False) -> Tensor:
    """3D conv of NCDHW x with `front_pad` zero frames in front, temporal
    stride t_stride and no other temporal padding; SAME spatial padding, or
    with `down` diffusers' downsample: a (0, 1, 0, 1) right/bottom zero pad
    and spatial stride 2. 2D kernels (out, in, kh, kw) run per frame. f32
    products and sums of dtype-rounded operands, f32 bias, one rounding to
    dtype; the output frames are computed in slabs (the same windows)."""
    w = p["w"]
    if w.dim() == 4:
        w = w[:, :, None]
    kt, kh, kw = w.shape[2:]
    wf, bias = w.to(dtype).float(), p["b"].float()
    b, c, t, h, ww = x.shape
    t_out = (t + front_pad - kt) // t_stride + 1
    stride = (t_stride, 2, 2) if down else (t_stride, 1, 1)
    padding = (0, 0, 0) if down else (0, kh // 2, kw // 2)
    slab = max(1, _SLAB_ELEMS // (b * c * h * ww * t_stride))
    out = None
    for o0 in range(0, t_out, slab):
        o1 = min(t_out, o0 + slab)
        lo, hi = o0 * t_stride - front_pad, (o1 - 1) * t_stride - front_pad + kt
        xs = x[:, :, max(lo, 0):hi].to(dtype).float()
        if lo < 0 or down:
            xs = F.pad(xs, (0, int(down), 0, int(down), max(-lo, 0), 0))
        y = F.conv3d(xs, wf, bias, stride=stride, padding=padding).to(dtype)
        if o1 - o0 == t_out:
            return y
        if out is None:
            out = y.new_empty(b, y.shape[1], t_out, *y.shape[3:])
        out[:, :, o0:o1] = y
    return out


def _causal_conv3d(p, x: Tensor, dtype) -> Tensor:
    return _conv(p, x, p["w"].shape[2] - 1, dtype)


def _frame_slabs(x: Tensor):
    """Frame ranges of NCDHW x whose f32 copies hold about _SLAB_ELEMS."""
    t = x.shape[2]
    n = max(1, _SLAB_ELEMS // max(1, x[:, :, :1].numel()))
    return [(t0, min(t, t0 + n)) for t0 in range(0, t, n)]


def _rms_norm_channel(p, x: Tensor) -> Tensor:
    """F.normalize over channels * sqrt(C) * gamma (+ bias), in f32, a slab
    of frames at a time."""
    gamma = p["gamma"].float().reshape(1, -1, 1, 1, 1)
    beta = p["bias"].float().reshape(1, -1, 1, 1, 1) if "bias" in p else None

    def norm(xs):
        x32 = xs.float()
        y = x32 * torch.rsqrt(x32.square().mean(dim=1, keepdim=True) + 1e-12) * gamma
        return (y if beta is None else y + beta).to(x.dtype)

    slabs = _frame_slabs(x)
    if len(slabs) == 1:
        return norm(x)
    out = torch.empty_like(x)
    for t0, t1 in slabs:
        out[:, :, t0:t1] = norm(x[:, :, t0:t1])
    return out


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
    """Nearest 2x per frame, then the 3x3 conv (it halves the channels in the
    Wan2.1 layout and keeps them in the residual one)."""
    x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return _conv(p, x, 0, dtype)


def _temporal_downsample(p, x: Tensor, dtype) -> Tensor:
    """The encoder's temporal step: frame 0 passes through; a stride-2 valid
    (3, 1, 1) conv covers the whole sequence (windows from frame 0)."""
    if x.shape[2] < 3:
        return x[:, :, :1]
    return torch.cat([x[:, :, :1], _conv(p, x, 0, dtype, t_stride=2)], dim=2)


def _avg_down3d(x: Tensor, out_c: int, ft: int, fs: int) -> Tensor:
    """Wan2.2 AvgDown3D on NCDHW x (parameter-free): zero frames in front up
    to a multiple of ft, pixel-unshuffle (ft, fs, fs) into channels in the
    flat order (C, ft, fs_h, fs_w), then the mean of each group of channels
    down to out_c."""
    b, c, t, h, w = x.shape
    pad = (ft - t % ft) % ft
    if pad:
        x = torch.cat([x.new_zeros(b, c, pad, h, w), x], dim=2)
        t += pad
    x = x.reshape(b, c, t // ft, ft, h // fs, fs, w // fs, fs).permute(0, 1, 3, 5, 7, 2, 4, 6)
    group = c * ft * fs * fs // out_c
    return x.reshape(b, out_c, group, t // ft, h // fs, w // fs).mean(dim=2)


def _dup_up3d(x: Tensor, out_c: int, ft: int, fs: int, drop_first: bool) -> Tensor:
    """Wan2.2 DupUp3D on NCDHW x (parameter-free): each channel repeated,
    then pixel-shuffled from the flat order (out_c, ft, fs_h, fs_w) into (T*ft,
    H*fs, W*fs); drop_first drops the leading ft-1 frames (the first chunk's
    causal layout)."""
    b, c, t, h, w = x.shape
    x = x.repeat_interleave(out_c * ft * fs * fs // c, dim=1)
    x = x.reshape(b, out_c, ft, fs, fs, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, out_c, t * ft, h * fs, w * fs)
    return x[:, :, ft - 1:] if drop_first and ft > 1 else x


def _patchify_frames(x: Tensor, p: int) -> Tensor:
    """(B, F, H, W, C) -> (B, F, H/p, W/p, C*p*p) in diffusers' channel order
    (c r q): q the h-subpixel, r the w-subpixel."""
    if p == 1:
        return x
    b, f, hh, ww, c = x.shape
    x = x.reshape(b, f, hh // p, p, ww // p, p, c).permute(0, 1, 2, 4, 6, 5, 3)
    return x.reshape(b, f, hh // p, ww // p, c * p * p)


def _unpatchify_frames(x: Tensor, p: int) -> Tensor:
    """The inverse of _patchify_frames: (B, F, h, w, C*p*p) -> (B, F, h*p, w*p, C)."""
    if p == 1:
        return x
    b, f, hh, ww, cpp = x.shape
    x = x.reshape(b, f, hh, ww, cpp // (p * p), p, p).permute(0, 1, 2, 6, 3, 5, 4)
    return x.reshape(b, f, hh * p, ww * p, cpp // (p * p))


def _decode_core(params: Dict, cfg: WanVAEConfig, x: Tensor, conv, t_up, dtype,
                 drop_first: bool) -> Tensor:
    """The decoder on x (NCDHW, dtype); conv(name, p, x) and t_up(name, p, x)
    give the full-sequence or the cached semantics; drop_first is DupUp3D's
    (the whole sequence, or the first chunk)."""
    if "post_quant_conv" in params:
        x = _conv(params["post_quant_conv"], x, 0, dtype)
    dec = params["decoder"]
    x = conv("conv_in", dec["conv_in"], x)
    sub = lambda pre: (lambda n, p, y: conv(f"{pre}.{n}", p, y))  # noqa: E731
    x = _res_block(dec["mid"]["res0"], x, sub("mid.r0"))
    x = _attn_block(dec["mid"]["attn"], x, dtype)
    x = _res_block(dec["mid"]["res1"], x, sub("mid.r1"))
    for i, blk in enumerate(dec["up"]):
        xin = x
        for j, r in enumerate(blk["resnets"]):
            x = _res_block(r, x, sub(f"up{i}.r{j}"))
        if "time_conv" in blk:
            x = t_up(f"up{i}.t", blk["time_conv"], x)
        if "upsample" in blk:
            x = _upsample_spatial(blk["upsample"], x, dtype)
            if cfg.is_residual:  # the DupUp3D shortcut around the stage
                ft = 2 if "time_conv" in blk else 1
                x = x + _dup_up3d(xin, x.shape[1], ft, 2, drop_first).to(x.dtype)
    x = _rms_norm_channel(dec["norm_out"], x)
    return conv("conv_out", dec["conv_out"], F.silu(x))


def _prepare(cfg: WanVAEConfig, latents: Tensor, dtype) -> Tensor:
    z = latents.float()
    if cfg.latents_mean is not None:
        mean = torch.tensor(cfg.latents_mean, dtype=torch.float32, device=z.device)
        std = torch.tensor(cfg.latents_std, dtype=torch.float32, device=z.device)
        z = z * std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)
    return z.to(dtype)


def _to_frames(x: Tensor) -> Tensor:
    return x.float().permute(0, 2, 3, 4, 1).contiguous()  # (B, F, H, W, 3p^2)


@torch.inference_mode()
def wan_vae_decode(params: Dict, cfg: WanVAEConfig, latents: Tensor,
                   dtype=torch.bfloat16) -> Tensor:
    """(B, C_z, F, H, W) latents -> (B, 1+4(F-1), 8pH, 8pW, 3) float32 in
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
        frames = _to_frames(_decode_core(params, cfg, x, conv, t_up, dtype, True))
    return _unpatchify_frames(frames, cfg.patch_size)


@torch.inference_mode()
def wan_vae_decode_chunked(params: Dict, cfg: WanVAEConfig, latents: Tensor,
                           dtype=torch.bfloat16) -> Tensor:
    """wan_vae_decode walking one latent frame at a time: every kt=3 causal
    conv keeps its last two input frames (zeros before the first), and the
    temporal upsamplers and DupUp3D's frame drop act on the first chunk only.
    The same convolution windows as the full decode; peak activations of one
    latent frame (4 output frames)."""
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
            frames.append(_to_frames(_decode_core(params, cfg, x[:, :, f:f + 1], conv, t_up,
                                                  dtype, first)))
    return _unpatchify_frames(torch.cat(frames, dim=1), cfg.patch_size)


@torch.inference_mode()
def wan_vae_encode(params: Dict, cfg: WanVAEConfig, video: Tensor,
                   dtype=torch.bfloat16) -> Tensor:
    """(B, F, H, W, 3) video in [-1, 1] -> the posterior mean (B, C_z,
    1+(F-1)//4, H/8p, W/8p) float32, normalized by latents_mean / latents_std
    when the config has them; the whole sequence at once."""
    enc = params["encoder"]
    x = _patchify_frames(video, cfg.patch_size).permute(0, 4, 1, 2, 3).to(dtype)

    def conv(name, p, y):
        return _causal_conv3d(p, y, dtype)

    with _cudnn_tf32(dtype == torch.bfloat16):
        x = _causal_conv3d(enc["conv_in"], x, dtype)
        for blk in enc["down"]:
            xin = x
            for r in blk["resnets"]:
                x = _res_block(r, x, conv)
            if "downsample" in blk:
                x = _conv(blk["downsample"], x, 0, dtype, down=True)
            if "time_conv" in blk:
                x = _temporal_downsample(blk["time_conv"], x, dtype)
            if cfg.is_residual:  # the AvgDown3D shortcut (an average only on the last stage)
                ft = 2 if "time_conv" in blk else 1
                fs = 2 if "downsample" in blk else 1
                x = x + _avg_down3d(xin, x.shape[1], ft, fs).to(x.dtype)
            del xin
        x = _res_block(enc["mid"]["res0"], x, conv)
        x = _attn_block(enc["mid"]["attn"], x, dtype)
        x = _res_block(enc["mid"]["res1"], x, conv)
        x = _rms_norm_channel(enc["norm_out"], x)
        x = _causal_conv3d(enc["conv_out"], F.silu(x), dtype)
        if "quant_conv" in params:
            x = _causal_conv3d(params["quant_conv"], x, dtype)
    z = x[:, :x.shape[1] // 2].float()  # the mean half of (mean, logvar)
    if cfg.latents_mean is not None:
        mean = torch.tensor(cfg.latents_mean, dtype=torch.float32, device=z.device)
        std = torch.tensor(cfg.latents_std, dtype=torch.float32, device=z.device)
        z = (z - mean.reshape(1, -1, 1, 1, 1)) / std.reshape(1, -1, 1, 1, 1)
    return z


# ---------------------------------------------------------------- loading


def wan_vae_load(src: TensorSource, cfg: WanVAEConfig, dtype=torch.bfloat16) -> Dict:
    """Load a diffusers AutoencoderKLWan checkpoint (encoder, decoder and the
    quant convs) onto src.device, weights in `dtype`, biases and norm gains
    in f32. The Wan2.1 layout keeps one flat encoder.down_blocks /
    decoder.up_blocks index space shared by resnets and WanResample entries
    (resample convs at '.resample.1', temporal convs at '.time_conv'); the
    residual layout nests down_blocks.{i}.resnets.{j} / .downsampler and
    up_blocks.{i}.resnets.{j} / .upsampler. Every tensor must be claimed."""

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

    def mid(m):
        return {"res0": res(f"{m}.resnets.0"),
                "attn": {"norm": norm(f"{m}.attentions.0.norm"),
                         "qkv": linear_1x1(f"{m}.attentions.0.to_qkv"),
                         "proj": linear_1x1(f"{m}.attentions.0.proj")},
                "res1": res(f"{m}.resnets.1")}

    n_stages = len(cfg.dim_mult)

    def stages(part, n_res, resample, key):
        """The down / up stages: (resnet prefixes, resample prefix or None)."""
        out, idx = [], 0
        for i in range(n_stages):
            if cfg.is_residual:
                b = f"{part}.{i}"
                names = [f"{b}.resnets.{j}" for j in range(n_res)]
                rs = f"{b}.{resample}" if i != n_stages - 1 else None
            else:
                names = [f"{part}.{idx + j}" for j in range(n_res)]
                idx += n_res
                rs = f"{part}.{idx}" if i != n_stages - 1 else None
                idx += rs is not None
            blk: Dict = {"resnets": [res(nm) for nm in names]}
            if rs is not None:
                blk[key] = conv(f"{rs}.resample.1")
                if f"{rs}.time_conv.weight" in src:
                    blk["time_conv"] = conv(f"{rs}.time_conv")
            out.append(blk)
        return out

    enc: Dict = {"conv_in": conv("encoder.conv_in"),
                 "down": stages("encoder.down_blocks", cfg.num_res_blocks, "downsampler",
                                "downsample"),
                 "mid": mid("encoder.mid_block"), "norm_out": norm("encoder.norm_out"),
                 "conv_out": conv("encoder.conv_out")}
    dec: Dict = {"conv_in": conv("decoder.conv_in"), "mid": mid("decoder.mid_block"),
                 "up": stages("decoder.up_blocks", cfg.num_res_blocks + 1, "upsampler",
                              "upsample"),
                 "norm_out": norm("decoder.norm_out"), "conv_out": conv("decoder.conv_out")}
    params: Dict = {"encoder": enc, "decoder": dec}
    for name in ("quant_conv", "post_quant_conv"):
        if f"{name}.weight" in src:
            params[name] = conv(name)
    src.assert_consumed()
    return params


def _random_parts(seed: int, device, dtype):
    """(conv, norm, res, attn) drawers on one torch.Generator: conv weights
    ~ N(0, 1) * 0.05, attention projections * 0.02, zero biases, unit gains."""
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

    def mid(c):
        return {"res0": res(c, c),
                "attn": {"norm": norm(c),
                         "qkv": {"w": w(c, 3 * c, std=0.02), "b": torch.zeros(3 * c, device=dev)},
                         "proj": {"w": w(c, c, std=0.02), "b": torch.zeros(c, device=dev)}},
                "res1": res(c, c)}

    return conv, norm, res, mid


def wan_vae_decoder_random(seed: int, cfg: WanVAEConfig, device="cuda",
                           dtype=torch.bfloat16) -> Dict:
    """Random-weight Wan VAE decoder and post_quant_conv (smoke runs without
    checkpoints), the channel flow of the JAX wan_vae_random in either
    layout; drawn by a torch.Generator seeded with `seed` on `device`."""
    conv, norm, res, mid = _random_parts(seed, device, dtype)
    d = cfg.decoder_dims
    t_up = tuple(reversed(cfg.temporal_downsample))
    dec: Dict = {"conv_in": conv(cfg.z_dim, d[0]), "mid": mid(d[0]), "up": []}
    n_stages = len(cfg.dim_mult)
    for i in range(n_stages):
        cin, cout = d[i], d[i + 1]
        if i > 0 and not cfg.is_residual:
            cin //= 2  # the previous stage's upsample conv halved the channels
        blk: Dict = {"resnets": [res(cin if r == 0 else cout, cout)
                                 for r in range(cfg.num_res_blocks + 1)]}
        if i != n_stages - 1:
            if t_up[i]:
                blk["time_conv"] = conv(cout, 2 * cout, 3, 1, 1)
            blk["upsample"] = conv(cout, cout if cfg.is_residual else cout // 2, dims=2)
        dec["up"].append(blk)
    dec["norm_out"] = norm(d[-1])
    dec["conv_out"] = conv(d[-1], 3 * cfg.patch_size**2)
    return {"decoder": dec, "post_quant_conv": conv(cfg.z_dim, cfg.z_dim, 1, 1, 1)}


def wan_vae_encoder_random(seed: int, cfg: WanVAEConfig, device="cuda",
                           dtype=torch.bfloat16) -> Dict:
    """Random-weight Wan VAE encoder and quant_conv, the encoder half of the
    JAX wan_vae_random in either layout, drawn as wan_vae_decoder_random."""
    conv, norm, res, mid = _random_parts(seed, device, dtype)
    e = cfg.encoder_dims
    enc: Dict = {"conv_in": conv(3 * cfg.patch_size**2, e[0]), "down": []}
    n_stages = len(cfg.dim_mult)
    for i in range(n_stages):
        cin, cout = e[i], e[i + 1]
        blk: Dict = {"resnets": [res(cin if r == 0 else cout, cout)
                                 for r in range(cfg.num_res_blocks)]}
        if i != n_stages - 1:
            blk["downsample"] = conv(cout, cout, dims=2)
            if cfg.temporal_downsample[i]:
                blk["time_conv"] = conv(cout, cout, 3, 1, 1)
        enc["down"].append(blk)
    enc.update(mid=mid(e[-1]), norm_out=norm(e[-1]), conv_out=conv(e[-1], 2 * cfg.z_dim))
    return {"encoder": enc, "quant_conv": conv(2 * cfg.z_dim, 2 * cfg.z_dim, 1, 1, 1)}
