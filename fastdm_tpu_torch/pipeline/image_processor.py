"""CLIP's image preprocessing (the port's own counterpart of transformers'
CLIPImageProcessor, which the JAX package runs on the host before its CLIP
vision tower, fastdm_tpu/pipeline/text_encoder.py:351-364).

It imports neither PIL nor transformers, and gives transformers'
`pixel_values` bit for bit on an (H, W, 3) uint8 image:

  * output size -- the short side becomes `shortest_edge`, the long side
    int(size * long / short) (get_resize_output_image_size with
    default_to_square=False); a {"height", "width"} size resizes to exactly
    that;
  * resize      -- Pillow's BICUBIC resample on 8-bit data, which
    transformers' resize hands the uint8 image to: the cubic of a = -0.5 on
    a support of 2 input pixels, widened by the scale when shrinking; each
    output pixel's weights are computed in double, normalized by their sum,
    then turned into fixed point with 22 fractional bits (rounded half away
    from zero); the weighted sum is taken in integers from half a unit,
    shifted back and clipped to uint8, one pass per axis, horizontal first
    (Pillow's ImagingResampleInner; a pass whose size does not change is
    skipped, as there);
  * center crop -- top = (h - ch) // 2, left = (w - cw) // 2, zero padding
    where the image is smaller than the crop (transformers' center_crop);
  * rescale     -- multiply in float64 by rescale_factor, then cast to float32;
  * normalize   -- (x - mean) / std in float32, then channels first.

The integer resize runs on the host in numpy, and the processor returns the
(N, 3, S, S) float32 batch as a numpy array, as the tokenizers return their
ids; the encoder (pipeline/text_encoder.py CLIPImageEncoder) moves it to the
engine's device. Settings
come from the encoder directory's preprocessor_config.json when it is there,
else from JAX's fallback: shortest edge and crop both the tower's
image_size, OpenAI CLIP's mean and std, bicubic.
"""

from __future__ import annotations

import json
import math
import os
from typing import Sequence, Tuple

import numpy as np

# OpenAI CLIP's normalization (transformers' OPENAI_CLIP_MEAN / _STD)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# PIL's resample codes (PIL.Image.Resampling); the port implements BICUBIC only
_RESAMPLE_NAMES = {0: "NEAREST", 1: "LANCZOS", 2: "BILINEAR", 3: "BICUBIC", 4: "BOX",
                   5: "HAMMING"}
BICUBIC = 3
# Pillow's fixed point for 8-bit data: 32 - 8 - 2 fractional bits
_PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), elementwise in float64, with its
    operations in its order."""
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def resample_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis of a
    bicubic resize over the whole input: -> (xmin (out,) int64, k (out,
    ksize) int64 fixed-point weights, zero past each output's span)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    x = np.arange(ksize, dtype=np.int64)[None, :]
    live = x < xmax[:, None]
    w = np.where(live, _bicubic(((x + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5)
                                * ss), 0.0)
    ww = np.zeros(out_size, np.float64)
    for i in range(ksize):  # Pillow's sequential sum, in its order
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one)).astype(np.int64)
    return xmin, np.where(live, k, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's bicubic resample along `axis` (0 rows, 1
    columns) of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    xmin, k = resample_coeffs(in_size, out_size)
    # the banded weights as a dense (in, out) matrix: every product and
    # partial sum is an integer far below 2**53, so a float64 matmul gives
    # Pillow's integer sums exactly, in any order
    dense = np.zeros((in_size, out_size), np.float64)
    cols = np.broadcast_to(np.arange(out_size)[:, None], k.shape)
    rows = xmin[:, None] + np.arange(k.shape[1])[None, :]
    live = rows < in_size
    dense[rows[live], cols[live]] = k[live]
    src = np.moveaxis(img, axis, -1)  # (..., in)
    lead = src.shape[:-1]
    acc = np.ascontiguousarray(src, np.float64).reshape(-1, in_size) @ dense
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8).reshape(*lead, out_size)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL.Image.fromarray(img).resize((width, height), Image.BICUBIC) of an
    (H, W, C) uint8 image, bit for bit: the horizontal pass, then the
    vertical one, each skipped when its size does not change."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bicubic takes an (H, W, C) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    if width != img.shape[1]:
        img = _resample_axis(img, width, 1)
    if height != img.shape[0]:
        img = _resample_axis(img, height, 0)
    return img


def resize_output_size(h: int, w: int, size) -> Tuple[int, int]:
    """transformers' output size: an int is the short side's new length
    (default_to_square=False), a (height, width) pair is taken as it is."""
    if isinstance(size, (tuple, list)):
        return int(size[0]), int(size[1])
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(size * long / short)
    return (new_long, new_short) if w <= h else (new_short, new_long)


def center_crop(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """transformers' center_crop of an (H, W, C) image, zero-padded first
    (centered, the odd pixel after) where it is smaller than the crop."""
    h, w = img.shape[0], img.shape[1]
    top, left = (h - ch) // 2, (w - cw) // 2
    if top >= 0 and left >= 0 and top + ch <= h and left + cw <= w:
        return img[top:top + ch, left:left + cw]
    nh, nw = max(ch, h), max(cw, w)
    pad_t, pad_l = math.ceil((nh - h) / 2), math.ceil((nw - w) / 2)
    out = np.zeros((nh, nw) + img.shape[2:], img.dtype)
    out[pad_t:pad_t + h, pad_l:pad_l + w] = img
    top, left = top + pad_t, left + pad_l
    return out[max(0, top):min(nh, top + ch), max(0, left):min(nw, left + cw)]


def _size_dict(size, default_to_square: bool):
    """transformers' get_size_dict for CLIP's two settings: an int size (an
    older config's) is the shortest edge (size) or a square (crop_size)."""
    if isinstance(size, dict):
        return size
    return {"height": size, "width": size} if default_to_square else {"shortest_edge": size}


class CLIPImageProcessor:
    """transformers' CLIPImageProcessor settings and preprocess(), in numpy."""

    def __init__(self, size=224, crop_size=224, do_resize: bool = True,
                 do_center_crop: bool = True, do_rescale: bool = True,
                 rescale_factor: float = 1 / 255, do_normalize: bool = True,
                 image_mean: Sequence[float] = OPENAI_CLIP_MEAN,
                 image_std: Sequence[float] = OPENAI_CLIP_STD, resample: int = BICUBIC):
        if do_resize and int(resample) != BICUBIC:
            raise NotImplementedError(
                f"CLIP preprocessing with resample={resample} "
                f"({_RESAMPLE_NAMES.get(int(resample), 'unknown')}): the port implements "
                "Pillow's BICUBIC (3) only")
        self.size = _size_dict(size, False)
        self.crop_size = _size_dict(crop_size, True)
        self.do_resize, self.do_center_crop = do_resize, do_center_crop
        self.do_rescale, self.rescale_factor = do_rescale, rescale_factor
        self.do_normalize = do_normalize
        self.image_mean = tuple(float(m) for m in image_mean)
        self.image_std = tuple(float(s) for s in image_std)

    @classmethod
    def from_dir(cls, path: str, image_size: int) -> "CLIPImageProcessor":
        """The settings of path/preprocessor_config.json, or JAX's fallback
        at the tower's image_size when there is no such file."""
        cfg_path = os.path.join(path, "preprocessor_config.json")
        if not os.path.exists(cfg_path):
            return cls(size=image_size, crop_size=image_size)
        with open(cfg_path, "r", encoding="utf-8") as f:
            cj = json.load(f)
        keys = ("size", "crop_size", "do_resize", "do_center_crop", "do_rescale",
                "rescale_factor", "do_normalize", "image_mean", "image_std", "resample")
        return cls(**{k: cj[k] for k in keys if cj.get(k) is not None})

    def _one(self, image) -> np.ndarray:
        img = np.asarray(image)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"CLIP preprocessing takes (H, W, 3) uint8 images, got "
                             f"{img.dtype} {img.shape}")
        if self.do_resize:
            s = self.size
            size = s["shortest_edge"] if "shortest_edge" in s else (s["height"], s["width"])
            img = resize_bicubic(img, *resize_output_size(img.shape[0], img.shape[1], size))
        if self.do_center_crop:
            img = center_crop(img, self.crop_size["height"], self.crop_size["width"])
        x = img
        if self.do_rescale:
            x = (x.astype(np.float64) * self.rescale_factor).astype(np.float32)
        if self.do_normalize:
            x = x.astype(np.float32) if not np.issubdtype(x.dtype, np.floating) else x
            mean = np.array(self.image_mean, dtype=x.dtype)
            std = np.array(self.image_std, dtype=x.dtype)
            x = (x - mean) / std
        return np.ascontiguousarray(x.transpose(2, 0, 1))

    def __call__(self, images) -> np.ndarray:
        """One (H, W, 3) uint8 image or a list of them (one size after the
        crop) -> pixel_values (N, 3, S, S) float32."""
        if isinstance(images, (list, tuple)):
            return np.stack([self._one(im) for im in images])
        return self._one(images)[None]
