"""A PNG codec in numpy and zlib, for the front-ends' images where PIL is
missing (the GPU machine has no PIL).

  * encode_png -- an (H, W, 3) uint8 array -> PNG bytes: 8-bit RGB,
    non-interlaced, every row under filter 0 (None), one IDAT chunk.
  * decode_png -- PNG bytes -> (H, W, 3) uint8 RGB, as
    PIL.Image.open(...).convert("RGB") gives it: 8-bit non-interlaced
    grayscale (replicated), RGB, palette (through PLTE), gray + alpha and
    RGBA (the alpha dropped, not composited); all five row filters.
    Other bit depths and interlaced images raise ValueError naming them;
    a wrong chunk CRC raises too.

read_image / write_image and decode_image_bytes serve the API server and
the CLI demos: PNG through this codec, another format through PIL where
PIL imports (else ValueError naming the format).

Decoding undoes the row filters along anti-diagonals: a pixel's
predictor reads its left, upper and upper-left neighbours, which all lie
on earlier anti-diagonals, so each anti-diagonal is one vectorized step
(H + W - 1 steps, whatever filters the rows use).
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, name)
_COLOR_TYPES: Dict[int, Tuple[int, str]] = {0: (1, "grayscale"), 2: (3, "RGB"),
                                            3: (1, "palette"), 4: (2, "grayscale+alpha"),
                                            6: (4, "RGBA")}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0 on every row, zlib
    level 6 as PIL's default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes an (H, W, 3) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + W * bpp) filtered rows -> (H, W, bpp) uint8 samples."""
    h = raw.shape[0]
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not one of 0-4")
    w = (raw.shape[1] - 1) // bpp
    filt = raw[:, 1:].reshape(h, w, bpp)
    if not ftype.any():
        return np.ascontiguousarray(filt)
    filt = filt.astype(np.int16)
    # one zero row above and one zero column to the left
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    rows = np.arange(h)
    sub, up, avg, paeth = ((ftype == k)[:, None] for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        r = rows[r0:r1]
        c = d - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        # Paeth: p = a + b - c, and its distances to a, b and c
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        pred = np.where(sub[r0:r1], a, 0)
        pred = np.where(up[r0:r1], b, pred)
        pred = np.where(avg[r0:r1], (a + b) >> 1, pred)
        pred = np.where(paeth[r0:r1],
                        np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc)), pred)
        out[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's convert("RGB")."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG (no PNG signature)")
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR of {len(body)} bytes")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if color not in _COLOR_TYPES:
        raise ValueError(f"PNG colour type {color} is not a valid one")
    channels, name = _COLOR_TYPES[color]
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} ({name}) is not supported: 8-bit images only")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    if raw.size != h * (1 + w * channels):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * channels)}")
    px = _unfilter(raw.reshape(h, 1 + w * channels), channels)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _image_format(data: bytes) -> str:
    for magic, name in ((SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"),
                        (b"GIF89a", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                        (b"MM\x00*", "TIFF")):
        if data.startswith(magic):
            return name
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    return "unknown"


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB: PNG by this codec, any
    other format through PIL where PIL imports."""
    fmt = _image_format(data)
    if fmt == "PNG":
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{fmt} images need PIL, which is not installed here; send a PNG") from None
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except OSError as e:  # PIL's UnidentifiedImageError among them
        raise ValueError(f"{fmt} image does not decode: {e}") from e


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB (decode_image_bytes)."""
    with open(path, "rb") as f:
        return decode_image_bytes(f.read())


def write_image(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 array -> a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img, np.uint8)))
