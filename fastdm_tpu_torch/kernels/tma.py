"""Tensor-map geometry of the attention kernel's TMA loads (csrc/flash_attn.cu:
dense sdpa and the mask, coarse, superblock and fine table walks), computed on
the host from the tensor views, so that the CPU tests reach it; the C side only
checks it against its tiles and encodes it with cuTensorMapEncodeTiled.

A (B, S, H*D) view with a contiguous last dim is a 3-D map over (H*D, S, B),
innermost first, with the view's own byte strides: the q|k|v column slices of
one fused projection are read in place. Its S extent is the view's length,
not the buffer's, so the rows of a tile past the last key are zero-filled and
never read the next batch entry. One box is one 128-byte swizzle atom of
columns (64 bf16) by `rows` rows of one batch entry; head h's tile at rows
r0.. starts at coordinate (h*D + 64a, r0, b) for its atoms a < D/64.

Dense sdpa loads 128 query rows and 128-key tiles. A table walk loads each KV
tile as two 64-key halves (a table entry may end mid-tile: a coarse block_k or
a fine block that is an odd multiple of 64, a fine entry's valid count), and
its blocks take 128 query rows when block_q is a multiple of 128, else 64, so
that no block straddles two table rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

SWIZZLE_BYTES = 128  # the widest box row of a 128-byte-swizzled map
ATTN_ROWS = 128      # query rows of a block and keys of a KV tile (flash_attn.cu kBQ, kBK)
HALF_ROWS = 64       # keys of a table walk's box, and query rows of a one-consumer block


@dataclass(frozen=True)
class MapGeometry:
    dims: Tuple[int, ...]     # elements, innermost first
    strides: Tuple[int, ...]  # bytes, of dims 1 .. rank-1
    box: Tuple[int, ...]      # elements, innermost first

    def packed(self) -> Tuple[int, ...]:
        """dims, strides, box: the order the C launcher reads."""
        return (*self.dims, *self.strides, *self.box)


def attention_geometry(t: torch.Tensor, head_dim: int, rows: int = ATTN_ROWS) -> MapGeometry:
    """The 3-D tensor map of a (B, S, H*D) attention operand view."""
    if t.dim() != 3 or t.stride(2) != 1:
        raise ValueError(f"expected a (B, S, H*D) view with a contiguous last dim, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    b, s, width = t.shape
    es = t.element_size()
    atom = SWIZZLE_BYTES // es
    if head_dim % atom != 0 or width % head_dim != 0:
        raise ValueError(f"head_dim {head_dim} must be a multiple of {atom} and divide {width}")
    # with one batch entry the batch stride is never stepped: any valid one will do
    batch_stride = t.stride(0) if b > 1 else s * t.stride(1)
    return MapGeometry(dims=(width, s, b), strides=(t.stride(1) * es, batch_stride * es),
                       box=(atom, rows, 1))


def walk_rows(block_q: int) -> Tuple[int, int]:
    """(query rows of a block, rows of a K / V box) of a table walk for tables
    of block_q query rows (a multiple of 64)."""
    if block_q < HALF_ROWS or block_q % HALF_ROWS:
        raise ValueError(f"block_q {block_q} must be a positive multiple of {HALF_ROWS}")
    return (ATTN_ROWS if block_q % ATTN_ROWS == 0 else HALF_ROWS), HALF_ROWS
