"""Kernel-boundary contract checks (port of fastdm_tpu/kernels/contracts.py:
check_sdpa, the sparse-attention table checks check_block_tiles,
check_gather_lists, check_gather_fine, check_gather_super and
check_sparse_mask :54-227, check_scaled_mm :230-249; check_gelu_and_mul is
the port's own: the JAX op checks nothing). Shape checks run in
Python before any pointer reaches a kernel, so a bad call dies with a message
instead of an out-of-bounds access on the card. The table checks take
strict=True to read the VALUES too (on the host: the engine runs them once on
its numpy tables, never per launch, which would sync the card); the kernels
clamp every table read besides. The TPU's (8, 128) tile-alignment rules of
the JAX checks are not carried over: the CUDA wrappers state their own."""

from __future__ import annotations

import numpy as np
import torch


def _fail(kernel: str, msg: str):
    raise ValueError(f"[{kernel}] contract violation: {msg}")


def check_sdpa(kernel: str, query, key, value, num_q_heads: int,
               num_kv_heads: int, head_dim: int) -> None:
    if query.dim() != 3 or key.dim() != 3 or value.dim() != 3:
        _fail(kernel, f"q/k/v must be (B, S, H*D); got ndims "
                      f"{query.dim()}/{key.dim()}/{value.dim()}")
    if query.shape[0] != key.shape[0] or key.shape[0] != value.shape[0]:
        _fail(kernel, f"batch mismatch: q{tuple(query.shape)} k{tuple(key.shape)} "
                      f"v{tuple(value.shape)}")
    if key.shape[1] != value.shape[1]:
        _fail(kernel, f"kv seq mismatch: k{tuple(key.shape)} v{tuple(value.shape)}")
    if query.shape[2] != num_q_heads * head_dim:
        _fail(kernel, f"q feature dim {query.shape[2]} != num_q_heads*head_dim "
                      f"{num_q_heads}*{head_dim}")
    if key.shape[2] != num_kv_heads * head_dim or value.shape[2] != num_kv_heads * head_dim:
        _fail(kernel, f"k/v feature dim {key.shape[2]}/{value.shape[2]} != "
                      f"num_kv_heads*head_dim {num_kv_heads}*{head_dim}")
    if num_kv_heads <= 0 or num_q_heads % num_kv_heads:
        _fail(kernel, f"num_q_heads {num_q_heads} not a multiple of "
                      f"num_kv_heads {num_kv_heads}")
    if head_dim % 8:
        _fail(kernel, f"head_dim {head_dim} must be a multiple of 8")


def check_gelu_and_mul(kernel: str, x) -> None:
    """(..., 2d) with d > 0, bfloat16 or float32 (the dtypes the JAX op is fed)."""
    if x.dim() < 1 or x.shape[-1] == 0 or x.shape[-1] % 2:
        _fail(kernel, f"last dim of {tuple(x.shape)} must be even and positive "
                      "(hidden | gate halves)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        _fail(kernel, f"dtype {x.dtype} not in (bfloat16, float32)")


def _int32(kernel: str, **arrays) -> None:
    for name, arr in arrays.items():
        if str(arr.dtype) not in ("int32", "torch.int32"):
            _fail(kernel, f"{name} dtype {arr.dtype} != int32")


def _host(*arrays):
    return (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in arrays)


def _check_csr_rows(kernel: str, rows: np.ndarray, t: int, group: int) -> None:
    starts, cnts = rows[:, 0], rows[:, 1]
    if (starts % group).any():
        _fail(kernel, f"row starts must be group-aligned (group={group})")
    if (cnts < 0).any():
        _fail(kernel, "negative row count")
    if (starts + -(-cnts // group) * group > t).any():
        _fail(kernel, f"row segment exceeds flat table length {t}")


def check_block_tiles(kernel: str, block_q: int, block_k: int) -> None:
    if block_q < 16 or block_k < 16 or block_q % 16 or block_k % 16:
        _fail(kernel, f"tile sizes ({block_q}, {block_k}) must be positive multiples of 16; "
                      "token-granularity masks must be retiled first "
                      "(RadialAttn.block_mask / block_lists)")


def check_sparse_mask(kernel: str, sparse_mask, batch: int, heads: int, sq: int, skv: int,
                      block_q: int, block_k: int, strict: bool = False) -> None:
    """(B, H, ceil(sq/block_q), ceil(skv/block_k)) block mask, one per batch
    entry and query head; strict=True also requires every value to be 0 or 1."""
    check_block_tiles(kernel, block_q, block_k)
    want = (batch, heads, -(-sq // block_q), -(-skv // block_k))
    if tuple(sparse_mask.shape) != want:
        _fail(kernel, f"sparse_mask {tuple(sparse_mask.shape)} != expected {want} for "
                      f"S=({sq}, {skv}) at tiles ({block_q}, {block_k}) — retile the mask to "
                      "the consumer granularity (RadialAttn.block_mask)")
    if strict:
        (m,) = _host(sparse_mask)
        if m.size and not np.isin(m, (0, 1)).all():
            _fail(kernel, "sparse_mask values must be 0 (skip) or 1 (compute)")


def check_gather_lists(kernel: str, block_indices, block_counts, sq: int, skv: int,
                       block_q: int, block_k: int, strict: bool = False) -> None:
    """Coarse gather tables (RadialAttn.block_lists): (ceil(sq/block_q), max_nb)
    int32 KV tile ids of block_k tokens and (ceil(sq/block_q), 1) int32 counts;
    strict=True also checks ids in range and counts in [0, max_nb]."""
    check_block_tiles(kernel, block_q, block_k)
    ni, nkv = -(-sq // block_q), -(-skv // block_k)
    if block_indices.ndim != 2 or block_indices.shape[0] != ni:
        _fail(kernel, f"block_indices must be ({ni}, max_nb) for ceil({sq}/{block_q}) q tiles, "
                      f"got {tuple(block_indices.shape)} — q-tile granularity mismatch")
    if tuple(block_counts.shape) != (ni, 1):
        _fail(kernel, f"block_counts must be ({ni}, 1), got {tuple(block_counts.shape)}")
    _int32(kernel, block_indices=block_indices, block_counts=block_counts)
    max_nb = block_indices.shape[1]
    if max_nb > nkv:
        _fail(kernel, f"max_nb {max_nb} > kv tiles {nkv}")
    if not strict:
        return
    idx, cnt = _host(block_indices, block_counts)
    if idx.size and (int(idx.max()) >= nkv or int(idx.min()) < 0):
        _fail(kernel, f"block index out of range [0, {nkv}): kv has {nkv} tiles of {block_k} "
                      f"tokens (skv={skv})")
    if cnt.size and (int(cnt.max()) > max_nb or int(cnt.min()) < 0):
        _fail(kernel, f"block_counts out of [0, max_nb={max_nb}]")


def check_gather_fine(kernel: str, block_indices, block_valid, block_rows, sq: int, skv: int,
                      block_q: int, group: int, fine: int, strict: bool = False) -> None:
    """Fine gather tables (RadialAttn.block_lists_fine): flat (T,) int32 fine
    block ids and valid-token counts, (ceil(sq/block_q), 2) int32 rows of
    [group-aligned start, count]; strict=True also checks ids in range,
    valid in [0, fine] and segments inside the table."""
    if group < 1 or fine < 1 or block_q < 1:
        _fail(kernel, f"group {group}, fine {fine} and block_q {block_q} must be >= 1")
    ni, nfine = -(-sq // block_q), -(-skv // fine)
    if block_indices.ndim != 1:
        _fail(kernel, f"block_indices must be flat (T,), got {tuple(block_indices.shape)}")
    t = block_indices.shape[0]
    if t % group:
        _fail(kernel, f"flat table length {t} not a multiple of group {group}")
    if tuple(block_valid.shape) != tuple(block_indices.shape):
        _fail(kernel, f"block_valid {tuple(block_valid.shape)} != block_indices "
                      f"{tuple(block_indices.shape)}")
    if tuple(block_rows.shape) != (ni, 2):
        _fail(kernel, f"block_rows must be ({ni}, 2) [start, count], got "
                      f"{tuple(block_rows.shape)} — q-tile granularity mismatch")
    _int32(kernel, block_indices=block_indices, block_valid=block_valid, block_rows=block_rows)
    if not strict:
        return
    idx, val, rows = _host(block_indices, block_valid, block_rows)
    if idx.size and (int(idx.max()) >= nfine or int(idx.min()) < 0):
        _fail(kernel, f"fine block index out of range [0, {nfine}) for skv={skv} at fine={fine}")
    if val.size and (int(val.max()) > fine or int(val.min()) < 0):
        _fail(kernel, f"block_valid out of [0, {fine}]")
    _check_csr_rows(kernel, rows, t, group)


def check_gather_super(kernel: str, block_indices, block_valbits, block_rows, sq: int,
                       skv: int, block_q: int, group: int, fine: int, superblock: int,
                       strict: bool = False) -> None:
    """Superblock gather tables (RadialAttn.block_lists_super): flat (T,)
    int32 superblock ids and valbits, (ceil(sq/block_q), 2) int32 rows of
    [group-aligned start, count]. Shapes and dtypes always; with strict=True
    also the values (indices in range, valbits within `superblock` bits,
    segments inside the table), which reads them on the host — the engine
    runs it once on its numpy tables, never per launch."""
    if superblock < 1 or group < 1 or fine < 1 or block_q < 1:
        _fail(kernel, f"superblock {superblock}, group {group}, fine {fine} and block_q "
                      f"{block_q} must be >= 1")
    ni = -(-sq // block_q)
    nsuper = -(-(-(-skv // fine)) // superblock)
    if block_indices.ndim != 1:
        _fail(kernel, f"block_indices must be flat (T,), got {tuple(block_indices.shape)}")
    t = block_indices.shape[0]
    if t % group:
        _fail(kernel, f"flat table length {t} not a multiple of group {group}")
    if tuple(block_valbits.shape) != tuple(block_indices.shape):
        _fail(kernel, f"block_valbits {tuple(block_valbits.shape)} != block_indices "
                      f"{tuple(block_indices.shape)}")
    if tuple(block_rows.shape) != (ni, 2):
        _fail(kernel, f"block_rows must be ({ni}, 2) [start, count], got "
                      f"{tuple(block_rows.shape)} — q-tile granularity mismatch")
    _int32(kernel, block_indices=block_indices, block_valbits=block_valbits,
           block_rows=block_rows)
    if not strict:
        return
    idx, val, rows = _host(block_indices, block_valbits, block_rows)
    if idx.size and (int(idx.max()) >= nsuper or int(idx.min()) < 0):
        _fail(kernel, f"superblock index out of range [0, {nsuper}) for skv={skv} at "
                      f"fine={fine} x superblock={superblock}")
    if val.size and (int(val.max()) >= (1 << superblock) or int(val.min()) < 0):
        _fail(kernel, f"valbits out of [0, {(1 << superblock) - 1}]")
    _check_csr_rows(kernel, rows, t, group)


def check_scaled_mm(kernel: str, a, b, scale_a, scale_b, azp_adj=None,
                    azp=None, bias=None, int8=False) -> None:
    if a.dim() != 2 or b.dim() != 2:
        _fail(kernel, f"a/b must be 2D, got {tuple(a.shape)}/{tuple(b.shape)}")
    m, k = a.shape
    if b.shape[0] != k:
        _fail(kernel, f"inner dims disagree: a{tuple(a.shape)} @ b{tuple(b.shape)}")
    n = b.shape[1]
    if int8 and (a.dtype != torch.int8 or b.dtype != torch.int8):
        _fail(kernel, f"int8 path needs int8 operands, got {a.dtype}/{b.dtype}")
    if scale_a.numel() not in (1, m):
        _fail(kernel, f"scale_a size {scale_a.numel()} != per-token ({m}) or scalar")
    if scale_b.numel() not in (1, n):
        _fail(kernel, f"scale_b size {scale_b.numel()} != per-channel ({n}) or scalar")
    if azp_adj is not None and azp_adj.numel() != n:
        _fail(kernel, f"azp_adj (weight colsum) size {azp_adj.numel()} != N {n}")
    if azp is not None and azp.numel() != m:
        _fail(kernel, f"azp (per-token zero point) size {azp.numel()} != M {m}")
    if bias is not None and bias.numel() != n:
        _fail(kernel, f"bias size {bias.numel()} != N {n}")
