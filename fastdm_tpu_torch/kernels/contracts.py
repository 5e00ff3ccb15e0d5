"""Kernel-boundary contract checks (port of fastdm_tpu/kernels/contracts.py,
the checks the ported ops need: check_sdpa, check_scaled_mm :230-249). Shape checks run in Python before any
pointer reaches a kernel, so a bad call dies with a message instead of an
out-of-bounds access on the card."""

from __future__ import annotations

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
