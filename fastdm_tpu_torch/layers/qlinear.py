"""QLinear in bf16, int8, fp8, int4 and int4p (port of
fastdm_tpu/layers/qlinear.py).

A QLinear holds w (K, N) — already transposed from the checkpoint's
(out, in) layout — an optional bias (N,) in bf16 and, for the W8A8 formats,
a per-output-channel f32 scale (N,) and, for int8, the int32 column sums
(N,) of w that the asymmetric-activation epilogue needs (azp_adj). A W4A4
QLinear holds, instead of w, either w4 (K, N) (int4 values in int8
carriers) or w4p (K/2, N) (two values per byte, pack_int4's halves layout),
the per-channel f32 scale, and the SVDQuant low-rank branch lora_u (K, r)
and lora_v (r, N) in bf16.

  bf16: a plain torch matmul, as the JAX package leaves it to XLA
        (qlinear.py:301-305): f32 accumulation, the bias joins before the
        one rounding (torch.addmm).
  int8: weights quantized per channel, symmetric, at load time; activations
        per token, ASYMMETRIC, at each call (quantize_to_int8 with
        symmetric=False), then int8_matmul with the fused dequant epilogue.
  fp8:  the same with e4m3 weights and symmetric per-token e4m3 activations
        (quantize_to_fp8, fp8_matmul).
  int4: (W4A4, the JAX package's TPU extension) w = u @ v + residual, the
        residual per-channel symmetric int4, the rank-32 u, v in bf16;
        activations per token, symmetric int4 (quantize_to_int4), then
        int4_matmul (s32 accumulate, no zero point) plus the low-rank side
        path (x @ u) @ v, as one op, w4a4_linear, whose kernels take the
        (x @ u) @ v product and the add into their epilogue. On the H100 the
        int4 product runs on s8 MMAs: Hopper's tensor cores take no 4-bit
        integers.
  int4p: the same values packed two per byte (0.5 byte per weight). At few
        rows w4a4_linear's small-M kernel reads them packed; otherwise
        unpack_int4 writes them into a scratch buffer at each call (one
        linear's weights in flight), as JAX unpacks in-graph.

The 8-bit mode is carried by the weight dtype, as in JAX; W4A4 by which leaf
is present (w4 or w4p), as JAX's key-driven dispatch. Layout: an 8-bit w,
w4 and w4p are the (K, N) / (K/2, N) views ``buf.t()`` of K-contiguous
(N, K) / (N, K/2) buffers (the checkpoint's own layout), because the Hopper
GEMM reads B K-contiguous (csrc/w8a8_gemm.cu); shapes and the ops' contract
stay JAX's, and qlinear_slice_out still copies nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastdm_tpu_torch.kernels import (
    fp8_matmul,
    int8_matmul,
    quantize_to_fp8,
    quantize_to_int4,
    quantize_to_int8,
    unpack_int4,  # noqa: F401  (pack_int4's inverse, imported from here too)
    w4a4_linear,
)
from fastdm_tpu_torch.kernels.torch_backend import true_div

Tensor = torch.Tensor

_FP8_MAX = 448.0
_EIGHT_BIT = (torch.int8, torch.float8_e4m3fn)

# W4A4 low-rank branch rank (SVDQuant, arXiv:2411.05007), as in JAX
INT4_LOWRANK_RANK = 32
# the seed of the low-rank approximation's random test matrix (JAX's key)
_LOWRANK_SEED = 0x5BD


def _param(t: Optional[Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


def k_contiguous(w: Tensor) -> Tensor:
    """The (K, N) view of a K-contiguous (N, K) buffer holding w (no copy when
    w is already one)."""
    return w.t().contiguous().t()


class QLinear(nn.Module):
    """w (bf16 / int8 / fp8) or, for W4A4, exactly one of w4 / w4p with scale,
    lora_u and lora_v; 8-bit and 4-bit weights are stored K-contiguous.

    A tensor-parallel shard (parallel/tensor_parallel.py) holds its tp group
    in tp_reduce (a row shard: its partial sums are reduced over the group)
    or tp_column (a column shard), and also in tp_gather when the column
    shard's output is gathered whole; an unsplit layer has none."""

    tp_reduce = None
    tp_column = None
    tp_gather = None

    def __init__(self, w: Optional[Tensor], bias: Optional[Tensor] = None,
                 scale: Optional[Tensor] = None, colsum: Optional[Tensor] = None, *,
                 w4: Optional[Tensor] = None, w4p: Optional[Tensor] = None,
                 lora_u: Optional[Tensor] = None, lora_v: Optional[Tensor] = None):
        super().__init__()
        if (w is None) + (w4 is None) + (w4p is None) != 2:
            raise ValueError("a QLinear holds exactly one of w, w4 and w4p")
        if w is not None and w.dtype in _EIGHT_BIT:
            if scale is None or (w.dtype == torch.int8) != (colsum is not None):
                raise ValueError(f"a {w.dtype} QLinear needs scale (and colsum for int8 only)")
            w = k_contiguous(w)
        if w is None:
            q = w4 if w4 is not None else w4p
            if (q.dtype != torch.int8 or scale is None or lora_u is None or lora_v is None
                    or colsum is not None):
                raise ValueError("a W4A4 QLinear needs an int8-carrier w4 / w4p, scale, lora_u "
                                 "and lora_v (and no colsum)")
            w4, w4p = (None if t is None else k_contiguous(t) for t in (w4, w4p))
        self.w = _param(w)
        self.w4 = _param(w4)
        self.w4p = _param(w4p)
        self.bias = _param(bias)
        self.scale = _param(scale)
        self.colsum = _param(colsum)
        self.lora_u = _param(lora_u)
        self.lora_v = _param(lora_v)

    def forward(self, x: Tensor, chunk_tokens: int = 0) -> Tensor:
        return qlinear_apply(self, x, chunk_tokens)


def pack_int4(q: Tensor) -> Tensor:
    """Pack int4-range values (int8 carrier, (..., K, N)) two per byte:
    (..., K/2, N) int8, low nibble = row k, high nibble = row k + K/2 (JAX's
    halves layout, fastdm_tpu/layers/qlinear.py:42-72). Built K-contiguous: a
    (K, N) view of an (N, K) buffer gives the (K/2, N) view of an (N, K/2)
    buffer."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"pack_int4 needs even K, got {k}")
    qt = q.transpose(-1, -2)
    packed = (qt[..., :k // 2] & 0x0F) | (qt[..., k // 2:] << 4)
    return packed.to(torch.int8).transpose(-1, -2)


def _lowrank_approx(w32: Tensor, rank: int, *, iters: int = 2) -> Tuple[Tensor, Tensor]:
    """Rank-`rank` approximation of the (K, N) f32 w32 by randomized subspace
    iteration (Halko et al. 2011), as fastdm_tpu/layers/qlinear.py:86-105:
    rank + 8 oversampled directions, `iters` power iterations with QR, then
    the SVD of the small (rank + 8, N) factor. Returns (u (K, rank) f32, v
    (rank, N) f32), w32 ~ u @ v; QR and SVD run in f32 on w32's device. The
    random test matrix comes from a torch.Generator seeded with JAX's 0x5bd:
    it cannot equal jax.random.key(0x5bd)'s draw, so u and v differ from
    JAX's where w32's spectrum has no gap at `rank` (they span the same top
    subspace where it has one)."""
    gen = torch.Generator(device=w32.device).manual_seed(_LOWRANK_SEED)
    oversample = min(rank + 8, min(w32.shape))
    omega = torch.randn(w32.shape[1], oversample, generator=gen, device=w32.device,
                        dtype=torch.float32)
    y = w32 @ omega  # (K, r + p)
    for _ in range(iters):
        q, _ = torch.linalg.qr(y)
        y = w32 @ (w32.T @ q)
    q, _ = torch.linalg.qr(y)  # (K, r + p) orthonormal
    u_b, s_b, vt_b = torch.linalg.svd(q.T @ w32, full_matrices=False)
    return (q @ u_b[:, :rank]) * s_b[:rank][None, :], vt_b[:rank]


def quantize_weight(w: Tensor, quant: Optional[str], bias: Optional[Tensor] = None) -> QLinear:
    """Quantize a (K, N) weight at load time: None/"bf16" stores it as bf16,
    "int8" per-channel symmetric (+ colsum), "fp8" per-channel symmetric e4m3
    (fastdm_tpu/layers/qlinear.py:108-135, the same f32 division and
    rounding), "int4" the SVDQuant split w = u @ v + residual with the
    residual per-channel symmetric int4 and u, v rounded to bf16 only after
    the residual is formed in f32 (:136-157), "int4p" the same values packed."""
    b = None if bias is None else bias.to(torch.bfloat16)
    if quant in (None, "bf16"):
        return QLinear(w.to(torch.bfloat16).contiguous(), b)
    if quant in ("int4", "int4p"):
        w32 = w.float()
        u, v = _lowrank_approx(w32, INT4_LOWRANK_RANK)
        resid = w32 - u @ v
        scale = true_div(resid.abs().amax(dim=0).clamp_min(1e-12), 7.0)
        q4 = torch.round(resid / scale[None, :]).clamp(-8, 7).to(torch.int8)
        packed = {"w4p": pack_int4(k_contiguous(q4))} if quant == "int4p" else {"w4": q4}
        return QLinear(None, b, scale, lora_u=u.to(torch.bfloat16),
                       lora_v=v.to(torch.bfloat16), **packed)
    if quant not in ("int8", "fp8"):
        raise ValueError(f"unsupported quant type {quant!r}")
    w32 = w.float()
    amax = w32.abs().amax(dim=0).clamp_min(1e-12)
    if quant == "int8":
        scale = true_div(amax, 127.0)
        q = torch.round(w32 / scale[None, :]).clamp(-128, 127).to(torch.int8)
        return QLinear(q, b, scale, q.sum(dim=0, dtype=torch.int32))
    scale = true_div(amax, _FP8_MAX)
    q = (w32 / scale[None, :]).clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn)
    return QLinear(q, b, scale)


def fuse_and_quantize(weights: Sequence[Tensor], biases: Sequence[Optional[Tensor]],
                      quant: Optional[str]) -> QLinear:
    """Concatenate fused projections (qkv / qkv+mlp) along N, then quantize.
    A mixed bias set zero-fills the bias-free segments."""
    w = weights[0] if len(weights) == 1 else torch.cat(list(weights), dim=1)
    bias = None
    if biases and any(b is not None for b in biases):
        segs = [b if b is not None else torch.zeros(wi.shape[1], dtype=torch.float32,
                                                    device=wi.device)
                for b, wi in zip(biases, weights)]
        bias = segs[0] if len(segs) == 1 else torch.cat(segs, dim=0)
    return quantize_weight(w, quant, bias)


def qlinear_random(generator: torch.Generator, in_features: int, out_features: int, *,
                   bias: bool = True, quant: Optional[str] = None, w_std: float = 0.02,
                   device="cuda") -> QLinear:
    """Random QLinear drawn straight into its storage dtype on `device` (no f32
    master), as the JAX qlinear_random: bf16 w ~ N(0, 1) * w_std; int8 w
    uniform in [-127, 127] with scale w_std/127; fp8 w = e4m3(clip(N(0, 1) * 150,
    +-448)) with scale w_std/448; int4 / int4p values uniform in [-8, 7] (packed
    for int4p) with scale w_std/7 and lora_u, lora_v ~ N(0, 1) * 0.01 of rank
    min(32, K, N) in bf16; bias ~ N(0, 1) * 0.01."""
    k, n = in_features, out_features
    scale = colsum = None
    w4a4 = {}
    if quant in (None, "bf16"):
        w = torch.randn(k, n, generator=generator, device=device,
                        dtype=torch.bfloat16).mul_(w_std)
    elif quant == "int8":
        w = torch.randint(-127, 128, (n, k), generator=generator, device=device,
                          dtype=torch.int8).t()
        scale = torch.full((n,), w_std / 127.0, dtype=torch.float32, device=device)
        colsum = w.sum(dim=0, dtype=torch.int32)
    elif quant == "fp8":
        w = torch.randn(n, k, generator=generator, device=device, dtype=torch.bfloat16)
        w = w.mul_(150.0).clamp_(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).t()
        scale = torch.full((n,), w_std / _FP8_MAX, dtype=torch.float32, device=device)
    elif quant in ("int4", "int4p"):
        q4 = torch.randint(-8, 8, (n, k), generator=generator, device=device,
                           dtype=torch.int8).t()
        w4a4 = {"w4p": pack_int4(q4)} if quant == "int4p" else {"w4": q4}
        scale = torch.full((n,), w_std / 7.0, dtype=torch.float32, device=device)
        r = min(INT4_LOWRANK_RANK, k, n)
        w4a4["lora_u"] = torch.randn(k, r, generator=generator, device=device,
                                     dtype=torch.bfloat16).mul_(0.01)
        w4a4["lora_v"] = torch.randn(r, n, generator=generator, device=device,
                                     dtype=torch.bfloat16).mul_(0.01)
        w = None
    else:
        raise ValueError(f"unsupported quant type {quant!r}")
    b = None
    if bias:
        b = torch.randn(n, generator=generator, device=device, dtype=torch.bfloat16).mul_(0.01)
    return QLinear(w, b, scale, colsum, **w4a4)


def qlinear_slice_out(lin: QLinear, start: int, stop: int) -> QLinear:
    """A view of `lin` restricted to output columns [start, stop); exact:
    apply(slice) == apply(full)[..., start:stop] (per-token activation
    quantization does not depend on the columns). Weight (w, w4, w4p) and
    lora_v columns, scale, colsum and bias are sliced, lora_u passes through;
    no weight is copied (an 8- or 4-bit weight's columns are rows of its
    (N, K) buffer)."""
    def cut(t: Optional[Tensor]) -> Optional[Tensor]:
        return None if t is None else t[start:stop]

    def cols(t: Optional[Tensor]) -> Optional[Tensor]:
        return None if t is None else t[:, start:stop]

    return QLinear(cols(lin.w), cut(lin.bias), cut(lin.scale), cut(lin.colsum),
                   w4=cols(lin.w4), w4p=cols(lin.w4p), lora_u=lin.lora_u,
                   lora_v=cols(lin.lora_v))


def qlinear_apply(lin: QLinear, x: Tensor, chunk_tokens: int = 0) -> Tensor:
    """y = x @ w (+ bias), x: (..., K) -> (..., N), with per-token activation
    quantization when w is int8, fp8 or W4A4.

    chunk_tokens > 0 (dividing the flattened row count) runs the rows in
    chunks and concatenates: exact (quantization and epilogue are per row),
    and it bounds the matmul's transients to O(chunk * N).

    A row shard of tensor parallelism (lin.tp_reduce) takes this rank's K
    columns of x and returns the whole layer's output, quantized on the
    whole row's statistics (parallel/tensor_parallel.py row_parallel_apply);
    it runs unchunked, one reduction over its tp group rather than one a
    chunk (its transients are the rank's K / tp columns). A gathered column
    shard (lin.tp_gather) returns the whole output too. Under autograd a
    column shard's input passes through tp_copy and the gather is tp_gather
    (the collectives' gradients, parallel/tensor_parallel.py)."""
    grad = False
    if lin.tp_column is not None:
        from fastdm_tpu_torch.parallel.tensor_parallel import needs_grad, tp_copy, tp_gather

        # one tp_copy and one tp_gather a call: no chunks under autograd
        grad = needs_grad(x, *lin.parameters())
        x = tp_copy(x, lin.tp_column)
    orig_shape = x.shape
    rows = 1
    for s in orig_shape[:-1]:
        rows *= s
    if (chunk_tokens and lin.tp_reduce is None and not grad and rows > chunk_tokens
            and rows % chunk_tokens == 0):
        x2 = x.reshape(rows, orig_shape[-1])
        ys = [qlinear_apply(lin, x2[i:i + chunk_tokens]) for i in range(0, rows, chunk_tokens)]
        return torch.cat(ys, dim=0).reshape(*orig_shape[:-1], ys[0].shape[-1])
    x2 = x.reshape(-1, orig_shape[-1])
    if x2.stride(-1) != 1:
        # a view whose rows are strided (e.g. the (1, H*W, C) token view of
        # an NCHW map: reshape keeps it a view for one batch entry); the
        # quantizer and GEMM kernels read rows with a contiguous last dim
        x2 = x2.contiguous()
    if lin.tp_reduce is not None:
        from fastdm_tpu_torch.parallel.tensor_parallel import row_parallel_apply

        out = row_parallel_apply(lin, x2, x.dtype)
    else:
        out = _apply_local(lin, x2, x.dtype)
        if lin.tp_gather is not None:
            out = tp_gather(out, lin.tp_gather)
    return out.reshape(*orig_shape[:-1], out.shape[-1])


def _apply_local(lin: QLinear, x2: Tensor, dtype) -> Tensor:
    """The layer's own (M, K) -> (M, N) product on its weights."""
    if lin.w4 is not None or lin.w4p is not None:
        xq, xs = quantize_to_int4(x2)
        # the SVDQuant low-rank side path's (M, r) activations, a plain product;
        # its (r, N) half and the add run in w4a4_linear's epilogue on the card
        xu = x2.to(torch.bfloat16) @ lin.lora_u
        return w4a4_linear(xq, lin.w4 if lin.w4 is not None else lin.w4p, xs, lin.scale, dtype,
                           lin.bias, xu, lin.lora_v)
    w = lin.w
    if w.dtype == torch.int8:
        xq, xs, xzp = quantize_to_int8(x2, symmetric=False)
        return int8_matmul(xq, w, xs, lin.scale, dtype, lin.colsum, xzp, lin.bias)
    if w.dtype == torch.float8_e4m3fn:
        xq, xs = quantize_to_fp8(x2)
        return fp8_matmul(xq, w, xs, lin.scale, dtype, lin.bias)
    if w.dtype == torch.bfloat16:
        w = w.to(dtype)
        return torch.addmm(lin.bias.to(dtype), x2, w) if lin.bias is not None else x2 @ w
    raise NotImplementedError(f"QLinear weight dtype {w.dtype} is not in the port")
