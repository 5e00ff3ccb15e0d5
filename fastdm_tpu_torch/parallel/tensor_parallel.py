"""Tensor parallelism over the mesh's tp axis, the Megatron way (the port's
form of the JAX engine's tp: shard_params_by_name's name rules,
fastdm_tpu/parallel/mesh.py:57-112, with GSPMD inserting the collectives).

A rank holds a shard of each split QLinear of the denoiser blocks:
  column -- the output columns of each fused part (q | k | v, q | k | v |
            mlp, k | v), each attention part cut by whole heads: the rank
            computes its heads (and its slice of the MLP hidden) end to end.
            The AdaLN modulations are cut in contiguous column chunks and
            all-gathered after the matmul (their output is one token a
            sample, needed whole).
  row    -- the input rows that match the column layer before it (the
            rank's heads, then its MLP slice for FLUX's single-block
            proj_out). The quantized layers quantize each activation row on
            the statistics of the WHOLE row (a MAX all-reduce of the rank's
            per-row [-min, max] or max|x|), so a rank's quantized values,
            scales and zero points are bit-identical to the unsplit layer's
            on its columns; the GEMM writes an f32 partial without the bias,
            the partials are summed over the tp group in f32, the bias joins
            once and the sum is rounded once. The W4A4 low-rank branch's (M, r)
            partial x @ lora_u is summed in f32 too before @ lora_v.
Activations between the blocks stay whole and equal on every rank, as under
JAX's placement. Wan normalizes q and k across all heads: a rank's heads
give per-token f32 sums of squares, summed over the group, then the
given-statistics norms (kernels rms_sumsq, rms_norm_given,
qk_norm_rope_given, qk_norm_rope2_given).

Where a group's heads or MLP width do not divide by tp, its layers stay whole
on every rank (the same result; JAX keeps a leaf whose dim does not divide
replicated, mesh.py:103-109).

The collectives go through a TPGroup: DistTPGroup over the mesh's tp process
group (NCCL on the card, gloo on the CPU), or one of the VirtualTPGroups of
run_virtual_ranks, which runs its ranks as threads of one process and sums
their tensors in rank order (chip_smoke.py drives the real shard shapes on
one card so). Sums over a process group follow the backend's order; the
virtual group's is rank order: the two agree to f32 rounding, not bit for bit.

Under autograd (a bf16 model whose parameters or input need a gradient:
parallel/mesh.py flux_dryrun_step) the collectives are Megatron's three
Functions: tp_reduce (forward the sum all-reduce of a row shard's f32
partial, backward the identity), tp_copy (forward the identity at the input
of every column shard and of a replicated tensor used on the rank's heads,
backward the sum all-reduce of its gradient) and tp_gather (forward the
all-gather of a gathered column shard's output, backward the rank's slice).
A replicated parameter used outside them gets its whole gradient on every
rank. The quantized row layers' MAX all-reduces of the activation
statistics and Wan's norm statistics have no gradient: they raise under
autograd.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fastdm_tpu_torch.kernels import (
    fp8_matmul_partial,
    int4_matmul_partial,
    int8_matmul_partial,
    quantize_stats,
    quantize_to_fp8_given,
    quantize_to_int4_given,
    quantize_to_int8_given,
    rms_sumsq,
    unpack_int4,
)
from fastdm_tpu_torch.layers.qlinear import QLinear, pack_int4
from fastdm_tpu_torch.parallel.mesh import tp_kind

Tensor = torch.Tensor
# (width, unit) of each fused part of a split dimension: a part is cut into tp
# equal slices, each a multiple of unit (head_dim for an attention part, 1
# for an MLP hidden or a modulation)
Parts = Sequence[Tuple[int, int]]


# ---------------------------------------------------------------- groups


class TPGroup:
    """The tp axis as a split layer sees it: size, this rank's index, and the
    two collectives the layers need. Shared, never copied (a module copy for
    offload keeps its group)."""

    size: int = 1
    rank: int = 0

    def all_reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        raise NotImplementedError

    def all_gather(self, t: Tensor) -> Tensor:
        """The ranks' t concatenated along the last dim, in rank order."""
        raise NotImplementedError

    def __deepcopy__(self, memo):
        return self


class DistTPGroup(TPGroup):
    """The tp axis of a mesh (parallel/mesh.py Axis) over torch.distributed."""

    def __init__(self, axis):
        self.size, self.rank, self.group = axis.size, axis.rank, axis.group

    def all_reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        import torch.distributed as dist

        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.group)
        return t

    def all_gather(self, t: Tensor) -> Tensor:
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=-1)


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor, group: TPGroup) -> Tensor:
        # a copy: a process group reduces in place, and t is this rank's own partial
        return group.all_reduce(t.detach().clone(memory_format=torch.contiguous_format), "sum")

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor, group: TPGroup) -> Tensor:
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: Tensor):
        return ctx.group.all_reduce(g.clone(memory_format=torch.contiguous_format), "sum"), None


class _TPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor, group: TPGroup) -> Tensor:
        ctx.rank, ctx.width = group.rank, t.shape[-1]
        return group.all_gather(t.detach())

    @staticmethod
    def backward(ctx, g: Tensor):
        return g[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width], None


def tp_reduce(t: Tensor, group: TPGroup) -> Tensor:
    """The sum of the ranks' t, whole on every rank; its gradient passes
    to each rank's t unchanged. Without a gradient to record, the group's
    all-reduce (in place over a process group)."""
    if not needs_grad(t):
        return group.all_reduce(t, "sum")
    return _TPReduce.apply(t, group)


def tp_copy(t: Tensor, group: TPGroup) -> Tensor:
    """t itself; its gradient is summed over the group (each rank's use of t
    gives its heads' or columns' part)."""
    if not needs_grad(t):
        return t
    return _TPCopy.apply(t, group)


def tp_gather(t: Tensor, group: TPGroup) -> Tensor:
    """The ranks' t concatenated along the last dim; rank r's gradient is
    its slice of the whole gradient."""
    if not needs_grad(t):
        return group.all_gather(t)
    return _TPGather.apply(t, group)


def needs_grad(*tensors) -> bool:
    """Autograd records this call: grad mode is on and a tensor needs a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _Hub:
    """What the virtual ranks of one group share: a slot a rank and a barrier."""

    def __init__(self, size: int, timeout: float):
        self.slots: List[Optional[Tensor]] = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)


class VirtualTPGroup(TPGroup):
    """One of `size` ranks run as threads of one process: a collective hands
    each rank every rank's tensor and each computes the same reduction in
    rank order."""

    def __init__(self, hub: _Hub, rank: int):
        self.hub, self.size, self.rank = hub, len(hub.slots), rank

    def _exchange(self, t: Tensor) -> List[Tensor]:
        hub = self.hub
        # detached: no rank's tensor enters another rank's graph (the
        # Functions above carry the gradients across)
        hub.slots[self.rank] = t.detach()
        hub.barrier.wait()
        ts = list(hub.slots)
        hub.barrier.wait()  # every rank has read the slots before they are reused
        return ts

    def all_reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        ts = self._exchange(t)
        out = ts[0]
        for x in ts[1:]:
            out = out + x if op == "sum" else torch.maximum(out, x)
        return out

    def all_gather(self, t: Tensor) -> Tensor:
        return torch.cat(self._exchange(t), dim=-1)


def virtual_groups(size: int, timeout: float = 600.0) -> List[VirtualTPGroup]:
    hub = _Hub(size, timeout)
    return [VirtualTPGroup(hub, r) for r in range(size)]


def run_virtual_ranks(fn: Callable[[int], object], groups: Sequence[VirtualTPGroup],
                      grad: bool = False) -> list:
    """fn(rank) on one thread a rank -> the ranks' results in rank order. A
    rank that raises breaks the others' barriers; the first error is raised
    here.

    Each rank runs in inference mode, or with grad (training) in grad mode
    with its backward on its own thread
    (torch.autograd.set_multithreading_enabled(False), thread-local): on
    CUDA the autograd engine would otherwise run every rank's backward on
    one worker thread per device, where a rank waiting in a backward
    collective blocks the ranks queued behind it until the hub's barrier
    times out."""
    out: list = [None] * len(groups)
    errors: list = []

    def body(r: int) -> None:
        try:
            if grad:
                with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
                    out[r] = fn(r)
            else:
                with torch.inference_mode():
                    out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001  (re-raised below)
            errors.append((r, e))
            groups[r].hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(len(groups))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = min(errors, key=lambda e: isinstance(e[1], threading.BrokenBarrierError))
        raise RuntimeError(f"virtual tp rank {first[0]} failed") from first[1]
    return out


# ---------------------------------------------------------------- splits


def parts_divide(parts: Parts, tp: int) -> bool:
    return all(w % (tp * u) == 0 for w, u in parts)


def _ranges(parts: Parts, tp: int, rank: int) -> List[Tuple[int, int]]:
    """The [start, stop) ranges of rank's slice of each part, in part order."""
    if not parts_divide(parts, tp):
        raise ValueError(f"parts {list(parts)} do not divide into {tp} whole units")
    out, off = [], 0
    for w, _ in parts:
        per = w // tp
        out.append((off + rank * per, off + (rank + 1) * per))
        off += w
    return out


def _cut(t: Optional[Tensor], dim: int, ranges) -> Optional[Tensor]:
    """A fresh tensor of t's slices `ranges` along dim, concatenated."""
    if t is None:
        return None
    if t.dim() == 2 and t.stride(0) == 1 and t.stride(1) != 1:
        # the (K, N) view of a K-contiguous (N, K) buffer: cut the buffer, keep the layout
        return _cut(t.t(), 1 - dim, ranges).t()
    return torch.cat([t.narrow(dim, a, b - a) for a, b in ranges], dim=dim).contiguous()


def _unpack_halves(p: Tensor) -> Tensor:
    """pack_int4's inverse on any device (the plain unpack_int4): (K/2, N)
    packed bytes -> (K, N) int4 values in int8 carriers."""
    pt = p.transpose(-1, -2)
    return torch.cat([(pt << 4) >> 4, pt >> 4], dim=-1).transpose(-1, -2)


def _check_whole(lin: QLinear) -> None:
    if lin.tp_reduce is not None or lin.tp_column is not None:
        raise ValueError("this QLinear is already a tp shard")


def qlinear_split_columns(lin: QLinear, parts: Parts, tp: int, rank: int) -> QLinear:
    """Rank's column shard of `lin`: the rank's slice of each fused part of
    N (`parts`, which must sum to N), concatenated in part order. Weight,
    lora_v, scale, colsum and bias columns are cut (the per-column int8 / fp8
    / int4 scales and column sums are the whole weight's, as JAX quantizes
    before it places); lora_u is whole. Exact: the shard's output equals
    lin's output on those columns."""
    _check_whole(lin)
    n = lin.scale.numel() if lin.scale is not None else lin.w.shape[1]
    if sum(w for w, _ in parts) != n:
        raise ValueError(f"parts {list(parts)} do not cover N = {n}")
    rg = _ranges(parts, tp, rank)
    w = _cut(lin.w, 1, rg)
    w4, w4p = _cut(lin.w4, 1, rg), _cut(lin.w4p, 1, rg)
    lora_u = None if lin.lora_u is None else lin.lora_u.detach().clone()
    return QLinear(w, _cut(lin.bias, 0, rg), _cut(lin.scale, 0, rg), _cut(lin.colsum, 0, rg),
                   w4=w4, w4p=w4p, lora_u=lora_u, lora_v=_cut(lin.lora_v, 1, rg))


def qlinear_split_rows(lin: QLinear, parts: Parts, tp: int, rank: int) -> QLinear:
    """Rank's row shard of `lin`: the K rows of the rank's slice of each part
    of K (the column layer before it gives its activation in that order).
    scale and bias stay whole (the bias joins after the sum over the group);
    an int8 layer's colsum becomes the column sum of the shard's rows; an
    int4p weight is unpacked, cut and packed again in the shard's own halves
    layout (low nibble row k, high nibble row k + K_shard/2: a contiguous cut
    of the packed rows would not be a K cut); lora_u's rows are cut, lora_v
    is whole."""
    _check_whole(lin)
    k = lin.lora_u.shape[0] if lin.lora_u is not None else (
        lin.w.shape[0] if lin.w is not None else lin.w4.shape[0])
    if sum(w for w, _ in parts) != k:
        raise ValueError(f"parts {list(parts)} do not cover K = {k}")
    rg = _ranges(parts, tp, rank)
    w = _cut(lin.w, 0, rg)
    colsum = None if lin.colsum is None else w.sum(dim=0, dtype=torch.int32)
    w4 = _cut(lin.w4, 0, rg)
    w4p = None
    if lin.w4p is not None:
        q = _cut(_unpack_halves(lin.w4p), 0, rg)
        w4p = pack_int4(q.t().contiguous().t())
    bias = None if lin.bias is None else lin.bias.detach().clone()
    scale = None if lin.scale is None else lin.scale.detach().clone()
    lora_v = None if lin.lora_v is None else lin.lora_v.detach().clone()
    return QLinear(w, bias, scale, colsum, w4=w4, w4p=w4p, lora_u=_cut(lin.lora_u, 0, rg),
                   lora_v=lora_v)


# ---------------------------------------------------------------- forwards


def _bf16_partial(x2: Tensor, w: Tensor) -> Tensor:
    """x2 @ w with an f32 result (a library product: JAX computes the bf16
    product outside any Pallas kernel). On the card cuBLAS writes the f32
    product of the bf16 operands (mm's out_dtype, a CUDA-only overload); on
    the host the operands are widened first (the same f32 sums)."""
    if x2.is_cuda:
        return torch.mm(x2, w, out_dtype=torch.float32)
    return x2.float() @ w.float()


class _Bf16Partial(torch.autograd.Function):
    """_bf16_partial with the gradients of the bf16 product: the f32
    partial's gradient is a widened bf16 value (the layer's output is
    rounded to bf16 after the sum), so the backward's products run in bf16
    as an unsplit layer's do."""

    @staticmethod
    def forward(ctx, x2: Tensor, w: Tensor) -> Tensor:
        ctx.save_for_backward(x2, w)
        return _bf16_partial(x2, w)

    @staticmethod
    def backward(ctx, g: Tensor):
        x2, w = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x2.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def row_parallel_apply(lin: QLinear, x2: Tensor, out_dtype) -> Tensor:
    """A row shard's output on its rows x2 (M, K_shard): the whole layer's
    (M, N), equal on every rank of lin.tp_reduce. Under autograd (bf16 only)
    the partial sums are reduced by tp_reduce."""
    g = lin.tp_reduce
    low = None
    if needs_grad(x2, *lin.parameters()) and (lin.w is None or lin.w.dtype != torch.bfloat16):
        raise NotImplementedError(
            "a quantized row-parallel layer has no gradient: the MAX all-reduce of its "
            "activation statistics (quantize_stats) and the per-token quantizer are not "
            "differentiable; train the bf16 model (quant=None)")
    if lin.w4 is not None or lin.w4p is not None:
        w = lin.w4 if lin.w4 is not None else unpack_int4(lin.w4p)
        xq, xs = quantize_to_int4_given(x2, g.all_reduce(quantize_stats(x2, True), "max"))
        part = int4_matmul_partial(xq, w, xs, lin.scale)
        del w
        low = g.all_reduce(x2.to(torch.bfloat16).float() @ lin.lora_u.float(), "sum")
    elif lin.w.dtype == torch.int8:
        xq, xs, xzp = quantize_to_int8_given(
            x2, g.all_reduce(quantize_stats(x2, False), "max"), False)
        part = int8_matmul_partial(xq, lin.w, xs, lin.scale, lin.colsum, xzp)
    elif lin.w.dtype == torch.float8_e4m3fn:
        xq, xs = quantize_to_fp8_given(x2, g.all_reduce(quantize_stats(x2, True), "max"))
        part = fp8_matmul_partial(xq, lin.w, xs, lin.scale)
    elif lin.w.dtype == torch.bfloat16:
        part = _Bf16Partial.apply(x2.to(torch.bfloat16), lin.w)
    else:
        raise NotImplementedError(f"QLinear weight dtype {lin.w.dtype} is not in the port")
    out = tp_reduce(part, g)
    if lin.bias is not None:
        out = out + lin.bias.float()
    out = out.to(out_dtype)
    if low is not None:
        # the low-rank side path in bf16 after the sum, added as the unsplit layer adds it
        out = out + (low.to(torch.bfloat16) @ lin.lora_v).to(out.dtype)
    return out


def norm_stats(x: Tensor, tp: TPGroup) -> Tensor:
    """Per-row f32 sums of squares of the rank's columns, summed over tp."""
    if needs_grad(x):
        raise NotImplementedError("Wan's across-heads q / k norm statistics under tp "
                                  "(norm_stats: rms_sumsq summed over the group) have no gradient")
    return tp.all_reduce(rms_sumsq(x), "sum")


# ---------------------------------------------------------------- blocks


def _split(owner: nn.Module, attr: str, path: str, parts: Parts, tp: TPGroup,
           gather: bool = False) -> None:
    """owner.attr, the QLinear at module path `path`, replaced by its shard:
    the family code gives the parts, the name rules (parallel/mesh.py
    tp_kind) the kind. A column shard's output is all-gathered whole after
    its matmul with `gather`; a row shard reduces its partial sums."""
    lin = getattr(owner, attr)
    if lin is None:
        return
    kind = tp_kind(path)
    if kind == "column":
        new = qlinear_split_columns(lin, parts, tp.size, tp.rank)
        new.tp_column = tp
        if gather:
            new.tp_gather = tp
    elif kind == "row":
        new = qlinear_split_rows(lin, parts, tp.size, tp.rank)
        new.tp_reduce = tp
    else:
        raise ValueError(f"{path}: the name rules keep it whole on every rank")
    setattr(owner, attr, new)


def _mod(owner: nn.Module, attr: str, path: str, tp: TPGroup) -> None:
    """An AdaLN modulation: contiguous column chunks, all-gathered."""
    lin = getattr(owner, attr)
    n = lin.scale.numel() if lin.scale is not None else lin.w.shape[1]
    if n % tp.size == 0:
        _split(owner, attr, path, [(n, 1)], tp, gather=True)


def _ff(ff, path: str, tp: TPGroup, halves: int = 1) -> None:
    """A FeedForward's proj (column) and out (row) by the hidden width; a
    GEGLU proj (halves 2: hidden | gate) has each half cut alike, so that the
    rank's gelu_and_mul pairs its own hidden and gate columns."""
    if ff is None:
        return
    hidden = ff.out.lora_u.shape[0] if ff.out.lora_u is not None else (
        ff.out.w.shape[0] if ff.out.w is not None else ff.out.w4.shape[0])
    if hidden % tp.size == 0:
        _split(ff, "proj", f"{path}.proj", [(hidden, 1)] * halves, tp)
        _split(ff, "out", f"{path}.out", [(hidden, 1)], tp)


def _joint_attn(attn, path: str, heads: int, hd: int, tp: TPGroup) -> None:
    """FLUX / SD3.5 / Qwen joint attention: per-head norms (unchanged), qkv
    and add_qkv by part and head, to_out and to_add_out by head rows."""
    if attn is None or heads % tp.size:
        return
    d = heads * hd
    qkv = [(d, hd)] * 3
    _split(attn, "qkv", f"{path}.qkv", qkv, tp)
    _split(attn, "add_qkv", f"{path}.add_qkv", qkv, tp)
    _split(attn, "to_out", f"{path}.to_out", [(d, hd)], tp)
    _split(attn, "to_add_out", f"{path}.to_add_out", [(d, hd)], tp)
    attn.tp = tp


def _slice_heads(t: Optional[Tensor], d: int, tp: TPGroup) -> Optional[nn.Parameter]:
    """The rank's columns of a (D,) across-heads norm weight."""
    if t is None:
        return None
    per = d // tp.size
    return nn.Parameter(t.detach()[tp.rank * per:(tp.rank + 1) * per].clone(),
                        requires_grad=False)


def _wan_block(block, path: str, cfg, tp: TPGroup) -> None:
    heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
    d = heads * hd
    if heads % tp.size == 0:
        a1, a2 = block.attn1, block.attn2
        _split(a1, "qkv", f"{path}.attn1.qkv", [(d, hd)] * 3, tp)
        _split(a1, "to_out", f"{path}.attn1.to_out", [(d, hd)], tp)
        a1.norm_q, a1.norm_k = _slice_heads(a1.norm_q, d, tp), _slice_heads(a1.norm_k, d, tp)
        a1.tp = tp
        _split(a2, "q", f"{path}.attn2.q", [(d, hd)], tp)
        _split(a2, "kv", f"{path}.attn2.kv", [(d, hd)] * 2, tp)
        _split(a2, "add_k", f"{path}.attn2.add_k", [(d, hd)], tp)
        _split(a2, "add_v", f"{path}.attn2.add_v", [(d, hd)], tp)
        _split(a2, "to_out", f"{path}.attn2.to_out", [(d, hd)], tp)
        a2.norm_q, a2.norm_k = _slice_heads(a2.norm_q, d, tp), _slice_heads(a2.norm_k, d, tp)
        a2.norm_added_k = _slice_heads(a2.norm_added_k, d, tp)
        a2.tp = tp
    _ff(block.ffn, f"{path}.ffn", tp)


def _sdxl_block(block, path: str, cfg, tp: TPGroup) -> None:
    """An SDXL BasicTransformerBlock: attn1's q | k | v, attn2's q, k | v and
    IP-Adapter k | v by heads, both out-projections by head rows; the GEGLU
    feed-forward by halves. A block whose heads tp does not divide (SDXL's
    10 heads of 640 at tp 4) keeps its attention whole."""
    c = block.norm1["gamma"].numel()
    hd = cfg.head_dim
    if (c // hd) % tp.size == 0:
        a1, a2 = block.attn1, block.attn2
        _split(a1, "qkv", f"{path}.attn1.qkv", [(c, hd)] * 3, tp)
        _split(a1, "out", f"{path}.attn1.out", [(c, hd)], tp)
        a1.tp = tp
        _split(a2, "q", f"{path}.attn2.q", [(c, hd)], tp)
        _split(a2, "kv", f"{path}.attn2.kv", [(c, hd)] * 2, tp)
        _split(a2, "ipadp_kv", f"{path}.attn2.ipadp_kv", [(c, hd)] * 2, tp)
        _split(a2, "out", f"{path}.attn2.out", [(c, hd)], tp)
        a2.tp = tp
    _ff(block.ff, f"{path}.ff", tp, halves=2)


def shard_ip_adapter_kv(attn2, path: str, head_dim: int) -> None:
    """The IP-Adapter k | v just attached to a cross-attention that tp split
    by heads (attn2.tp), cut to the rank's heads like its text k | v."""
    if attn2.tp is not None and attn2.ipadp_kv is not None:
        c = attn2.ipadp_kv.scale.numel() // 2 if attn2.ipadp_kv.scale is not None else \
            attn2.ipadp_kv.w.shape[1] // 2
        _split(attn2, "ipadp_kv", f"{path}.ipadp_kv", [(c, head_dim)] * 2, attn2.tp)


def shard_block(block: nn.Module, path: str, cfg, tp: TPGroup) -> nn.Module:
    """Rank tp.rank's shard of one denoiser block at module path `path`, in
    place (the whole weights are dropped): the family's layers split by
    parts and heads, the kind of each (column / row) by the name rules of
    parallel/mesh.py (tp_kind). A pipeline placeholder passes through."""
    from fastdm_tpu_torch.models.flux import FluxDualBlock, FluxSingleBlock
    from fastdm_tpu_torch.models.qwenimage import QwenBlock
    from fastdm_tpu_torch.models.sd35 import SD3JointBlock
    from fastdm_tpu_torch.models.sdxl import SDXLTransformerBlock
    from fastdm_tpu_torch.models.wan import WanBlock

    if tp is None or tp.size == 1:
        return block
    if isinstance(block, SDXLTransformerBlock):
        _sdxl_block(block, path, cfg, tp)
        return block
    heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
    if isinstance(block, FluxDualBlock):
        _mod(block.norm1, "linear", f"{path}.norm1.linear", tp)
        _mod(block.norm1_context, "linear", f"{path}.norm1_context.linear", tp)
        _joint_attn(block.attn, f"{path}.attn", heads, hd, tp)
        _ff(block.ff, f"{path}.ff", tp)
        _ff(block.ff_context, f"{path}.ff_context", tp)
    elif isinstance(block, FluxSingleBlock):
        _mod(block.norm, "linear", f"{path}.norm.linear", tp)
        d, mlp = heads * hd, cfg.mlp_hidden_dim
        parts = [(d, hd)] * 3 + [(mlp, 1)]
        if parts_divide(parts, tp.size):
            _split(block, "qkv_mlp", f"{path}.qkv_mlp", parts, tp)
            # the rank's attention rows, then its mlp rows: its local cat order
            _split(block, "proj_out", f"{path}.proj_out", [(d, hd), (mlp, 1)], tp)
            block.attn.tp = tp
    elif isinstance(block, SD3JointBlock):
        _mod(block.norm1, "linear", f"{path}.norm1.linear", tp)
        _mod(block.norm1_context, "linear", f"{path}.norm1_context.linear", tp)
        _joint_attn(block.attn, f"{path}.attn", heads, hd, tp)
        _joint_attn(block.attn2, f"{path}.attn2", heads, hd, tp)
        _ff(block.ff, f"{path}.ff", tp)
        _ff(block.ff_context, f"{path}.ff_context", tp)
    elif isinstance(block, QwenBlock):
        _mod(block, "img_mod", f"{path}.img_mod", tp)
        _mod(block, "txt_mod", f"{path}.txt_mod", tp)
        _joint_attn(block.attn, f"{path}.attn", heads, hd, tp)
        _ff(block.img_mlp, f"{path}.img_mlp", tp)
        _ff(block.txt_mlp, f"{path}.txt_mlp", tp)
    elif isinstance(block, WanBlock):
        _wan_block(block, path, cfg, tp)
    elif any(True for _ in block.parameters()):
        raise NotImplementedError(f"{type(block).__name__} at {path!r} has no tp split in the port")
    return block


# each family's blocks, by the model's class: the stack's attribute -> the
# checkpoint's stack prefix (a pipeline placeholder carries it; None: a stack
# the pipeline does not split). SD3.5's last_block is one block, not a stack.
BLOCK_STACKS = {"FluxTransformer": {"dual_blocks": "transformer_blocks",
                                    "single_blocks": "single_transformer_blocks"},
                "FluxControlNet": {"dual_blocks": None, "single_blocks": None},
                "SD3Transformer": {"dual_blocks": None, "std_blocks": None, "last_block": None},
                "QwenImageTransformer": {"blocks": "transformer_blocks"},
                "WanTransformer": {"blocks": "blocks"}}
# the SDXL UNet's and ControlNet's blocks sit in their stages' Transformer2Ds
SDXL_MODELS = ("SDXLUNet", "SDXLControlNet")
_SDXL_BLOCK = re.compile(r"(down\.\d+|mid|up\.\d+)\.attns\.\d+\.blocks\.\d+")


def is_block_path(model_class: str, path: str) -> bool:
    """Whether module path `path` ("dual_blocks.3", "last_block",
    "down.1.attns.0.blocks.1") of a model of class `model_class` is one of
    its blocks."""
    if model_class in SDXL_MODELS:
        return _SDXL_BLOCK.fullmatch(path) is not None
    if model_class not in BLOCK_STACKS:
        raise NotImplementedError(f"{model_class} has no tp split in the port")
    stack, _, index = path.partition(".")
    if stack not in BLOCK_STACKS[model_class]:
        return False
    return index.isdigit() or (not index and stack == "last_block")


def block_paths(model: nn.Module) -> List[str]:
    """The module paths of model's blocks, in order."""
    name = type(model).__name__
    if name in SDXL_MODELS:
        return [p for p, _ in model.named_modules() if is_block_path(name, p)]
    if name not in BLOCK_STACKS:
        raise NotImplementedError(f"{name} has no tp split in the port")
    paths = []
    for stack in BLOCK_STACKS[name]:
        m = getattr(model, stack)
        paths += [f"{stack}.{i}" for i in range(len(m))] if isinstance(m, nn.ModuleList) \
            else [stack]
    return paths


def shard_model(model: nn.Module, cfg, tp: Optional[TPGroup]) -> nn.Module:
    """Every block of a whole model replaced by rank tp.rank's shard, in
    place; the embedders, norm_out and the final proj_out stay whole."""
    if tp is None or tp.size == 1:
        return model
    for path in block_paths(model):
        shard_block(model.get_submodule(path), path, cfg, tp)
    return model


def shard_copy(model: nn.Module, cfg, tp: TPGroup) -> nn.Module:
    """Rank tp.rank's shard of a whole model as a new module tree that shares
    every tensor it keeps whole with `model` (the embedders, the norms, the
    output head) and leaves `model` as it is: what a rank of virtual ranks
    in one process holds (chip_smoke.py), at the memory of its shard."""
    import copy

    shared = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    return shard_model(copy.deepcopy(model, shared), cfg, tp)
