"""Wrappers of the hand-written Hopper kernels (sources in ../csrc/).

Each wrapper checks device, dtype, shape, strides and alignment, allocates its
outputs with torch.empty, launches on PyTorch's current stream through the
ctypes interface of its library (kernels/build.py), raises if the launch
returns a CUDA error, and counts its launches in ``<wrapper>.launches`` — a
plain integer that chip_smoke.py reads to show that the main path went through
the kernel. There is no fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fastdm_tpu_torch.kernels import contracts, tma
from fastdm_tpu_torch.kernels.build import load_library
from fastdm_tpu_torch.kernels.registry import kernel_registry

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)

_LOG2E = 1.4426950408889634


def _entry(lib_name: str, fn_name: str, argtypes):
    """(library, C launcher) with its ctypes signature declared: every pointer
    and the stream as c_void_p, so none is cut to a 32-bit int."""
    lib = load_library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = _I
    return lib, fn


def _check_launch(lib: ctypes.CDLL, prefix: str, code: int, what: str) -> None:
    if code != 0:
        f = getattr(lib, f"{prefix}_error_string")
        f.argtypes, f.restype = [_I], ctypes.c_char_p
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({f(code).decode()})")


def _require(cond: bool, kernel: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"[{kernel}] {msg}")


def _check_tensor(x: Tensor, kernel: str, name: str, device: torch.device) -> None:
    _require(x.is_cuda and x.device == device, kernel, f"{name} must lie on {device}")
    _require(x.dtype == torch.bfloat16, kernel, f"{name} must be bfloat16, got {x.dtype}")
    _require(x.stride(-1) == 1, kernel, f"{name} must have a contiguous last dim")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# the norm weights' dtype -> the kernels' gamma_kind (0: no weights); the
# rmsnorm and qk-norm+RoPE kernels read bf16 or f32 weights as they are
_GAMMA_KINDS = {torch.bfloat16: 1, torch.float32: 2}


def _strides(t: Tensor, dims) -> Tuple[int, ...]:
    """t's strides along `dims`, 0 along a dim of size 1 (whose stride
    addresses nothing and may be any value)."""
    return tuple(t.stride(d) if t.shape[d] > 1 else 0 for d in dims)


# ---------------------------------------------------------------- rmsnorm

def _rows3(x: Tensor, kernel: str) -> Tuple[Tensor, int, int, int]:
    """x (..., heads, dim) as csrc/rmsnorm.cu's rows: (the (tokens, heads,
    dim) view, heads, token stride, head stride), 4-byte aligned. A view
    whenever the leading dims collapse: the kernels read rows at any token
    and head stride (a per-head view of a fused QKV output, a column slice
    of a wider row) in place."""
    dim = x.shape[-1]
    _require(dim % 2 == 0, kernel, f"last dim {dim} must be even")
    heads = x.shape[-2] if x.dim() >= 2 else 1
    x3 = x.reshape(-1, heads, dim)
    token_stride, head_stride = _strides(x3, (0, 1))
    _require(token_stride % 2 == 0 and head_stride % 2 == 0 and x3.data_ptr() % 4 == 0, kernel,
             "rows must be 4-byte aligned")
    return x3, heads, token_stride, head_stride


def _gamma(weight: Optional[Tensor], dim: int, kernel: str, dev) -> Tuple[Optional[Tensor], int]:
    if weight is None:
        return None, 0
    _require(weight.numel() == dim and weight.device == dev, kernel,
             f"weight must be ({dim},) on {dev}")
    _require(weight.dtype in _GAMMA_KINDS, kernel,
             f"weight must be bfloat16 or float32, got {weight.dtype}")
    return weight.reshape(dim).contiguous(), _GAMMA_KINDS[weight.dtype]



# csrc/rmsnorm.cu's paths
RMS_HEAD_ROWS, RMS_WIDE_ROWS, RMS_TAIL = 0, 1, 2
RMS_HEAD_ROWS_PER_BLOCK = 64  # at most; whole tokens where a token has fewer rows
RMS_WIDE_VECS = 2             # 16-byte vectors per thread on the wide path (kWideVecs)


def rms_norm_plan(dim: int, heads: int, vector_ok: bool) -> Tuple[int, int, int]:
    """(path, threads per block, rows per block) of csrc/rmsnorm.cu for rows of
    `dim` bf16 elements, `heads` rows per token. vector_ok: rows, strides and
    weight 16-byte aligned. Head rows (dim a multiple of 8 up to 256): a
    power-of-two group of >= dim / 8 lanes per row, two rows per thread, a
    block of whole tokens; wide rows (up to 8192): one block per row of
    RMS_WIDE_VECS vectors per thread; otherwise the tail, one warp per row
    (its block shape fixed in the kernel: (RMS_TAIL, 0, 0))."""
    if vector_ok and dim % 8 == 0 and dim <= 8192:
        vecs = dim // 8
        if vecs <= 32:
            lanes = 1 << (vecs - 1).bit_length()
            rows = (heads * (RMS_HEAD_ROWS_PER_BLOCK // heads)
                    if heads <= RMS_HEAD_ROWS_PER_BLOCK else RMS_HEAD_ROWS_PER_BLOCK)
            return RMS_HEAD_ROWS, 32 * -(-(-(-rows // 2) * lanes) // 32), rows
        return RMS_WIDE_ROWS, 32 * -(-vecs // (32 * RMS_WIDE_VECS)), 1
    return RMS_TAIL, 0, 0


@kernel_registry.register("rmsnorm", "cuda")
def rms_norm_cuda(x: Tensor, weight: Optional[Tensor], eps: float) -> Tensor:
    kernel = "rmsnorm"
    dev = x.device
    _check_tensor(x, kernel, "x", dev)
    dim = x.shape[-1]
    x3, heads, token_stride, head_stride = _rows3(x, kernel)
    w, gamma_kind = _gamma(weight, dim, kernel, dev)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    vector_ok = (x3.data_ptr() % 16 == 0 and token_stride % 8 == 0 and head_stride % 8 == 0
                 and (w is None or w.data_ptr() % 16 == 0))
    path, threads, rows = rms_norm_plan(dim, heads, vector_ok)
    lib, fn = _entry("rmsnorm", "fdm_rms_norm_bf16",
                     [_P, _P, _I, _P, _L, _I, _L, _L, _I, _F, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        code = fn(x3.data_ptr(), w.data_ptr() if w is not None else None, gamma_kind,
                  out.data_ptr(), x3.shape[0] * heads, heads, token_stride, head_stride, dim,
                  float(eps), path, threads, rows, _stream(dev))
    _check_launch(lib, "fdm_rms_norm", code, kernel)
    rms_norm_cuda.launches += 1
    return out


rms_norm_cuda.launches = 0


# ---------------------------------------------------------------- rotembd

# csrc/rope.cu's paths
ROPE_VECTOR, ROPE_TAIL = 0, 1
ROPE_THREADS = 256       # per block on the vector path at most (rope.cu kMaxThreads)
ROPE_TOKEN_THREADS = 64  # per token: column groups x head slots


def rope_plan(head_size: int, heads: int, is_neox: bool,
              vector_ok: bool) -> Tuple[int, int, int]:
    """(path, head slots, tokens per block) of csrc/rope.cu. heads: q's and
    k's together; vector_ok: rows, strides and tables 16-byte aligned. The
    vector path takes a head_size that is a multiple of 8 (interleaved) or 16
    (half-split): a thread owns one 16-byte column group (of each half) of
    every head_slots-th head of a token; a block covers whole tokens."""
    per = 16 if is_neox else 8
    groups = head_size // per
    if vector_ok and heads > 0 and head_size % per == 0 and groups <= ROPE_THREADS:
        slots = min(heads, max(1, ROPE_TOKEN_THREADS // groups))
        return ROPE_VECTOR, slots, max(1, ROPE_THREADS // (groups * slots))
    return ROPE_TAIL, 0, 0


@kernel_registry.register("rotembd", "cuda")
def rotary_pos_embedding_cuda(
    query: Tensor, key: Tensor, head_size: int, cos: Tensor, sin: Tensor,
    is_neox: bool = False,
) -> Tuple[Tensor, Tensor]:
    kernel = "rotembd"
    dev = query.device
    _check_tensor(query, kernel, "query", dev)
    _check_tensor(key, kernel, "key", dev)
    _require(query.dim() == 3 and key.dim() == 3, kernel, "query/key must be (B, S, H*D)")
    b, s, qd = query.shape
    _require(key.shape[:2] == (b, s), kernel,
             f"key {tuple(key.shape)} must share (B, S) with query {tuple(query.shape)}")
    _require(head_size % 2 == 0 and qd % head_size == 0 and key.shape[2] % head_size == 0,
             kernel, f"feature dims must be multiples of an even head_size {head_size}")
    half = head_size // 2
    cos = cos.to(device=dev, dtype=torch.float32).contiguous()
    sin = sin.to(device=dev, dtype=torch.float32).contiguous()
    _require(tuple(cos.shape) == (s, half) and tuple(sin.shape) == (s, half), kernel,
             f"cos/sin must be ({s}, {half})")
    strides = [_strides(t, (0, 1)) for t in (query, key)]
    for t, st in zip((query, key), strides):
        _require(t.data_ptr() % 4 == 0 and st[0] % 2 == 0 and st[1] % 2 == 0,
                 kernel, "query/key rows must be 4-byte aligned")
    qo = torch.empty(query.shape, dtype=query.dtype, device=dev)
    ko = torch.empty(key.shape, dtype=key.dtype, device=dev)
    hq, hkv = qd // head_size, key.shape[2] // head_size
    if b * s == 0 or hq + hkv == 0:
        return qo, ko
    vector_ok = (all(t.data_ptr() % 16 == 0 for t in (query, key, cos, sin))
                 and all(x % 8 == 0 for st in strides for x in st))
    path, slots, tokens = rope_plan(head_size, hq + hkv, is_neox, vector_ok)
    lib, fn = _entry("rope", "fdm_rope_bf16",
                     [_P] * 6 + [_I] * 5 + [_L] * 4 + [_I] * 4 + [_P])
    with torch.cuda.device(dev):
        code = fn(query.data_ptr(), key.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), b, s, hq, hkv, head_size, *strides[0],
                  *strides[1], int(is_neox), path, slots, tokens, _stream(dev))
    _check_launch(lib, "fdm_rope", code, kernel)
    rotary_pos_embedding_cuda.launches += 1
    return qo, ko


rotary_pos_embedding_cuda.launches = 0


# ---------------------------------------------------------- qk_norm_rope

def _qk_norm_rope_launch(wrapper, entry: str, lead_args, lead_types, q: Tensor, k: Tensor,
                         d: int, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor],
                         head_size: int, cos: Tensor, sin: Tensor, is_neox: bool,
                         eps: float) -> Tuple[Tensor, Tensor]:
    """The checks both forms share, then one launch of `entry` (q/k given by
    `lead_args`, their pointers and strides), counted on `wrapper`."""
    kernel = wrapper.__name__[:-len("_cuda")]
    dev = q.device
    for name, t in (("q", q), ("k", k)):
        _check_tensor(t, kernel, name, dev)
        _require(t.dim() == 3 and t.shape[:2] == q.shape[:2], kernel,
                 f"{name} must be (B, S, W) with q's (B, S), got {tuple(t.shape)}")
        _require(t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0,
                 kernel, f"{name} rows must be 4-byte aligned")
    b, s = q.shape[:2]
    _require(head_size % 2 == 0 and d % head_size == 0, kernel,
             f"width {d} must be a multiple of an even head_size {head_size}")
    half = head_size // 2
    cos = cos.to(device=dev, dtype=torch.float32).contiguous()
    sin = sin.to(device=dev, dtype=torch.float32).contiguous()
    _require(tuple(cos.shape) == (s, half) and tuple(sin.shape) == (s, half), kernel,
             f"cos/sin must be ({s}, {half})")
    _require((gamma_q is None) == (gamma_k is None), kernel, "gamma_q/gamma_k: both or neither")
    gq = gk = None
    gamma_kind = 0
    if gamma_q is not None:
        _require(gamma_q.numel() == d and gamma_k.numel() == d and gamma_q.device == dev
                 and gamma_k.device == dev, kernel, f"gamma_q/gamma_k must be ({d},) on {dev}")
        # the kernel reads bf16 or f32 weights as they are (bf16 -> f32 is exact)
        _require(gamma_q.dtype == gamma_k.dtype and gamma_q.dtype in _GAMMA_KINDS, kernel,
                 f"gamma_q/gamma_k must share a dtype in (bfloat16, float32), got "
                 f"{gamma_q.dtype}/{gamma_k.dtype}")
        gamma_kind = _GAMMA_KINDS[gamma_q.dtype]
        gq, gk = gamma_q.reshape(d).contiguous(), gamma_k.reshape(d).contiguous()
    qo = torch.empty(b, s, d, dtype=q.dtype, device=dev)
    ko = torch.empty(b, s, d, dtype=q.dtype, device=dev)
    if b * s == 0:
        return qo, ko
    lib, fn = _entry("qk_norm_rope", entry,
                     list(lead_types) + [_P, _P, _I] + [_P] * 4 + [_I] * 5 + [_F, _P])
    with torch.cuda.device(dev):
        code = fn(*lead_args, gq.data_ptr() if gq is not None else None,
                  gk.data_ptr() if gk is not None else None, gamma_kind, cos.data_ptr(),
                  sin.data_ptr(), qo.data_ptr(), ko.data_ptr(), b, s, d, head_size,
                  int(is_neox), float(eps), _stream(dev))
    _check_launch(lib, "fdm_qk_norm_rope", code, kernel)
    wrapper.launches += 1
    return qo, ko


@kernel_registry.register("qk_norm_rope", "cuda")
def qk_norm_rope_cuda(
    qk: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor], head_size: int,
    cos: Tensor, sin: Tensor, is_neox: bool = False, eps: float = 1e-6,
    inner_dim: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    _require(qk.dim() == 3, "qk_norm_rope", f"qk must be (B, S, W), got {tuple(qk.shape)}")
    d = qk.shape[-1] // 2 if inner_dim is None else inner_dim
    _require(0 < d and 2 * d <= qk.shape[-1] and d % 2 == 0, "qk_norm_rope",
             f"inner_dim {d} must be even and fit twice in a row of width {qk.shape[-1]}")
    # the kernel reads q = columns [0, d) and k = [d, 2d) of each strided row
    return _qk_norm_rope_launch(
        qk_norm_rope_cuda, "fdm_qk_norm_rope_bf16", (qk.data_ptr(), qk.stride(0), qk.stride(1)),
        (_P, _L, _L), qk, qk, d, gamma_q, gamma_k, head_size, cos, sin, is_neox, eps)


qk_norm_rope_cuda.launches = 0


@kernel_registry.register("qk_norm_rope2", "cuda")
def qk_norm_rope2_cuda(
    q: Tensor, k: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor],
    head_size: int, cos: Tensor, sin: Tensor, is_neox: bool = False, eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    _require(q.dim() == 3 and tuple(k.shape) == tuple(q.shape), "qk_norm_rope2",
             f"q and k must be (B, S, D) of one shape, got {tuple(q.shape)}/{tuple(k.shape)}")
    return _qk_norm_rope_launch(
        qk_norm_rope2_cuda, "fdm_qk_norm_rope2_bf16",
        (q.data_ptr(), k.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1)),
        (_P, _P, _L, _L, _L, _L), q, k, q.shape[2], gamma_q, gamma_k, head_size, cos, sin,
        is_neox, eps)


qk_norm_rope2_cuda.launches = 0


# ----------------------------------------------------------- gelu_and_mul


@kernel_registry.register("gelu_and_mul", "cuda")
def gelu_and_mul_cuda(x: Tensor) -> Tensor:
    kernel = "gelu_and_mul"
    contracts.check_gelu_and_mul("gelu_and_mul_cuda", x)
    dev = x.device
    _require(x.is_cuda, kernel, f"x must lie on a CUDA device, got {dev}")
    _require(x.stride(-1) == 1, kernel, "x must have a contiguous last dim")
    d2 = x.shape[-1]
    d = d2 // 2
    out = torch.empty(*x.shape[:-1], d, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    # a view whenever the leading dims collapse at one row stride (a column
    # slice of a wider tensor included); a copy otherwise
    x2 = x.reshape(-1, d2)
    _require(x2.shape[0] < 2**31, kernel, f"{x2.shape[0]} rows exceed the grid")
    lib, fn = _entry("gelu_mul", "fdm_gelu_and_mul", [_P, _P, _L, _L, _I, _I, _P])
    with torch.cuda.device(dev):
        code = fn(x2.data_ptr(), out.data_ptr(), x2.shape[0], x2.stride(0), d,
                  int(x.dtype == torch.float32), _stream(dev))
    _check_launch(lib, "fdm_gelu_and_mul", code, kernel)
    gelu_and_mul_cuda.launches += 1
    return out


gelu_and_mul_cuda.launches = 0


# ------------------------------------------------------------------- sdpa


def _check_attention(kernel: str, query: Tensor, key: Tensor, value: Tensor, head_dim: int,
                     tables: dict, tiles: dict) -> None:
    """The checks every attention kernel shares. tables: {name: tensor} of
    the table operands; tiles: {name: size} of the tile sizes that must be
    multiples of 64."""
    dev = query.device
    for name, t in (("query", query), ("key", key), ("value", value)):
        _check_tensor(t, kernel, name, dev)
        _require(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0,
                 kernel, f"{name} must be 16-byte aligned with strides multiple of 8")
    for name, t in tables.items():
        _require(t.device == dev and t.is_contiguous(), kernel,
                 f"{name} must be a contiguous int32 tensor on {dev}")
    _require(head_dim in (64, 128), kernel, f"head_dim {head_dim} not in (64, 128)")
    _require(all(v >= 64 and v % 64 == 0 for v in tiles.values()), kernel,
             " and ".join(f"{k} {v}" for k, v in tiles.items()) + " must be multiples of 64")


def _flash_attention(wrapper, kernel: str, entry: str, table_args, table_types, query: Tensor,
                     key: Tensor, value: Tensor, num_q_heads: int, num_kv_heads: int,
                     head_dim: int, scale: Optional[float], causal: bool,
                     rows: Tuple[int, int]) -> Tensor:
    """One launch of the wgmma + TMA attention kernel (csrc/flash_attn.cu) in
    the walk of `entry`, with the table arguments first, counted on `wrapper`.
    rows: (query rows, K / V rows) of the tensor-map boxes."""
    dev = query.device
    b, sq, _ = query.shape
    if scale is None:
        scale = head_dim**-0.5
    out = torch.empty(query.shape, dtype=query.dtype, device=dev)
    if b * sq == 0:
        return out
    geom = [x for t, r in ((query, rows[0]), (key, rows[1]), (value, rows[1]))
            for x in tma.attention_geometry(t, head_dim, r).packed()]
    lib, fn = _entry("flash_attn", entry,
                     list(table_types) + [_P] * 4 + [_LP] + [_I] * 6 + [_L] * 2 + [_F, _I, _P])
    with torch.cuda.device(dev):
        code = fn(*table_args, query.data_ptr(), key.data_ptr(), value.data_ptr(),
                  out.data_ptr(), (ctypes.c_longlong * len(geom))(*geom), b, sq, key.shape[1],
                  num_q_heads, num_kv_heads, head_dim, out.stride(0), out.stride(1),
                  float(scale * _LOG2E), int(causal), _stream(dev))
    _check_launch(lib, "fdm_flash_attn", code, kernel)
    wrapper.launches += 1
    return out


def _kernel_head_dim(head_dim: int) -> int:
    """The head dim the dense kernel runs for head_dim: 64 or 128 as they
    are, a smaller one zero-padded to the next of them (zero columns leave
    every logit as it is and give zero output columns, cut off after)."""
    return head_dim if head_dim in (64, 128) or head_dim > 128 else (
        64 if head_dim < 64 else 128)


def _pad_heads(t: Tensor, heads: int, head_dim: int, to: int) -> Tensor:
    b, s, _ = t.shape
    return F.pad(t.reshape(b, s, heads, head_dim), (0, to - head_dim)).reshape(b, s, heads * to)


def _padded_attention(fn, query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
                      num_kv_heads: int, head_dim: int, scale: Optional[float]):
    """fn(query, key, value, head_dim, scale) of the dense kernel, at a head
    dim it does not take run on zero-padded heads (the padded rows' and
    outputs' copies) with head_dim's own scale. -> (out, the rest of fn's
    results)."""
    kd = _kernel_head_dim(head_dim)
    if kd == head_dim:
        res = fn(query, key, value, head_dim, scale)
        return res if isinstance(res, tuple) else (res,)
    scale = head_dim**-0.5 if scale is None else scale
    res = fn(_pad_heads(query, num_q_heads, head_dim, kd),
             _pad_heads(key, num_kv_heads, head_dim, kd),
             _pad_heads(value, num_kv_heads, head_dim, kd), kd, scale)
    res = res if isinstance(res, tuple) else (res,)
    b, sq, _ = query.shape
    out = res[0].reshape(b, sq, num_q_heads, kd)[..., :head_dim].reshape(b, sq, -1)
    return (out.contiguous(), *res[1:])


@kernel_registry.register("sdpa", "cuda")
def sdpa_cuda(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, is_causal: bool = False,
    scale: Optional[float] = None,
) -> Tensor:
    """Dense attention on the kernel; a head dim under 128 other than 64 runs
    zero-padded to 64 or 128."""
    contracts.check_sdpa("sdpa_cuda", query, key, value, num_q_heads, num_kv_heads, head_dim)

    def run(q, k, v, d, sc):
        _check_attention("sdpa", q, k, v, d, {}, {})
        return _flash_attention(sdpa_cuda, "sdpa", "fdm_flash_attn_fwd", (), [], q, k, v,
                                num_q_heads, num_kv_heads, d, sc, is_causal,
                                (tma.ATTN_ROWS, tma.ATTN_ROWS))

    return _padded_attention(run, query, key, value, num_q_heads, num_kv_heads, head_dim,
                             scale)[0]


sdpa_cuda.launches = 0


@kernel_registry.register("sdpa_lse", "cuda")
def sdpa_lse_cuda(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """Dense non-causal sdpa that also returns each query row's log-sum-exp,
    f32 (B, hq, sq) (-inf for a row that saw no key): the block of one K/V
    shard in the ring attention (parallel/context_parallel.py). Head dims as
    sdpa_cuda's."""
    contracts.check_sdpa("sdpa_lse_cuda", query, key, value, num_q_heads, num_kv_heads,
                         head_dim)
    b, sq, _ = query.shape

    def run(q, k, v, d, sc):
        _check_attention("sdpa_lse", q, k, v, d, {}, {})
        lse = torch.empty((b, num_q_heads, sq), dtype=torch.float32, device=q.device)
        out = _flash_attention(sdpa_lse_cuda, "sdpa_lse", "fdm_flash_attn_lse_fwd",
                               (lse.data_ptr(),), [_P], q, k, v, num_q_heads, num_kv_heads, d,
                               sc, False, (tma.ATTN_ROWS, tma.ATTN_ROWS))
        return out, lse

    return _padded_attention(run, query, key, value, num_q_heads, num_kv_heads, head_dim, scale)


sdpa_lse_cuda.launches = 0


# --------------------------------------------------------- sparse attention
#
# The mask, coarse, superblock and fine walks run on the wgmma + TMA attention
# kernel (csrc/flash_attn.cu). The wrappers check shapes, dtypes and devices;
# the table VALUES are not read (that would sync the card): the kernel clamps
# its table reads, and the engine checks its tables once on the host
# (contracts, strict=True).

@kernel_registry.register("sdpa_gather_super", "cuda")
def gather_super_attention_cuda(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_valbits: Tensor,
    block_rows: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int,
    scale: Optional[float] = None, block_q: int = 512, group: int = 8, fine: int = 64,
    superblock: int = 4,
) -> Tensor:
    kernel = "gather_super"
    contracts.check_sdpa("gather_super_attention_cuda", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    contracts.check_gather_super("gather_super_attention_cuda", block_indices, block_valbits,
                                 block_rows, query.shape[1], key.shape[1], block_q, group, fine,
                                 superblock)
    _require(1 <= superblock <= 30, kernel, f"superblock {superblock} not in [1, 30]")
    _check_attention(kernel, query, key, value, head_dim,
                     {"block_indices": block_indices, "block_valbits": block_valbits,
                      "block_rows": block_rows}, {"block_q": block_q, "fine": fine})
    return _flash_attention(
        gather_super_attention_cuda, kernel, "fdm_flash_attn_super_fwd",
        (block_indices.data_ptr(), block_valbits.data_ptr(), block_rows.data_ptr(),
         block_indices.shape[0], block_q, fine, superblock), [_P] * 3 + [_I] * 4, query, key,
        value, num_q_heads, num_kv_heads, head_dim, scale, False, tma.walk_rows(block_q))


gather_super_attention_cuda.launches = 0


@kernel_registry.register("sdpa_gather_fine", "cuda")
def gather_fine_attention_cuda(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_valid: Tensor,
    block_rows: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int,
    scale: Optional[float] = None, block_q: int = 512, group: int = 8, fine: int = 64,
) -> Tensor:
    contracts.check_sdpa("gather_fine_attention_cuda", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    contracts.check_gather_fine("gather_fine_attention_cuda", block_indices, block_valid,
                                block_rows, query.shape[1], key.shape[1], block_q, group, fine)
    kernel = "gather_fine"
    _check_attention(kernel, query, key, value, head_dim,
                     {"block_indices": block_indices, "block_valid": block_valid,
                      "block_rows": block_rows}, {"block_q": block_q, "fine": fine})
    return _flash_attention(
        gather_fine_attention_cuda, kernel, "fdm_flash_attn_fine_fwd",
        (block_indices.data_ptr(), block_valid.data_ptr(), block_rows.data_ptr(),
         block_indices.shape[0], block_q, fine), [_P] * 3 + [_I] * 3, query, key, value,
        num_q_heads, num_kv_heads, head_dim, scale, False, tma.walk_rows(block_q))


gather_fine_attention_cuda.launches = 0


@kernel_registry.register("sdpa_gather", "cuda")
def gather_sparse_attention_cuda(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_counts: Tensor,
    num_q_heads: int, num_kv_heads: int, head_dim: int, scale: Optional[float] = None,
    block_q: int = 512, block_k: int = 1024,
) -> Tensor:
    contracts.check_sdpa("gather_sparse_attention_cuda", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    contracts.check_gather_lists("gather_sparse_attention_cuda", block_indices, block_counts,
                                 query.shape[1], key.shape[1], block_q, block_k)
    kernel = "gather_coarse"
    _check_attention(kernel, query, key, value, head_dim,
                     {"block_indices": block_indices, "block_counts": block_counts},
                     {"block_q": block_q, "block_k": block_k})
    nq, max_nb = block_indices.shape
    return _flash_attention(
        gather_sparse_attention_cuda, kernel, "fdm_flash_attn_coarse_fwd",
        (block_indices.data_ptr(), block_counts.data_ptr(), nq, max_nb, block_q, block_k),
        [_P] * 2 + [_I] * 4, query, key, value, num_q_heads, num_kv_heads, head_dim, scale,
        False, tma.walk_rows(block_q))


gather_sparse_attention_cuda.launches = 0


# the most entries a mask row may hold (flash_attn.cu: 32 * MaskTables::kRowWords)
MASK_ROW_ENTRIES = 4096


@kernel_registry.register("sdpa_sparse", "cuda")
def sparse_attention_cuda(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int, num_kv_heads: int,
    head_dim: int, is_causal: bool = False, scale: Optional[float] = None,
    sparse_mask: Optional[Tensor] = None, block_q: int = 128, block_k: int = 128,
) -> Tensor:
    """Without a mask the op is dense attention: the sdpa kernel."""
    if sparse_mask is None:
        return sdpa_cuda(query, key, value, num_q_heads, num_kv_heads, head_dim, is_causal,
                         scale)
    kernel = "sparse_mask"
    _require(not is_causal, kernel, "the block-sparse kernel is non-causal (radial video "
                                    "attention), as the Pallas kernel it replaces")
    contracts.check_sdpa("sparse_attention_cuda", query, key, value, num_q_heads, num_kv_heads,
                         head_dim)
    contracts.check_sparse_mask("sparse_attention_cuda", sparse_mask, query.shape[0],
                                num_q_heads, query.shape[1], key.shape[1], block_q, block_k)
    _require(sparse_mask.dtype == torch.int32, kernel,
             f"sparse_mask must be int32, got {sparse_mask.dtype}")
    ni, nj = sparse_mask.shape[2:]
    _require(nj <= MASK_ROW_ENTRIES, kernel,
             f"a mask row of {nj} entries exceeds the kernel's {MASK_ROW_ENTRIES} "
             f"(ceil(skv / block_k)): take a larger block_k")
    _check_attention(kernel, query, key, value, head_dim, {"sparse_mask": sparse_mask},
                     {"block_q": block_q, "block_k": block_k})
    return _flash_attention(
        sparse_attention_cuda, kernel, "fdm_flash_attn_mask_fwd",
        (sparse_mask.data_ptr(), ni, nj, block_q, block_k), [_P] + [_I] * 4, query, key, value,
        num_q_heads, num_kv_heads, head_dim, scale, False, tma.walk_rows(block_q))


sparse_attention_cuda.launches = 0


# -------------------------------------------------------------- quantize

def _check_rows(x: Tensor, kernel: str) -> Tuple[int, int]:
    """The quantizers' checks on a 2D bf16 x -> (M, K)."""
    dev = x.device
    _check_tensor(x, kernel, "x", dev)
    _require(x.dim() == 2, kernel, f"x must be 2D (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    _require(k > 0 and k % 8 == 0, kernel, f"K = {k} must be a positive multiple of 8")
    _require(x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0, kernel,
             "x rows must be 16-byte aligned")
    return m, k


_QUANT_MODES = {"int8_sym": 0, "int8_asym": 1, "fp8": 2, "int4": 3}


def _quantize_rows(x: Tensor, kernel: str, mode: str,
                   wrapper) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Launch the per-row quantizer on a 2D bf16 x: (q, scale (M,1), zp (M,1) | None);
    counts the launch on `wrapper`."""
    dev = x.device
    m, k = _check_rows(x, kernel)
    q = torch.empty(m, k, dtype=torch.float8_e4m3fn if mode == "fp8" else torch.int8, device=dev)
    scale = torch.empty(m, 1, dtype=torch.float32, device=dev)
    zp = torch.empty(m, 1, dtype=torch.int32, device=dev) if mode == "int8_asym" else None
    if m == 0:
        return q, scale, zp
    lib, fn = _entry("quant", "fdm_quantize_rows", [_P, _L, _L, _I, _P, _P, _P, _I, _P])
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), x.stride(0), m, k, q.data_ptr(), scale.data_ptr(),
                  zp.data_ptr() if zp is not None else None, _QUANT_MODES[mode], _stream(dev))
    _check_launch(lib, "fdm_quantize", code, kernel)
    wrapper.launches += 1
    return q, scale, zp


@kernel_registry.register("quantize_to_int8", "cuda")
def quantize_to_int8_cuda(x: Tensor, symmetric: bool = True
                          ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    return _quantize_rows(x, "quantize_to_int8", "int8_sym" if symmetric else "int8_asym",
                          quantize_to_int8_cuda)


quantize_to_int8_cuda.launches = 0


@kernel_registry.register("quantize_to_fp8", "cuda")
def quantize_to_fp8_cuda(x: Tensor) -> Tuple[Tensor, Tensor]:
    q, scale, _ = _quantize_rows(x, "quantize_to_fp8", "fp8", quantize_to_fp8_cuda)
    return q, scale


quantize_to_fp8_cuda.launches = 0


@kernel_registry.register("quantize_to_int4", "cuda")
def quantize_to_int4_cuda(x: Tensor) -> Tuple[Tensor, Tensor]:
    q, scale, _ = _quantize_rows(x, "quantize_to_int4", "int4", quantize_to_int4_cuda)
    return q, scale


quantize_to_int4_cuda.launches = 0


# ------------------------------------------------------------- W8A8 GEMM


def _check_vector(t: Optional[Tensor], kernel: str, name: str, n: int, dtype,
                  device: torch.device) -> None:
    if t is None:
        return
    _require(t.device == device and t.dtype == dtype and t.numel() == n and t.is_contiguous(),
             kernel, f"{name} must be a contiguous {dtype} tensor of {n} elements on {device}, "
                     f"got {t.dtype} {tuple(t.shape)}")


def _w8a8_entry(op_dtype: torch.dtype, int4: bool = False, f32: bool = False):
    """(library, C launcher) of the GEMM for 8-bit operands of op_dtype:
    fp8_gemm.cu for e4m3, w8a8_gemm.cu (which also takes the zero point) for
    int8, and its zero-point-free W4A4 entry for int4 values in int8 carriers;
    all wgmma + TMA kernels. f32: the entry of the f32 partial, which takes
    no bias."""
    tail = [_I] * 3 + [_L] * 2 + [_P]
    nb = 0 if f32 else 1  # the bias pointer
    suffix = "_f32" if f32 else ""
    if op_dtype == torch.float8_e4m3fn:
        return _entry("fp8_gemm", "fdm_fp8_gemm" + suffix, [_P] * (5 + nb) + tail)
    if int4:
        return _entry("w8a8_gemm", "fdm_w4a4_gemm" + suffix, [_P] * (5 + nb) + tail)
    return _entry("w8a8_gemm", "fdm_w8a8_gemm" + suffix, [_P] * (7 + nb) + tail)


def _w8a8_gemm(kernel: str, wrapper, a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor,
               out_dtype, azp_adj: Optional[Tensor], azp: Optional[Tensor],
               bias: Optional[Tensor], fp8: bool, int4: bool = False,
               partial: bool = False) -> Tensor:
    """Checks, then one launch of the W8A8 (or W4A4: int4=True, no zero
    point) GEMM, counted on `wrapper`. partial: a row-parallel rank's f32
    partial (the *_matmul_partial ops), no bias."""
    contracts.check_scaled_mm(kernel, a, b, scale_a, scale_b, azp_adj=azp_adj, azp=azp,
                              bias=bias, int8=not fp8)
    dev = a.device
    op_dtype = torch.float8_e4m3fn if fp8 else torch.int8
    m, k = a.shape
    n = b.shape[1]
    _require(a.is_cuda and b.device == dev, kernel, "a and b must lie on one CUDA device")
    _require(a.dtype == op_dtype and b.dtype == op_dtype, kernel,
             f"a/b must be {op_dtype}, got {a.dtype}/{b.dtype}")
    if partial:
        _require(out_dtype == torch.float32 and bias is None, kernel,
                 f"a partial is float32 without a bias, got {out_dtype}")
    else:
        _require(out_dtype == torch.bfloat16, kernel,
                 f"out_dtype must be bfloat16, got {out_dtype}")
    _require(k > 0 and k % 16 == 0, kernel, f"K = {k} must be a positive multiple of 16")
    _require(a.stride(1) == 1 and a.stride(0) % 16 == 0 and a.data_ptr() % 16 == 0, kernel,
             "a must be K-contiguous with 16-byte aligned rows")
    _require(b.stride(0) == 1 and b.stride(1) % 16 == 0 and b.data_ptr() % 16 == 0, kernel,
             "b (K, N) must be a view of a K-contiguous (N, K) buffer (stride(0) == 1) with "
             "16-byte aligned columns; a (K, N) N-contiguous weight is not taken")
    _check_vector(scale_a, kernel, "scale_a", m, torch.float32, dev)
    _check_vector(scale_b, kernel, "scale_b", n, torch.float32, dev)
    _check_vector(azp, kernel, "azp", m, torch.int32, dev)
    if azp is not None:
        _check_vector(azp_adj, kernel, "azp_adj", n, torch.int32, dev)
    _check_vector(bias, kernel, "bias", n, torch.bfloat16, dev)
    f32 = out_dtype == torch.float32
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    lib, fn = _w8a8_entry(op_dtype, int4, f32)
    zero_point = () if fp8 or int4 else (azp.data_ptr() if azp is not None else None,
                                         azp_adj.data_ptr() if azp is not None else None)
    bias_arg = () if f32 else (bias.data_ptr() if bias is not None else None,)
    with torch.cuda.device(dev):
        code = fn(a.data_ptr(), b.data_ptr(), scale_a.data_ptr(), scale_b.data_ptr(), *zero_point,
                  *bias_arg, out.data_ptr(), m, n, k, a.stride(0), b.stride(1), _stream(dev))
    _check_launch(lib, "fdm_fp8_gemm" if fp8 else "fdm_w8a8_gemm", code, kernel)
    wrapper.launches += 1
    return out


@kernel_registry.register("int8_matmul", "cuda")
def int8_matmul_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                     azp_adj: Tensor, azp: Optional[Tensor], bias: Optional[Tensor] = None
                     ) -> Tensor:
    return _w8a8_gemm("int8_matmul", int8_matmul_cuda, a, b, scale_a, scale_b, out_dtype,
                      azp_adj, azp, bias, fp8=False)


int8_matmul_cuda.launches = 0


@kernel_registry.register("fp8_matmul", "cuda")
def fp8_matmul_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                    bias: Optional[Tensor] = None) -> Tensor:
    return _w8a8_gemm("fp8_matmul", fp8_matmul_cuda, a, b, scale_a, scale_b, out_dtype,
                      None, None, bias, fp8=True)


fp8_matmul_cuda.launches = 0


@kernel_registry.register("int4_matmul", "cuda")
def int4_matmul_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                     bias: Optional[Tensor] = None) -> Tensor:
    """The W4A4 GEMM: int4-range values in int8 carriers on the int8 kernel's
    s8 wgmma ring, without the zero point (csrc/w8a8_gemm.cu fdm_w4a4_gemm)."""
    return _w8a8_gemm("int4_matmul", int4_matmul_cuda, a, b, scale_a, scale_b, out_dtype,
                      None, None, bias, fp8=False, int4=True)


int4_matmul_cuda.launches = 0


# ------------------------------------------------------------ int4 unpack


@kernel_registry.register("unpack_int4", "cuda")
def unpack_int4_cuda(p: Tensor) -> Tensor:
    """(K/2, N) packed nibbles, the view of a contiguous (N, K/2) buffer (a
    QLinear's w4p, or rows of it) -> the (K, N) view of a fresh (N, K) int8
    buffer (csrc/int4_pack.cu), the K-contiguous B operand the W4A4 GEMM reads."""
    kernel = "unpack_int4"
    dev = p.device
    _require(p.is_cuda, kernel, f"p must lie on a CUDA device, got {dev}")
    _require(p.dtype == torch.int8, kernel, f"p must be int8, got {p.dtype}")
    _require(p.dim() == 2, kernel, f"p must be 2D (K/2, N), got {tuple(p.shape)}")
    half, n = p.shape
    _require((n <= 1 or p.stride(1) == half) and (half <= 1 or p.stride(0) == 1), kernel,
             "p (K/2, N) must be a view of a contiguous (N, K/2) buffer (stride(0) == 1, "
             f"row pitch K/2); got strides {p.stride()}")
    out = torch.empty(n, 2 * half, dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out.t()
    lib, fn = _entry("int4_pack", "fdm_unpack_int4", [_P, _P, _L, _L, _P])
    with torch.cuda.device(dev):
        code = fn(p.data_ptr(), out.data_ptr(), n, half, _stream(dev))
    _check_launch(lib, "fdm_unpack_int4", code, kernel)
    unpack_int4_cuda.launches += 1
    return out.t()


unpack_int4_cuda.launches = 0


# ------------------------------------------------------------- W4A4 linear
#
# csrc/w4a4_gemm.cu: the int4 GEMM, its dequantization epilogue and the
# SVDQuant low-rank branch of an int4 / int4p QLinear in one launch, by two
# entries: the large-M wgmma + TMA kernel on int8 carriers (int4p unpacks
# first), and the small-M split-K kernel that reads the packed weights.

# The rows at most for which a packed (int4p) weight takes the small-M entry.
# Chosen from the grid of `python3 chip_smoke.py --w4a4-grid` on an NVIDIA
# H100 80GB HBM3 (700 W), which fails unless this constant agrees with it:
# both entries at M = 1, 16, 30, 60, 64, 96, 128 and 512 on FLUX's and
# Qwen-Image's seven (K, N), K 3072 / 12288 / 15360, N 3072 .. 21504 (PERF.md).
# Summed over the (K, N), the small-M entry, bound by the packed weight's
# bytes, takes 0.0822 ms against unpack_int4 + the large-M entry's 0.3821 at
# one row, 0.2970 against 0.3563 at 64, and 0.4636 against 0.3570 at 96.
W4A4_SMALL_M_MAX = 64


def w4a4_small_m(m: int, k: int) -> bool:
    """Whether w4a4_linear runs an int4p weight of K = k on the small-M
    entry at m rows (K a multiple of 32: its 16-byte packed loads)."""
    return m <= W4A4_SMALL_M_MAX and k % 32 == 0


def _check_w4a4(kernel: str, a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                bias: Optional[Tensor], xu: Tensor, lora_v: Tensor) -> Tuple[int, int, int, int]:
    """The checks both entries share -> (M, K, N, rank)."""
    contracts.check_w4a4_linear(kernel, a, b, scale_a, scale_b, bias, xu, lora_v)
    dev = a.device
    m, k = a.shape
    n, rank = b.shape[1], xu.shape[1]
    _require(a.is_cuda and all(t.device == dev for t in (b, xu, lora_v)), kernel,
             "a, b, xu and lora_v must lie on one CUDA device")
    _require(out_dtype == torch.bfloat16, kernel, f"out_dtype must be bfloat16, got {out_dtype}")
    _require(xu.dtype == torch.bfloat16 and lora_v.dtype == torch.bfloat16, kernel,
             f"xu / lora_v must be bfloat16, got {xu.dtype} / {lora_v.dtype}")
    _require(rank <= 32, kernel, f"the low-rank branch's rank {rank} must be at most 32")
    _require(k > 0 and k % 16 == 0, kernel, f"K = {k} must be a positive multiple of 16")
    _require(a.stride(1) == 1 and a.stride(0) % 16 == 0 and a.data_ptr() % 16 == 0, kernel,
             "a must be K-contiguous with 16-byte aligned rows")
    _check_vector(scale_a, kernel, "scale_a", m, torch.float32, dev)
    _check_vector(scale_b, kernel, "scale_b", n, torch.float32, dev)
    _check_vector(bias, kernel, "bias", n, torch.bfloat16, dev)
    return m, k, n, rank


def _rows(t: Tensor, align: int) -> Tensor:
    """t (2D) with a contiguous last dim, an even row pitch and `align`-byte
    aligned rows: t itself, or a contiguous copy."""
    ok = (t.stride(1) == 1 and (t.shape[0] <= 1 or t.stride(0) % (align // 2) == 0)
          and t.data_ptr() % align == 0)
    return t if ok else t.contiguous()


def w4a4_linear_large_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                           bias: Optional[Tensor], xu: Tensor, lora_v: Tensor) -> Tensor:
    """The large-M entry (csrc/w4a4_gemm.cu fdm_w4a4_linear): b (K, N) int4
    values in int8 carriers, the view of a K-contiguous (N, K) buffer."""
    kernel = "w4a4_linear"
    m, k, n, rank = _check_w4a4(kernel, a, b, scale_a, scale_b, out_dtype, bias, xu, lora_v)
    _require(b.shape[0] == k, kernel, f"b must be (K, N) = ({k}, {n}), got {tuple(b.shape)}")
    _require(b.stride(0) == 1 and b.stride(1) % 16 == 0 and b.data_ptr() % 16 == 0, kernel,
             "b (K, N) must be a view of a K-contiguous (N, K) buffer (stride(0) == 1) with "
             "16-byte aligned columns")
    _require(rank >= 1 and rank % 2 == 0, kernel, f"the rank {rank} must be even and positive")
    dev = a.device
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return out
    xu = _rows(xu, 4)
    if not (lora_v.stride(1) == 1 and lora_v.stride(0) % 8 == 0 and lora_v.data_ptr() % 16 == 0):
        # the TMA reads lora_v in 16-byte rows: pad its columns to a multiple of 8
        padded = torch.zeros(rank, -(-n // 8) * 8, dtype=torch.bfloat16, device=dev)
        padded[:, :n] = lora_v
        lora_v = padded
    lib, fn = _entry("w4a4_gemm", "fdm_w4a4_linear", [_P] * 8 + [_I] * 3 + [_L] * 4 + [_I, _P])
    with torch.cuda.device(dev):
        code = fn(a.data_ptr(), b.data_ptr(), scale_a.data_ptr(), scale_b.data_ptr(),
                  bias.data_ptr() if bias is not None else None, xu.data_ptr(),
                  lora_v.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(1),
                  xu.stride(0), lora_v.stride(0), rank, _stream(dev))
    _check_launch(lib, "fdm_w4a4_linear", code, kernel)
    w4a4_linear_large_cuda.launches += 1
    return out


w4a4_linear_large_cuda.launches = 0


def w4a4_linear_small_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                           bias: Optional[Tensor], xu: Tensor, lora_v: Tensor,
                           split: int = 0) -> Tensor:
    """The small-M entry (csrc/w4a4_gemm.cu fdm_w4a4_linear_small): b (K/2,
    N) packed pairs, the view of a contiguous (N, K/2) buffer (a QLinear's
    w4p, or rows of it), read as it is stored. `split`: K shares a cluster
    (2, 4 or 8), or 0 for the kernel's own choice by shape."""
    kernel = "w4a4_linear_small"
    _require(split in (0, 2, 4, 8), kernel, f"split must be 0, 2, 4 or 8, got {split}")
    m, k, n, rank = _check_w4a4(kernel, a, b, scale_a, scale_b, out_dtype, bias, xu, lora_v)
    _require(2 * b.shape[0] == k and k % 32 == 0, kernel,
             f"b must be (K/2, N) packed pairs with K a multiple of 32, got {tuple(b.shape)} "
             f"for K = {k}")
    _require((b.shape[1] <= 1 or b.stride(1) % 16 == 0) and b.stride(0) == 1
             and b.data_ptr() % 16 == 0, kernel,
             "b (K/2, N) must be a view of an (N, K/2) buffer (stride(0) == 1) with 16-byte "
             f"aligned rows; got strides {b.stride()}")
    dev = a.device
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return out
    xu, lora_v = _rows(xu, 2), _rows(lora_v, 2)
    lib, fn = _entry("w4a4_gemm", "fdm_w4a4_linear_small",
                     [_P] * 8 + [_I] * 3 + [_L] * 4 + [_I, _I, _P])
    with torch.cuda.device(dev):
        code = fn(b.data_ptr(), a.data_ptr(), scale_a.data_ptr(), scale_b.data_ptr(),
                  bias.data_ptr() if bias is not None else None, xu.data_ptr(),
                  lora_v.data_ptr(), out.data_ptr(), m, n, k, a.stride(0),
                  b.stride(1) if n > 1 else k // 2, xu.stride(0), lora_v.stride(0), rank,
                  split, _stream(dev))
    _check_launch(lib, "fdm_w4a4_linear", code, kernel)
    w4a4_linear_small_cuda.launches += 1
    return out


w4a4_linear_small_cuda.launches = 0


@kernel_registry.register("w4a4_linear", "cuda")
def w4a4_linear_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                     bias: Optional[Tensor], xu: Tensor, lora_v: Tensor) -> Tensor:
    """The W4A4 linear on its two kernels: a packed weight (K/2, N) at M <=
    W4A4_SMALL_M_MAX rows on the small-M entry, which reads it as stored;
    otherwise unpack_int4 (for a packed weight) and the large-M entry."""
    m, k = a.shape
    if contracts.check_w4a4_linear("w4a4_linear", a, b, scale_a, scale_b, bias, xu, lora_v):
        if w4a4_small_m(m, k):
            return w4a4_linear_small_cuda(a, b, scale_a, scale_b, out_dtype, bias, xu, lora_v)
        b = unpack_int4_cuda(b)
    return w4a4_linear_large_cuda(a, b, scale_a, scale_b, out_dtype, bias, xu, lora_v)


# ------------------------------------------------------ tensor parallelism
#
# The row-parallel and across-heads variants (parallel/tensor_parallel.py):
# new modes of the quantizer (csrc/quant.cu), the GEMMs' f32 epilogue
# (csrc/w8a8_gemm.cu, csrc/fp8_gemm.cu) and the norms (csrc/rmsnorm.cu,
# csrc/qk_norm_rope.cu), each wrapper counting its own launches.


@kernel_registry.register("rms_sumsq", "cuda")
def rms_sumsq_cuda(x: Tensor) -> Tensor:
    kernel = "rms_sumsq"
    dev = x.device
    _check_tensor(x, kernel, "x", dev)
    x3, heads, ts, hs = _rows3(x, kernel)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib, fn = _entry("rmsnorm", "fdm_rms_sumsq_bf16", [_P, _L, _I, _L, _L, _I, _P, _P])
    with torch.cuda.device(dev):
        code = fn(x3.data_ptr(), x3.shape[0] * heads, heads, ts, hs, x.shape[-1],
                  out.data_ptr(), _stream(dev))
    _check_launch(lib, "fdm_rms_norm", code, kernel)
    rms_sumsq_cuda.launches += 1
    return out


rms_sumsq_cuda.launches = 0


def _check_sumsq(sumsq: Tensor, shape, kernel: str, dev) -> Tensor:
    _require(sumsq.device == dev and sumsq.dtype == torch.float32
             and tuple(sumsq.shape) == tuple(shape), kernel,
             f"sumsq must be float32 {tuple(shape)} on {dev}, got {sumsq.dtype} "
             f"{tuple(sumsq.shape)}")
    return sumsq.contiguous()


@kernel_registry.register("rmsnorm_given", "cuda")
def rms_norm_given_cuda(x: Tensor, weight: Optional[Tensor], sumsq: Tensor, n_total: int,
                        eps: float) -> Tensor:
    kernel = "rmsnorm_given"
    dev = x.device
    _check_tensor(x, kernel, "x", dev)
    dim = x.shape[-1]
    _require(n_total >= dim, kernel, f"n_total {n_total} < the rows' width {dim}")
    x3, heads, ts, hs = _rows3(x, kernel)
    ss = _check_sumsq(sumsq, x.shape[:-1], kernel, dev)
    w, gamma_kind = _gamma(weight, dim, kernel, dev)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib, fn = _entry("rmsnorm", "fdm_rms_norm_given_bf16",
                     [_P, _P, _I, _P, _F, _P, _L, _I, _L, _L, _I, _F, _P])
    with torch.cuda.device(dev):
        code = fn(x3.data_ptr(), w.data_ptr() if w is not None else None, gamma_kind,
                  ss.data_ptr(), float(n_total), out.data_ptr(), x3.shape[0] * heads, heads, ts,
                  hs, dim, float(eps), _stream(dev))
    _check_launch(lib, "fdm_rms_norm", code, kernel)
    rms_norm_given_cuda.launches += 1
    return out


rms_norm_given_cuda.launches = 0


def _qk_given_launch(wrapper, q: Tensor, k: Tensor, strides, d: int, gamma_q, gamma_k,
                     head_size: int, cos: Tensor, sin: Tensor, sumsq: Tensor, n_total: int,
                     is_neox: bool, eps: float) -> Tuple[Tensor, Tensor]:
    kernel = wrapper.__name__[:-len("_cuda")]
    dev = q.device
    for name, t in (("q", q), ("k", k)):
        _check_tensor(t, kernel, name, dev)
        _require(t.dim() == 3 and t.shape[:2] == q.shape[:2], kernel,
                 f"{name} must be (B, S, W) with q's (B, S), got {tuple(t.shape)}")
        _require(t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0,
                 kernel, f"{name} rows must be 4-byte aligned")
    b, s = q.shape[:2]
    _require(head_size % 2 == 0 and d % head_size == 0, kernel,
             f"width {d} must be a multiple of an even head_size {head_size}")
    _require(n_total >= d, kernel, f"n_total {n_total} < the rows' width {d}")
    half = head_size // 2
    cos = cos.to(device=dev, dtype=torch.float32).contiguous()
    sin = sin.to(device=dev, dtype=torch.float32).contiguous()
    _require(tuple(cos.shape) == (s, half) and tuple(sin.shape) == (s, half), kernel,
             f"cos/sin must be ({s}, {half})")
    _require((gamma_q is None) == (gamma_k is None), kernel, "gamma_q/gamma_k: both or neither")
    gq, kind_q = _gamma(gamma_q, d, kernel, dev)
    gk, kind_k = _gamma(gamma_k, d, kernel, dev)
    _require(kind_q == kind_k, kernel, "gamma_q/gamma_k must share a dtype")
    ss = _check_sumsq(sumsq, (b, s, 2), kernel, dev)
    qo = torch.empty(b, s, d, dtype=q.dtype, device=dev)
    ko = torch.empty(b, s, d, dtype=q.dtype, device=dev)
    if b * s == 0:
        return qo, ko
    lib, fn = _entry("qk_norm_rope", "fdm_qk_norm_rope_given_bf16",
                     [_P, _P, _L, _L, _L, _L, _P, _P, _I, _P, _P, _P, _F, _P, _P]
                     + [_I] * 5 + [_F, _P])
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), k.data_ptr(), *strides,
                  gq.data_ptr() if gq is not None else None,
                  gk.data_ptr() if gk is not None else None, kind_q, cos.data_ptr(),
                  sin.data_ptr(), ss.data_ptr(), float(n_total), qo.data_ptr(), ko.data_ptr(),
                  b, s, d, head_size, int(is_neox), float(eps), _stream(dev))
    _check_launch(lib, "fdm_qk_norm_rope", code, kernel)
    wrapper.launches += 1
    return qo, ko


@kernel_registry.register("qk_norm_rope_given", "cuda")
def qk_norm_rope_given_cuda(
    qk: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor], head_size: int,
    cos: Tensor, sin: Tensor, sumsq: Tensor, n_total: int, is_neox: bool = False,
    eps: float = 1e-6, inner_dim: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    kernel = "qk_norm_rope_given"
    _require(qk.dim() == 3, kernel, f"qk must be (B, S, W), got {tuple(qk.shape)}")
    d = qk.shape[-1] // 2 if inner_dim is None else inner_dim
    _require(0 < d and 2 * d <= qk.shape[-1] and d % 2 == 0, kernel,
             f"inner_dim {d} must be even and fit twice in a row of width {qk.shape[-1]}")
    st = (qk.stride(0), qk.stride(1))
    return _qk_given_launch(qk_norm_rope_given_cuda, qk[..., :d], qk[..., d:2 * d], st + st, d,
                            gamma_q, gamma_k, head_size, cos, sin, sumsq, n_total, is_neox, eps)


qk_norm_rope_given_cuda.launches = 0


@kernel_registry.register("qk_norm_rope2_given", "cuda")
def qk_norm_rope2_given_cuda(
    q: Tensor, k: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor],
    head_size: int, cos: Tensor, sin: Tensor, sumsq: Tensor, n_total: int,
    is_neox: bool = False, eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    _require(q.dim() == 3 and tuple(k.shape) == tuple(q.shape), "qk_norm_rope2_given",
             f"q and k must be (B, S, D) of one shape, got {tuple(q.shape)}/{tuple(k.shape)}")
    return _qk_given_launch(qk_norm_rope2_given_cuda, q, k,
                            (q.stride(0), q.stride(1), k.stride(0), k.stride(1)), q.shape[2],
                            gamma_q, gamma_k, head_size, cos, sin, sumsq, n_total, is_neox, eps)


qk_norm_rope2_given_cuda.launches = 0


@kernel_registry.register("quantize_stats", "cuda")
def quantize_stats_cuda(x: Tensor, symmetric: bool = True) -> Tensor:
    kernel = "quantize_stats"
    m, k = _check_rows(x, kernel)
    stats = torch.empty(m, 1 if symmetric else 2, dtype=torch.float32, device=x.device)
    if m == 0:
        return stats
    lib, fn = _entry("quant", "fdm_quantize_stats", [_P, _L, _L, _I, _P, _I, _P])
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), x.stride(0), m, k, stats.data_ptr(), int(symmetric),
                  _stream(x.device))
    _check_launch(lib, "fdm_quantize", code, kernel)
    quantize_stats_cuda.launches += 1
    return stats


quantize_stats_cuda.launches = 0


def _quantize_given(x: Tensor, stats: Tensor, kernel: str, mode: str,
                    wrapper) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The quantizer's pass 2 on given row statistics (quantize_stats'
    layout for `mode`), counted on `wrapper`."""
    dev = x.device
    m, k = _check_rows(x, kernel)
    width = 2 if mode == "int8_asym" else 1
    _require(stats.device == dev and stats.dtype == torch.float32
             and tuple(stats.shape) == (m, width), kernel,
             f"stats must be float32 ({m}, {width}) on {dev}, got {stats.dtype} "
             f"{tuple(stats.shape)}")
    stats = stats.contiguous()
    q = torch.empty(m, k, dtype=torch.float8_e4m3fn if mode == "fp8" else torch.int8, device=dev)
    scale = torch.empty(m, 1, dtype=torch.float32, device=dev)
    zp = torch.empty(m, 1, dtype=torch.int32, device=dev) if mode == "int8_asym" else None
    if m == 0:
        return q, scale, zp
    lib, fn = _entry("quant", "fdm_quantize_rows_given", [_P, _L, _L, _I, _P, _P, _P, _P, _I, _P])
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), x.stride(0), m, k, stats.data_ptr(), q.data_ptr(),
                  scale.data_ptr(), zp.data_ptr() if zp is not None else None,
                  _QUANT_MODES[mode], _stream(dev))
    _check_launch(lib, "fdm_quantize", code, kernel)
    wrapper.launches += 1
    return q, scale, zp


@kernel_registry.register("quantize_to_int8_given", "cuda")
def quantize_to_int8_given_cuda(x: Tensor, stats: Tensor, symmetric: bool = True
                                ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    return _quantize_given(x, stats, "quantize_to_int8_given",
                           "int8_sym" if symmetric else "int8_asym", quantize_to_int8_given_cuda)


quantize_to_int8_given_cuda.launches = 0


@kernel_registry.register("quantize_to_fp8_given", "cuda")
def quantize_to_fp8_given_cuda(x: Tensor, stats: Tensor) -> Tuple[Tensor, Tensor]:
    q, scale, _ = _quantize_given(x, stats, "quantize_to_fp8_given", "fp8",
                                  quantize_to_fp8_given_cuda)
    return q, scale


quantize_to_fp8_given_cuda.launches = 0


@kernel_registry.register("quantize_to_int4_given", "cuda")
def quantize_to_int4_given_cuda(x: Tensor, stats: Tensor) -> Tuple[Tensor, Tensor]:
    q, scale, _ = _quantize_given(x, stats, "quantize_to_int4_given", "int4",
                                  quantize_to_int4_given_cuda)
    return q, scale


quantize_to_int4_given_cuda.launches = 0


@kernel_registry.register("int8_matmul_partial", "cuda")
def int8_matmul_partial_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor,
                             azp_adj: Tensor, azp: Optional[Tensor]) -> Tensor:
    return _w8a8_gemm("int8_matmul_partial", int8_matmul_partial_cuda, a, b, scale_a, scale_b,
                      torch.float32, azp_adj, azp, None, fp8=False, partial=True)


int8_matmul_partial_cuda.launches = 0


@kernel_registry.register("fp8_matmul_partial", "cuda")
def fp8_matmul_partial_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor) -> Tensor:
    return _w8a8_gemm("fp8_matmul_partial", fp8_matmul_partial_cuda, a, b, scale_a, scale_b,
                      torch.float32, None, None, None, fp8=True, partial=True)


fp8_matmul_partial_cuda.launches = 0


@kernel_registry.register("int4_matmul_partial", "cuda")
def int4_matmul_partial_cuda(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor) -> Tensor:
    return _w8a8_gemm("int4_matmul_partial", int4_matmul_partial_cuda, a, b, scale_a, scale_b,
                      torch.float32, None, None, None, fp8=False, int4=True, partial=True)


int4_matmul_partial_cuda.launches = 0

TP_WRAPPERS = (rms_sumsq_cuda, rms_norm_given_cuda, qk_norm_rope_given_cuda,
               qk_norm_rope2_given_cuda, quantize_stats_cuda, quantize_to_int8_given_cuda,
               quantize_to_fp8_given_cuda, quantize_to_int4_given_cuda, int8_matmul_partial_cuda,
               fp8_matmul_partial_cuda, int4_matmul_partial_cuda)

KERNEL_WRAPPERS = (rms_norm_cuda, rotary_pos_embedding_cuda, qk_norm_rope_cuda,
                   qk_norm_rope2_cuda, gelu_and_mul_cuda, sdpa_cuda, sdpa_lse_cuda,
                   gather_super_attention_cuda,
                   gather_fine_attention_cuda, gather_sparse_attention_cuda,
                   sparse_attention_cuda, quantize_to_int8_cuda, quantize_to_fp8_cuda,
                   int8_matmul_cuda, fp8_matmul_cuda, quantize_to_int4_cuda, int4_matmul_cuda,
                   unpack_int4_cuda, w4a4_linear_large_cuda,
                   w4a4_linear_small_cuda) + TP_WRAPPERS


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0

