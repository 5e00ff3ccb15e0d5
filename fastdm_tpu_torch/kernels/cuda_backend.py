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

from fastdm_tpu_torch.kernels import contracts
from fastdm_tpu_torch.kernels.build import load_library
from fastdm_tpu_torch.kernels.registry import kernel_registry

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

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


# ---------------------------------------------------------------- rmsnorm


@kernel_registry.register("rmsnorm", "cuda")
def rms_norm_cuda(x: Tensor, weight: Optional[Tensor], eps: float) -> Tensor:
    kernel = "rmsnorm"
    dev = x.device
    _check_tensor(x, kernel, "x", dev)
    dim = x.shape[-1]
    _require(dim % 2 == 0, kernel, f"last dim {dim} must be even")
    if x.dim() >= 2 and x.stride(-2) != dim:
        x = x.contiguous()
    heads = x.shape[-2] if x.dim() >= 2 else 1
    x3 = x.reshape(-1, heads, dim)  # a view whenever the leading dims collapse
    _require(x3.stride(0) % 2 == 0 and x3.data_ptr() % 4 == 0, kernel,
             "rows must be 4-byte aligned")
    w = None
    if weight is not None:
        _require(weight.numel() == dim and weight.device == dev, kernel,
                 f"weight must be ({dim},) on {dev}")
        w = weight.reshape(dim).float().contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib, fn = _entry("rmsnorm", "fdm_rms_norm_bf16", [_P, _P, _P, _L, _I, _L, _I, _F, _P])
    with torch.cuda.device(dev):
        code = fn(x3.data_ptr(), w.data_ptr() if w is not None else None, out.data_ptr(),
                  x3.shape[0] * heads, heads, x3.stride(0), dim, float(eps), _stream(dev))
    _check_launch(lib, "fdm_rms_norm", code, kernel)
    rms_norm_cuda.launches += 1
    return out


rms_norm_cuda.launches = 0


# ---------------------------------------------------------------- rotembd


@kernel_registry.register("rotembd", "cuda")
def rotary_pos_embedding_cuda(
    query: Tensor, key: Tensor, head_size: int, cos: Tensor, sin: Tensor,
    is_neox: bool = False,
) -> Tuple[Tensor, Tensor]:
    kernel = "rotembd"
    if is_neox:
        raise NotImplementedError(
            "[rotembd] the CUDA kernel rotates interleaved pairs (FLUX); the half-split "
            "(neox) layout has only its plain version until a slice that runs it")
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
    for t in (query, key):
        _require(t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0,
                 kernel, "query/key rows must be 4-byte aligned")
    qo = torch.empty(query.shape, dtype=query.dtype, device=dev)
    ko = torch.empty(key.shape, dtype=key.dtype, device=dev)
    if b * s == 0:
        return qo, ko
    lib, fn = _entry("rope", "fdm_rope_bf16",
                     [_P] * 6 + [_I] * 5 + [_L] * 4 + [_P])
    with torch.cuda.device(dev):
        code = fn(query.data_ptr(), key.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), b, s, qd // head_size,
                  key.shape[2] // head_size, head_size, query.stride(0), query.stride(1),
                  key.stride(0), key.stride(1), _stream(dev))
    _check_launch(lib, "fdm_rope", code, kernel)
    rotary_pos_embedding_cuda.launches += 1
    return qo, ko


rotary_pos_embedding_cuda.launches = 0


# ------------------------------------------------------------------- sdpa


@kernel_registry.register("sdpa", "cuda")
def sdpa_cuda(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, is_causal: bool = False,
    scale: Optional[float] = None,
) -> Tensor:
    kernel = "sdpa"
    contracts.check_sdpa("sdpa_cuda", query, key, value, num_q_heads, num_kv_heads, head_dim)
    dev = query.device
    for name, t in (("query", query), ("key", key), ("value", value)):
        _check_tensor(t, kernel, name, dev)
        _require(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0,
                 kernel, f"{name} must be 16-byte aligned with strides multiple of 8")
    _require(head_dim in (64, 128), kernel, f"head_dim {head_dim} not in (64, 128)")
    b, sq, _ = query.shape
    skv = key.shape[1]
    if scale is None:
        scale = head_dim**-0.5
    out = torch.empty(query.shape, dtype=query.dtype, device=dev)
    if b * sq == 0:
        return out
    lib, fn = _entry("flash_attn", "fdm_flash_attn_fwd",
                     [_P] * 4 + [_I] * 6 + [_L] * 8 + [_F, _I, _P])
    with torch.cuda.device(dev):
        code = fn(query.data_ptr(), key.data_ptr(), value.data_ptr(), out.data_ptr(),
                  b, sq, skv, num_q_heads, num_kv_heads, head_dim,
                  query.stride(0), query.stride(1), key.stride(0), key.stride(1),
                  value.stride(0), value.stride(1), out.stride(0), out.stride(1),
                  float(scale * _LOG2E), int(is_causal), _stream(dev))
    _check_launch(lib, "fdm_flash_attn", code, kernel)
    sdpa_cuda.launches += 1
    return out


sdpa_cuda.launches = 0

KERNEL_WRAPPERS = (rms_norm_cuda, rotary_pos_embedding_cuda, sdpa_cuda)


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0

