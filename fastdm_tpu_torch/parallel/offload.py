"""Host residency of the inactive expert (port of FastDMEngine
offload_inactive_expert, fastdm_tpu/engine.py:700-725, and the placer of
make_wan_dual_phase_denoiser, fastdm_tpu/pipeline/denoise_more.py:854-900).

to_host moves a module's parameters and buffers into host memory, pinned
where the host allows it (page-locked memory makes the host-to-card copy an
asynchronous DMA at the link's rate); to_device makes a copy of a host module
on the card for one phase of the denoiser, which drops it after the phase, so
the card holds one expert at a time. Strides are kept: the quantized
weights' K-contiguous (K, N) views stay views of (N, K) buffers. Under a
pipeline mesh a rank's module holds only its own stage's blocks (the others
are parameterless placeholders), so only that part moves.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def _host_copy(t: Tensor, pin: bool) -> Tensor:
    h = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cpu", pin_memory=pin)
    h.copy_(t)
    return h


def _swap(module: nn.Module, fn) -> None:
    """Replace every parameter and buffer t of module (each once, shared ones
    shared) by fn(t)."""
    memo = {}
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None:
                if id(p) not in memo:
                    memo[id(p)] = nn.Parameter(fn(p.detach()), requires_grad=False)
                m._parameters[name] = memo[id(p)]
        for name, b in m._buffers.items():
            if b is not None:
                if id(b) not in memo:
                    memo[id(b)] = fn(b)
                m._buffers[name] = memo[id(b)]


def to_host(module: nn.Module, pin: bool = True) -> Tuple[nn.Module, bool]:
    """Move module's tensors into host memory, in place -> (module, pinned).
    Pinning needs a CUDA context and may fail on a host that cannot lock so
    much memory; the tensors then stay pageable (a host matter: the copies
    to the card still run, synchronously)."""
    pin = pin and torch.cuda.is_available()
    if pin:
        try:
            _swap(module, lambda t: _host_copy(t, True))
            return module, True
        except RuntimeError:
            pass
    _swap(module, lambda t: _host_copy(t, False) if t.device.type != "cpu" else t)
    return module, False


def to_device(module: nn.Module, device) -> nn.Module:
    """A copy of a host module whose tensors lie on `device` (asynchronous
    copies from pinned memory, on the current stream); the host module is
    left as it is."""
    device = torch.device(device)
    memo = {}
    for m in module.modules():
        for p in m._parameters.values():
            if p is not None and id(p) not in memo:
                memo[id(p)] = nn.Parameter(p.detach().to(device, non_blocking=True),
                                           requires_grad=False)
        for b in m._buffers.values():
            if b is not None and id(b) not in memo:
                memo[id(b)] = b.to(device, non_blocking=True)
    return copy.deepcopy(module, memo)


def module_bytes(module: nn.Module, device_type: str = None) -> int:
    """Bytes of module's parameters and buffers (on device_type only, when given)."""
    ts = {id(t): t for t in list(module.parameters()) + list(module.buffers())}
    return sum(t.numel() * t.element_size() for t in ts.values()
               if device_type is None or t.device.type == device_type)
