"""Kernel registry: op name -> {backend name -> implementation}.

Counterpart of fastdm_tpu/kernels/registry.py. There the backend is chosen
at trace time from an environment variable; here PyTorch runs eagerly and the
choice follows the device of the op's first tensor argument:

  "torch" — the plain PyTorch version (kernels/torch_backend.py). It is the
            numerical oracle of the tests and the path of every tensor that
            lies on the CPU.
  "cuda"  — the hand-written Hopper kernel (kernels/cuda_backend.py, sources in
            csrc/). Every CUDA tensor goes here. An op without a kernel, or a
            kernel that fails to build or launch, raises: there is no silent
            fall back to the plain version on the card (the JAX registry's
            "pallas -> jnp" degradation, registry.py:77-78, is gone).
  "ring"  — dense sdpa while a sequence-parallel ring is active
            (parallel/cp_state.py; JAX's check at registry.py:59-67): the
            ring attention of parallel/context_parallel.py, whose local
            blocks take the device's backend again (routed=False). Under
            autograd it is its own Function (the ring-attention backward).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, FrozenSet, Iterable, Optional

import torch

BACKENDS = ("torch", "cuda", "ring")


class KernelRegistry:
    def __init__(self) -> None:
        self._ops: Dict[str, Dict[str, Callable]] = {}
        self._plain_on_device: FrozenSet[str] = frozenset()
        self._grads: Dict[str, Callable] = {}

    def register(self, op_name: str, backend: str) -> Callable:
        if backend not in BACKENDS:
            raise ValueError(f"invalid kernel backend {backend!r}; expected one of {BACKENDS}")

        def deco(fn: Callable) -> Callable:
            self._ops.setdefault(op_name, {})[backend] = fn
            return fn

        return deco

    def register_grad(self, op_name: str) -> Callable:
        """Register the differentiable form of op_name (same arguments)."""

        def deco(fn: Callable) -> Callable:
            self._grads[op_name] = fn
            return fn

        return deco

    def backend_for(self, op_name: str, device: torch.device, routed: bool = True) -> str:
        if routed and op_name == "sdpa" and "ring" in self._ops.get(op_name, {}):
            from fastdm_tpu_torch.parallel import cp_state

            if cp_state.get_cp_ring() is not None:
                return "ring"
        if device.type == "cpu" or (device.type == "cuda" and op_name in self._plain_on_device):
            return "torch"
        if device.type == "cuda":
            return "cuda"
        raise ValueError(f"op {op_name!r}: no backend for device {device}")

    def select(self, op_name: str, device: torch.device, routed: bool = True) -> Callable:
        impls = self._ops.get(op_name)
        if not impls:
            raise KeyError(f"no implementations registered for op {op_name!r}")
        backend = self.backend_for(op_name, device, routed)
        if backend not in impls:
            raise NotImplementedError(
                f"op {op_name!r} has no {backend!r} implementation (have {sorted(impls)})")
        return impls[backend]

    def dispatch(self, op_name: str) -> Callable:
        """Decorator turning an interface stub into a call dispatched on the
        device of its first (tensor) argument."""

        def deco(stub: Callable) -> Callable:
            @functools.wraps(stub)
            def wrapper(x: torch.Tensor, *args, **kwargs):
                if torch.is_grad_enabled() and _requires_grad(x, args, kwargs):
                    return self.select_grad(op_name, x)(x, *args, **kwargs)
                return self.select(op_name, x.device)(x, *args, **kwargs)

            wrapper.op_name = op_name
            return wrapper

        return deco

    def select_grad(self, op_name: str, x: torch.Tensor, routed: bool = True) -> Callable:
        """The differentiable form of op_name for x's device: the ring's own
        Function while a ring is active (sdpa), the plain version's autograd
        inside plain_on_device, the registered Function, or on the CPU the
        plain version; NotImplementedError for a kernel without one."""
        backend = self.backend_for(op_name, x.device, routed)
        if backend == "ring":
            return self._ops[op_name]["ring"]
        if op_name in self._plain_on_device:
            return self._ops[op_name]["torch"]  # the plain version's own autograd
        if op_name in self._grads:
            return self._grads[op_name]
        if backend == "torch":
            return self.select(op_name, x.device)
        raise NotImplementedError(f"op {op_name!r} has no gradient on {x.device}: its kernel's "
                                  "output carries no grad_fn")

    @contextlib.contextmanager
    def plain_on_device(self, ops: Optional[Iterable[str]] = None):
        """Run the plain PyTorch versions of `ops` (all ops when None) on CUDA
        tensors inside the block.

        For measuring a whole model on the kernels against the same model on
        the plain versions (chip_smoke.py); the serving path never enters it."""
        plain = frozenset(self._ops if ops is None else ops)
        prev, self._plain_on_device = self._plain_on_device, plain
        try:
            yield
        finally:
            self._plain_on_device = prev


def _requires_grad(x: torch.Tensor, args, kwargs) -> bool:
    return any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in (x, *args, *kwargs.values()))


kernel_registry = KernelRegistry()
