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
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, FrozenSet, Iterable, Optional

import torch

BACKENDS = ("torch", "cuda")


class KernelRegistry:
    def __init__(self) -> None:
        self._ops: Dict[str, Dict[str, Callable]] = {}
        self._plain_on_device: FrozenSet[str] = frozenset()

    def register(self, op_name: str, backend: str) -> Callable:
        if backend not in BACKENDS:
            raise ValueError(f"invalid kernel backend {backend!r}; expected one of {BACKENDS}")

        def deco(fn: Callable) -> Callable:
            self._ops.setdefault(op_name, {})[backend] = fn
            return fn

        return deco

    def backend_for(self, op_name: str, device: torch.device) -> str:
        if device.type == "cpu" or (device.type == "cuda" and op_name in self._plain_on_device):
            return "torch"
        if device.type == "cuda":
            return "cuda"
        raise ValueError(f"op {op_name!r}: no backend for device {device}")

    def select(self, op_name: str, device: torch.device) -> Callable:
        impls = self._ops.get(op_name)
        if not impls:
            raise KeyError(f"no implementations registered for op {op_name!r}")
        backend = self.backend_for(op_name, device)
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
                return self.select(op_name, x.device)(x, *args, **kwargs)

            wrapper.op_name = op_name
            return wrapper

        return deco

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


kernel_registry = KernelRegistry()
