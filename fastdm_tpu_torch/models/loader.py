"""Checkpoint loading (port of fastdm_tpu/models/loader.py).

Reads diffusers-format safetensors through ``safetensors.torch`` (or takes an
in-memory dict of tensors / numpy arrays) and hands out QLinear modules and
raw tensors on the source's device, keeping the reference's two behaviours:

  * fused projections: qkv / qkv+mlp weights are concatenated along the output
    dimension before they are stored,
  * exhaustive consumption: every checkpoint tensor must be claimed; leftovers
    raise.

Checkpoint Linear weights are (out_features, in_features) and are transposed
to (in, out) once here.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.qlinear import QLinear, fuse_and_quantize

Tensor = torch.Tensor


def as_tensor(x) -> Tensor:
    """A CPU torch tensor from a torch tensor or a numpy array. numpy bfloat16
    and float8_e4m3fn (ml_dtypes) are not accepted by torch.from_numpy; they
    go through their uint16 / uint8 bit patterns."""
    if isinstance(x, Tensor):
        return x
    a = np.require(x, requirements=["C", "W"])  # torch wants writable memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


class TensorSource:
    """Dict-like view over checkpoint tensors with consumption tracking.
    Claimed tensors are moved to `device`."""

    def __init__(self, tensors: Dict[str, object], device="cuda"):
        self._tensors = dict(tensors)
        self._unclaimed = set(self._tensors)
        self.device = resolve_device(device)
        # pipeline placement: {stack prefix: indices of the blocks this rank
        # holds}; None holds every block
        self.stage_blocks = None
        # tensor parallelism: shard(module path, block) -> this rank's shard of
        # a block built whole (parallel/tensor_parallel.py shard_block); None
        # keeps every block whole
        self.shard = None

    @classmethod
    def from_path(cls, path: str, device="cuda") -> "TensorSource":
        """A .safetensors file or a directory of them."""
        from safetensors.torch import load_file

        files = sorted(glob.glob(os.path.join(path, "*.safetensors"))) if os.path.isdir(path) \
            else [path]
        if not files:
            raise FileNotFoundError(f"no .safetensors under {path!r}")
        tensors: Dict[str, Tensor] = {}
        for f in files:
            tensors.update(load_file(f))
        return cls(tensors, device)

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    def names(self):
        """Every tensor name of the checkpoint, sorted."""
        return sorted(self._tensors)

    def take(self, name: str) -> Tensor:
        if name not in self._tensors:
            raise KeyError(f"checkpoint tensor {name!r} not found")
        self._unclaimed.discard(name)
        return as_tensor(self._tensors[name])

    def tensor(self, name: str, dtype=torch.bfloat16) -> Tensor:
        """Claim a raw (norm / conv / table) tensor."""
        return self.take(name).to(device=self.device, dtype=dtype)

    def conv(self, prefix: str) -> Dict[str, Tensor]:
        """Claim '{prefix}.weight' / '.bias' of a conv: {"w": (out, in, kh,
        kw) bf16, "b": f32}, both read through f32 as the JAX conv_from_torch
        does (fastdm_tpu/layers/conv2d.py)."""
        return {"w": self.tensor(f"{prefix}.weight", torch.float32).to(torch.bfloat16),
                "b": self.tensor(f"{prefix}.bias", torch.float32)}

    def linear(self, prefix: str, quant: Optional[str]) -> QLinear:
        """Claim '{prefix}.weight' (+ optional bias) as a QLinear."""
        return self.fused_linear([prefix], quant)

    def fused_linear(self, prefixes: Sequence[str], quant: Optional[str]) -> QLinear:
        """Claim several projections and fuse them along the output dim.
        int8, fp8, int4 and int4p weights are quantized here, on the source's
        device, by layers.qlinear.quantize_weight — the reference's jnp path
        (fastdm_tpu/layers/qlinear.py:121-157, fuse_and_quantize of
        fastdm_tpu/models/loader.py:118; int4's low-rank QR and SVD run on
        that device too). The JAX loader's native host
        quantizer (fastdm_tpu/native/quant.cpp:148-153) multiplies by a
        reciprocal for fp8 and so differs by one e4m3 step on a few weights;
        the port does not copy that."""
        ws, bs = [], []
        for p in prefixes:
            ws.append(self.tensor(f"{p}.weight", torch.float32).t())
            bname = f"{p}.bias"
            bs.append(self.tensor(bname, torch.float32) if bname in self else None)
        if any(b is None for b in bs):
            if not all(b is None for b in bs):
                raise ValueError(f"mixed bias presence in {list(prefixes)}")
            bs = [None]
        else:
            bs = [bs[0] if len(bs) == 1 else torch.cat(bs, dim=0)]
        return fuse_and_quantize(ws, bs, quant)

    def block(self, path: str, module):
        """A block just built whole, as this rank keeps it: its tp shard
        (the quantized weights are cut after quantizing the whole weight,
        as JAX quantizes before it places), or the block itself."""
        return module if self.shard is None else self.shard(path, module)

    def holds(self, stack: str, index: int) -> bool:
        """Whether this rank holds block `index` of the stack whose tensors
        are named `{stack}.{index}.*` (parallel/pipeline.py stage_blocks)."""
        keep = None if self.stage_blocks is None else self.stage_blocks.get(stack)
        return keep is None or index in keep

    def elsewhere(self, stack: str, index: int):
        """Claim block `index` of `stack` without reading it, for a block
        another pipeline stage holds -> its parameterless placeholder."""
        from fastdm_tpu_torch.parallel.pipeline import StageElsewhere

        prefix = f"{stack}.{index}."
        self._unclaimed.difference_update([n for n in self._unclaimed if n.startswith(prefix)])
        return StageElsewhere(stack, index)

    def assert_consumed(self) -> None:
        """Every checkpoint tensor must have been claimed."""
        if self._unclaimed:
            sample = sorted(self._unclaimed)[:10]
            raise ValueError(f"{len(self._unclaimed)} checkpoint tensors were never "
                             f"consumed, e.g. {sample}")
