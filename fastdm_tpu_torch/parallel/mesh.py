"""The device mesh on torch.distributed (port of fastdm_tpu/parallel/mesh.py:33-57).

Axes, as in JAX:
  dp -- data parallel. The engine computes replicated on every dp rank, as
        the JAX engine does; the GPipe schedule splits its microbatch stream
        over dp when the count divides.
  sp -- sequence parallel: dense self-attention runs as a ring over the sp
        group (context_parallel.py), cross-attention on each rank's query
        shard; the activations between attention calls stay whole on every
        rank, as JAX's engine shards only the weights.
  tp -- tensor parallel. JAX gets it from GSPMD's name rules
        (generic_param_pspec, shard_params_by_name), ported below as functions
        of a port module path (tp_kind); the Megatron-style
        splits and the row-parallel collectives are tensor_parallel.py's.
        Every family and both ControlNets split.
  pp -- pipeline parallel over the block stacks (pipeline.py), the fourth
        axis of a (dp, sp, tp, pp) mesh.

A mesh of more than one device needs torch.distributed: torchrun's
environment (one process a card: `torchrun --nproc-per-node N`), or a
default process group its caller initialised. NCCL serves CUDA, gloo the
CPU, and a rank's card is cuda:LOCAL_RANK. A mesh of one device needs no
group.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Tuple

import torch

AXES = ("dp", "sp", "tp")


def factor_mesh(n: int) -> Tuple[int, int, int]:
    """Factor n devices into (dp, sp, tp), preferring tp (JAX's factors)."""

    def largest_pow2_divisor(x: int, cap: int) -> int:
        d = 1
        while x % (d * 2) == 0 and d * 2 <= cap:
            d *= 2
        return d

    tp = largest_pow2_divisor(n, 4)
    rem = n // tp
    sp = largest_pow2_divisor(rem, 2)
    dp = rem // sp
    return dp, sp, tp


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this process sees it: its size, this rank's
    coordinate on it, its process group (None when the size is 1) and the
    global ranks along it, in axis order, on this rank's line."""
    size: int
    rank: int
    group: object = None
    ranks: Tuple[int, ...] = (0,)


class Mesh:
    """A (dp, sp, tp) or (dp, sp, tp, pp) mesh: `shape` maps each axis name
    to its size; axis(name) gives this rank's view of it; device_mesh is
    torch's DeviceMesh, None for a mesh of one device without a process
    group."""

    def __init__(self, names: Tuple[str, ...], axes: Dict[str, Axis], device_mesh=None):
        self.names = names
        self._axes = axes
        self.device_mesh = device_mesh
        self.shape = {n: axes[n].size for n in names}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis(self, name: str) -> Axis:
        return self._axes.get(name, Axis(1, 0))


def mesh_device(device: torch.device) -> torch.device:
    """A rank's device: cuda:LOCAL_RANK for a bare "cuda" (0 outside
    torchrun), the given device otherwise."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def _init_default_group(n: int, device: torch.device) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo")
        return
    raise RuntimeError(
        f"a mesh of {n} devices needs torch.distributed: launch with `torchrun "
        f"--nproc-per-node {n}` or initialise the default process group first")


def init_mesh(mesh_shape, device=None) -> Mesh:
    """The mesh of mesh_shape over the default process group (initialised
    from torchrun's environment when it is not yet), with one process group
    per axis. ValueError when the mesh is not 3 or 4 axes or its product
    differs from the world size."""
    if mesh_shape is None or len(mesh_shape) not in (3, 4):
        raise ValueError(f"mesh_shape must be (dp, sp, tp) or (dp, sp, tp, pp), got {mesh_shape}")
    names = AXES if len(mesh_shape) == 3 else AXES + ("pp",)
    shape = tuple(int(d) for d in mesh_shape)
    if any(d < 1 for d in shape):
        raise ValueError(f"mesh_shape {mesh_shape}: every axis must be >= 1")
    device = mesh_device(torch.device(device) if device is not None else torch.device("cpu"))
    n = math.prod(shape)
    import torch.distributed as dist

    if n == 1 and not dist.is_initialized():
        return Mesh(names, {name: Axis(1, 0) for name in names})
    _init_default_group(n, device)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh_shape {mesh_shape} has {n} devices but the process group has "
                         f"{world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
    axes = {}
    for name in names:
        group = dm.get_group(name)
        ranks = tuple(dist.get_process_group_ranks(group))
        axes[name] = Axis(len(ranks), dm.get_local_rank(name), group if len(ranks) > 1 else None,
                          ranks)
    return Mesh(names, axes, dm)


# ---------------------------------------------------------------- tp rules

_COLUMN = ("qkv", "add_qkv", ".kv", "ff.proj", "ff_context.proj", "img_mlp.proj",
           "txt_mlp.proj", "ffn.proj", "proj_mlp", "attn2.q", "attn.q",
           # the AdaLN modulations: per-sample outputs, gathered after the matmul
           "img_mod", "txt_mod", "norm1.linear", "norm1_context.linear", "norm.linear")
_ROW = ("to_out", "to_add_out", "ff.out", "ff_context.out", "img_mlp.out", "txt_mlp.out",
        "ffn.out")


def generic_tp_kind(path: str) -> str:
    """JAX's generic_param_pspec (fastdm_tpu/parallel/mesh.py:57-94) as the
    kind of the QLinear at a module path: "column" (output dim on tp: the
    fused qkv / kv projections, FF inputs, the AdaLN modulations), "row"
    (input dim on tp: out-projections, FF outputs, the single-stream
    proj_out) or "replicate". The rules match substrings, as JAX's do."""
    col = any(k in path for k in _COLUMN)
    row = any(k in path for k in _ROW)
    row = row or (".proj_out" in path and ("single" in path or "blocks" in path))
    if row:
        return "row"
    return "column" if col else "replicate"


# Where the port's split departs from JAX's rules (ROADMAP.md section 3):
# Wan2.1-I2V's image K / V projections and the SDXL IP-Adapter's k | v, which
# no JAX rule names (replicated there), are cut by heads like attn2's text
# K / V, so that a rank computes only its heads' image attention; SDXL's
# attention out-projections (the JAX tree's "out", which no rule names) are
# row-split after their column-split q | k | v, where GSPMD gathers the
# heads and runs the whole projection on every device
TP_DEPARTURES = {"attn2.add_k": "column", "attn2.add_v": "column",
                 "attn2.ipadp_kv": "column", "attn1.out": "row", "attn2.out": "row"}


def tp_kind(path: str) -> str:
    """The split of the QLinear at a port module path, as JAX's
    shard_params_by_name places it (fastdm_tpu/parallel/mesh.py:96-112):
    only block weights ("block" in the path) are split, by
    generic_tp_kind, except TP_DEPARTURES. Whether a split happens also
    depends on the shapes (heads and widths that tp divides:
    tensor_parallel.shard_block)."""
    if "block" not in path:
        return "replicate"
    for key, kind in TP_DEPARTURES.items():
        if path.endswith(key):
            return kind
    return generic_tp_kind(path)

