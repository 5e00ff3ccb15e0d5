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
from typing import Dict, Optional, Tuple

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



# ---------------------------------------------------------------- the dryrun step

# JAX's flux_dryrun_step (fastdm_tpu/parallel/mesh.py:157-231): its config
# (:172-177), sequence sizes (:182), timestep and guidance (:200-201)
DRYRUN_CONFIG = dict(num_layers=2, num_single_layers=2, attention_head_dim=32,
                     num_attention_heads=4, joint_attention_dim=64, pooled_projection_dim=48,
                     in_channels=16, out_channels=16, axes_dims_rope=(8, 12, 12), quant=None)
DRYRUN_TXT, DRYRUN_HT, DRYRUN_WT = 16, 8, 8
DRYRUN_T, DRYRUN_GUIDANCE = 0.5, 3.5
INPUT_KEYS = ("hidden", "encoder", "pooled", "target")


def dryrun_inputs(cfg, batch: int, txt: int = DRYRUN_TXT, ht: int = DRYRUN_HT,
                  wt: int = DRYRUN_WT, seed: int = 1) -> Dict[str, "np.ndarray"]:
    """JAX's dryrun inputs by shape, N(0, 1) f32 from numpy (JAX draws them
    with jax.random): hidden (b, ht*wt, in_channels), encoder (b, txt,
    joint_attention_dim) and pooled (b, pooled_projection_dim), which the
    step rounds to bf16, and the f32 target (b, ht*wt, out_channels)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = {"hidden": (batch, ht * wt, cfg.in_channels),
              "encoder": (batch, txt, cfg.joint_attention_dim),
              "pooled": (batch, cfg.pooled_projection_dim),
              "target": (batch, ht * wt, cfg.out_channels)}
    return {k: rng.standard_normal(shapes[k]).astype(np.float32) for k in INPUT_KEYS}


def _process_group_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and (
        dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ))


def _rank_step(model, cfg, ins: Dict[str, torch.Tensor], cos, sin):
    """One rank's loss (f32 MSE of the flux_forward output against the
    target, the mean over its batch rows) and its gradient in every
    parameter of its (shard of the) model, by parameter name."""
    from fastdm_tpu_torch.models.flux import flux_forward
    from fastdm_tpu_torch.training.lora import call_with

    leaves = {n: p.detach().requires_grad_() for n, p in model.named_parameters()}
    out = call_with(model, leaves, flux_forward, cfg, ins["hidden"], ins["encoder"],
                    ins["pooled"], ins["t"], cos, sin, guidance=ins["guidance"])
    loss = ((out.float() - ins["target"]) ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(leaves.items(), grads)}


def flux_dryrun_step(n_devices: Optional[int] = None, *, mesh_shape=None, device="cuda",
                     cfg=None, params=None, inputs=None, txt: int = DRYRUN_TXT,
                     ht: int = DRYRUN_HT, wt: int = DRYRUN_WT, seed: int = 0):
    """One training-style step of bf16 FLUX over a (dp, sp, tp) mesh (port of
    JAX's flux_dryrun_step, fastdm_tpu/parallel/mesh.py:157-231): the
    denoiser forward, the f32 MSE against a target, and the gradients of
    every parameter, backward collectives included.

    The mesh: mesh_shape, or factor_mesh(n_devices) as JAX's. dp splits the
    batch (b / dp rows a dp rank; the loss is the mean over the whole batch
    and the gradients are averaged over dp only); sp runs each
    self-attention as the ring (context_parallel.py, its backward the
    ring-attention backward); tp splits the blocks by the engine's name
    rules (tensor_parallel.shard_block; the tp collectives' Functions carry
    the gradients). A replicated parameter's gradient is whole on every
    rank.

    Two forms: over torchrun's process group (init_mesh, one process a
    card, NCCL, or gloo on the CPU) when torchrun's environment or an
    initialised group is there and the mesh has more than one device; else
    over virtual ranks in this process (the tp ranks as threads,
    run_virtual_ranks(..., grad=True), the sp ranks as a VirtualRing, the dp
    ranks one after another).

    Defaults are JAX's: DRYRUN_CONFIG (quant=None), b = max(2, dp), 16 text
    and 8x8 image tokens, t 0.5, guidance 3.5, params flux_init_random(seed)
    and dryrun_inputs(); cfg, the sizes, params (a JAX tree of numpy leaves,
    moved by models/convert.py flux_params_from_numpy, or a FluxTransformer
    on the device, left as it is) and inputs (dryrun_inputs' keys) can be
    given. device "cuda" runs the kernels (a rank's card: cuda:LOCAL_RANK);
    device="cpu" the plain versions.

    -> (loss, {tp rank: {parameter name: gradient}}): this process's tp
    rank under a process group, every tp rank on virtual ranks; each rank's
    gradients are those of its shard. Raises AssertionError when the loss or
    a gradient is not finite or the ranks' losses differ, and prints JAX's
    line."""
    import numpy as np

    from fastdm_tpu_torch.device import resolve_device
    from fastdm_tpu_torch.models.flux import FluxConfig, flux_init_random, flux_rope_cache
    from fastdm_tpu_torch.parallel import cp_state
    from fastdm_tpu_torch.parallel.context_parallel import GroupRing, VirtualRing
    from fastdm_tpu_torch.parallel.tensor_parallel import DistTPGroup, run_virtual_ranks, \
        shard_copy, virtual_groups

    if mesh_shape is None:
        mesh_shape = factor_mesh(1 if n_devices is None else int(n_devices))
    if len(mesh_shape) != 3 or any(int(x) < 1 for x in mesh_shape):
        raise ValueError(f"mesh_shape must be (dp, sp, tp), got {mesh_shape}")
    dp, sp, tp = (int(x) for x in mesh_shape)
    cfg = cfg if cfg is not None else FluxConfig(**DRYRUN_CONFIG)
    if cfg.quant not in (None, "bf16"):
        raise ValueError(f"the dryrun step differentiates the bf16 model (quant=None), got "
                         f"quant={cfg.quant!r}")
    if inputs is None:
        inputs = dryrun_inputs(cfg, max(2, dp), txt, ht, wt)
    b = inputs["hidden"].shape[0]
    if b % dp or inputs["hidden"].shape[1] != ht * wt or inputs["encoder"].shape[1] != txt:
        raise ValueError(f"inputs of batch {b} and {inputs['hidden'].shape[1]} + "
                         f"{inputs['encoder'].shape[1]} tokens do not fit dp={dp}, {ht}x{wt} "
                         f"image and {txt} text tokens")
    virtual = dp * sp * tp == 1 or not _process_group_ready()
    dev = mesh_device(resolve_device(device))
    mesh = None if virtual else init_mesh((dp, sp, tp), dev)
    if params is None:
        whole = flux_init_random(seed, cfg, device=dev)
    elif isinstance(params, torch.nn.Module):
        whole = params
    else:
        from fastdm_tpu_torch.models.convert import flux_params_from_numpy

        whole = flux_params_from_numpy(params, device=dev)
    cos, sin = flux_rope_cache(cfg, txt, ht, wt, device=dev)
    per = b // dp

    def batch(i: int) -> Dict[str, torch.Tensor]:
        ins = {k: torch.as_tensor(np.asarray(inputs[k][i * per:(i + 1) * per])).to(dev)
               for k in INPUT_KEYS}
        for k in ("hidden", "encoder", "pooled"):
            ins[k] = ins[k].to(torch.bfloat16)
        ins["target"] = ins["target"].float()
        ins["t"] = torch.full((per,), DRYRUN_T, dtype=torch.float32, device=dev)
        ins["guidance"] = torch.full((per,), DRYRUN_GUIDANCE, dtype=torch.float32, device=dev)
        return ins

    if virtual:
        groups = virtual_groups(tp)
        shards = [whole] if tp == 1 else [shard_copy(whole, cfg, g) for g in groups]
        sums: list = [None] * tp
        with cp_state.cp_ring(VirtualRing(sp) if sp > 1 else None):
            for i in range(dp):
                ins = batch(i)
                res = run_virtual_ranks(lambda r: _rank_step(shards[r], cfg, ins, cos, sin),
                                        groups, grad=True)
                for r, (loss, grads) in enumerate(res):
                    if dp == 1:
                        sums[r] = (loss, grads)
                    elif sums[r] is None:
                        sums[r] = (loss, {n: g.float() for n, g in grads.items()})
                    else:
                        sums[r] = (sums[r][0] + loss,
                                   {n: sums[r][1][n].add_(g) for n, g in grads.items()})
        losses = [s[0] / dp for s in sums]
        grads = {r: {n: (g / dp).to(torch.bfloat16) if dp > 1 else g for n, g in s[1].items()}
                 for r, s in enumerate(sums)}
        lead = True
    else:
        axis = mesh.axis("tp")
        model = shard_copy(whole, cfg, DistTPGroup(axis)) if tp > 1 else whole
        ring = GroupRing(mesh.axis("sp")) if sp > 1 else None
        with cp_state.cp_ring(ring):
            loss, g = _rank_step(model, cfg, batch(mesh.axis("dp").rank), cos, sin)
        if dp > 1:
            import torch.distributed as dist

            # one all-reduce of every gradient and the loss, in f32, then / dp
            flat = torch.cat([t.float().flatten() for t in g.values()] + [loss.view(1)])
            dist.all_reduce(flat, group=mesh.axis("dp").group)
            flat /= dp
            off = 0
            for n, t in g.items():
                g[n] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
                off += t.numel()
            loss = flat[-1]
        losses = _all_losses(loss)
        grads = {axis.rank: g}
        import torch.distributed as dist

        lead = dist.get_rank() == 0
    if not all(torch.equal(x, losses[0]) for x in losses):
        raise AssertionError(f"dryrun losses differ across ranks: {[x.item() for x in losses]}")
    loss = losses[0].item()
    if not np.isfinite(loss):
        raise AssertionError("dryrun loss not finite")
    if not all(torch.isfinite(t).all() for g in grads.values() for t in g.values()):
        raise AssertionError("dryrun grads not finite")
    if lead:
        print(f"dryrun_multichip ok: mesh dp={dp} sp={sp} tp={tp}, loss={loss:.4f}, "
              f"{len(next(iter(grads.values())))} grad leaves")
    return loss, grads


def _all_losses(loss: torch.Tensor) -> list:
    """Every rank's loss (the default process group)."""
    import torch.distributed as dist

    out = [torch.empty_like(loss) for _ in range(dist.get_world_size())]
    dist.all_gather(out, loss.contiguous())
    return out


def main(argv=None) -> None:
    """`torchrun --nproc-per-node N -m fastdm_tpu_torch.parallel.mesh`: JAX's
    dryrun over N cards (factor_mesh(N), or --mesh-shape dp,sp,tp); without
    torchrun, over virtual ranks in this process."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--mesh-shape", default=None, help="dp,sp,tp (default: factor_mesh(N))")
    ap.add_argument("--devices", type=int, default=int(os.environ.get("WORLD_SIZE", "8")))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    flux_dryrun_step(args.devices, mesh_shape=shape, device=args.device)


if __name__ == "__main__":
    main()
