"""Pipeline parallelism over the block stacks: the GPipe schedule (port of
fastdm_tpu/parallel/pipeline.py:50-240).

A pp axis of size pp holds each pipelined stack in pp consecutive slices of
L/pp blocks, stage s the blocks [s*L/pp, (s+1)*L/pp). Microbatches flow
stage to stage: over T = M + pp - 1 ticks, stage 0 injects microbatch t,
stage s > 0 receives microbatch t - s from stage s - 1, runs its blocks on it
and sends it on; the last stage collects the results, which are then
broadcast to the pp group (JAX's final psum). JAX runs every stage on every
tick and discards the fill and drain ticks' results (one traced fori_loop);
here a stage runs only the ticks that carry a microbatch, which gives the
same results. dp composes as in JAX: when the microbatch count divides by
dp, each dp rank pipelines its own M/dp microbatches and the results are
all-gathered over dp; otherwise every dp rank runs the whole stream.

block_fn(block, state) -> state is the same per-block function the
sequential runner calls, so a stage's results are those of the sequential
run of the same microbatch, bit for bit. A GroupPipeline moves the states
with point-to-point sends over the mesh's pp group (NCCL on the card, gloo on
the CPU); a VirtualPipeline runs its pp stages one after another in this
process and hands the states over in memory (chip_smoke.py drives it on one
card).

Placement (JAX's shard_model_stacks_pp, :164-182): a rank's card holds only
its own stage's blocks of each pipelined stack; a stack whose depth pp does
not divide stays whole on every rank and runs sequentially
(stage_blocks, and the loaders' TensorSource.holds).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
State = Tuple[Tensor, ...]


def gpipe_schedule(pp: int, m: int) -> List[List[Tuple[int, int]]]:
    """The (stage, microbatch) pairs of each of the M + pp - 1 ticks."""
    return [[(s, t - s) for s in range(pp) if 0 <= t - s < m] for t in range(m + pp - 1)]


class GroupPipeline:
    """GPipe over the mesh's pp axis (a mesh.Axis), this process being stage
    pp.rank; dp (a mesh.Axis) splits the microbatch stream."""

    def __init__(self, pp, dp=None):
        from fastdm_tpu_torch.parallel.mesh import Axis

        self.pp, self.dp = pp, dp if dp is not None else Axis(1, 0)
        self.size = pp.size

    def local_stages(self) -> Sequence[int]:
        return (self.pp.rank,)

    def send(self, stage: int, i: int, state: State) -> None:
        import torch.distributed as dist

        for t in state:
            dist.send(t.contiguous(), self.pp.ranks[stage + 1], group=self.pp.group)

    def recv(self, stage: int, i: int, like: State) -> State:
        import torch.distributed as dist

        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in like)
        for t in out:
            dist.recv(t, self.pp.ranks[stage - 1], group=self.pp.group)
        return out

    def broadcast_last(self, outs: Dict[int, State], like: List[State]) -> List[State]:
        import torch.distributed as dist

        last = self.size - 1
        res = []
        for i, proto in enumerate(like):
            state = outs[i] if self.pp.rank == last else tuple(
                torch.empty_like(t, memory_format=torch.contiguous_format) for t in proto)
            state = tuple(t.contiguous() for t in state)
            for t in state:
                dist.broadcast(t, self.pp.ranks[last], group=self.pp.group)
            res.append(state)
        return res

    def dp_share(self, m: int) -> Tuple[int, int]:
        """[lo, hi) of the microbatches this dp rank pipelines."""
        dp = self.dp.size
        if dp > 1 and m % dp == 0:
            per = m // dp
            return self.dp.rank * per, (self.dp.rank + 1) * per
        return 0, m

    def dp_gather(self, outs: List[State], m: int) -> List[State]:
        import torch.distributed as dist

        dp = self.dp.size
        if not (dp > 1 and m % dp == 0):
            return outs
        gathered: List[List[State]] = [[] for _ in range(dp)]
        for state in outs:
            per_rank = [[] for _ in range(dp)]
            for t in state:
                parts = [torch.empty_like(t) for _ in range(dp)]
                dist.all_gather(parts, t.contiguous(), group=self.dp.group)
                for r in range(dp):
                    per_rank[r].append(parts[r])
            for r in range(dp):
                gathered[r].append(tuple(per_rank[r]))
        return [s for r in range(dp) for s in gathered[r]]


class VirtualPipeline:
    """pp stages run one after another in this process, tick by tick; a state
    passes to the next stage in memory."""

    def __init__(self, pp: int):
        self.size = pp
        self._mail: Dict[Tuple[int, int], State] = {}

    def local_stages(self) -> Sequence[int]:
        return range(self.size)

    def send(self, stage: int, i: int, state: State) -> None:
        self._mail[(stage + 1, i)] = state

    def recv(self, stage: int, i: int, like: State) -> State:
        return self._mail.pop((stage, i))

    def broadcast_last(self, outs: Dict[int, State], like: List[State]) -> List[State]:
        return [outs[i] for i in range(len(like))]

    def dp_share(self, m: int) -> Tuple[int, int]:
        return 0, m

    def dp_gather(self, outs: List[State], m: int) -> List[State]:
        return outs


def gpipe_run_blocks(block_fn: Callable[[nn.Module, State], State], blocks: Sequence[nn.Module],
                     microbatches: List[State], group) -> List[State]:
    """Run every block of `blocks` (a ModuleList of L blocks, of which this
    rank holds its stages' L/pp consecutive ones) over each microbatch state
    under the GPipe schedule of `group` (a GroupPipeline or a
    VirtualPipeline). Returns the M final states, on every rank."""
    pp = group.size
    n = len(blocks)
    if n % pp:
        raise ValueError(f"stacked layer count {n} not divisible by pp={pp}")
    per = n // pp
    m_all = len(microbatches)
    lo, hi = group.dp_share(m_all)
    mine = microbatches[lo:hi]
    m = len(mine)
    outs: Dict[int, State] = {}
    for tick in gpipe_schedule(pp, m):
        for s, i in tick:
            if s not in group.local_stages():
                continue
            state = mine[i] if s == 0 else group.recv(s, i, mine[i])
            for block in blocks[s * per:(s + 1) * per]:
                state = block_fn(block, state)
            if s < pp - 1:
                group.send(s, i, state)
            else:
                outs[i] = state
    return group.dp_gather(group.broadcast_last(outs, mine), m_all)


def split_microbatches(*tensors: Tensor) -> List[State]:
    """The batch dim as the microbatch stream: (B, ...) tensors -> B states
    of (1, ...) slices."""
    return [tuple(t[i:i + 1] for t in tensors) for i in range(tensors[0].shape[0])]


def join_microbatches(states: List[State], k: int = 0) -> Tensor:
    """The k-th tensor of every microbatch state, concatenated on the batch dim."""
    return torch.cat([s[k] for s in states], dim=0)


# ---------------------------------------------------------------- placement


class StageElsewhere(nn.Module):
    """The placeholder of a block that another pipeline stage holds: it has
    no parameters, and calling it raises (a sequential run over a stack
    split across stages is a routing error, not a silent gather)."""

    def __init__(self, stack: str, index: int):
        super().__init__()
        self.stack, self.index = stack, index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"{self.stack}.{self.index} lives on another pipeline stage; a "
                           "stack split over the pp axis runs only through the GPipe schedule")


def stage_blocks(pp: int, stage: int, depths: Dict[str, int],
                 extra: Optional[Dict[str, Iterable[int]]] = None
                 ) -> Optional[Dict[str, frozenset]]:
    """{stack: block indices this stage holds} for the stacks GPipe runs:
    every stack of `depths` is split when pp divides all of them (they are
    one family's pipelined stacks, which its runner pipelines together, as
    JAX's _pp_applicable asks of FLUX), else none is (None: every rank holds
    every block). extra adds indices held on every stage (the TeaCache probe
    reads block 0's modulation)."""
    if pp <= 1 or not depths or any(d == 0 or d % pp for d in depths.values()):
        return None
    out = {}
    for name, d in depths.items():
        per = d // pp
        out[name] = frozenset(range(stage * per, (stage + 1) * per)) | frozenset(
            (extra or {}).get(name, ()))
    return out


def pipelined(pipe, *stacks: Sequence[nn.Module]) -> bool:
    """Whether the active pipeline runs these stacks through GPipe: pp > 1
    divides every stack's depth and no stack is empty (JAX's _pp_applicable
    without the caller's own conditions)."""
    if pipe is None or pipe.size <= 1:
        return False
    return all(len(s) and len(s) % pipe.size == 0 for s in stacks)
