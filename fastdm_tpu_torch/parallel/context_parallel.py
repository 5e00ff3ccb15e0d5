"""Context parallelism: ring attention over the mesh's sp axis (port of
fastdm_tpu/parallel/context_parallel.py:25-192).

sdpa_ring is the route of the dense sdpa op while a ring is active
(cp_state; kernels/registry.py). For self-attention (sq == skv) each rank
takes its query shard and the K/V shard of its own index; the K/V shards
rotate round the ring for n - 1 steps (dist.batch_isend_irecv, only the kv
heads travel: the sdpa kernel reads query head h from kv head h / (hq/hkv),
so GQA needs no repeat at all), each step's block runs on the sdpa kernel
with its per-row log-sum-exp (the sdpa_lse op), and the blocks merge under
an online softmax in f32 with one cast at the end. For cross-attention (sq
!= skv) K/V stay whole and each rank runs sdpa on its query shard. A query
length that sp does not divide runs the one-device sdpa, as JAX does
(:152-157); causal attention raises, as in JAX. Each rank's output shard is
all-gathered, so the activations between attention calls stay whole on
every rank: the JAX engine shards only the weights, and its shard_map
gathers the output to the replicated layout in the same way.

The per-rank loop, ring_attention, takes its rotation as a parameter: a
GroupRing posts the P2P transfers over the sp process group; a VirtualRing
runs its n ranks one after another in this process, each reading the next
K/V shard from a list (chip_smoke.py drives it at full width on one card).

Under autograd (the registry sends sdpa here with a gradient) the ring is a
Function: its forward is ring_attention, which also keeps each row's merged
f32 log-sum-exp (m + log l); its backward is the ring-attention backward.
D = rowsum(dO O) once a rank; at each step the rank adds its block's dQ
and computes the block's dK and dV against the merged log-sum-exp
(kernels/autograd.py sdpa_backward: P_blk = exp(scale Q K_blk^T - lse) is
the block's exact share), into f32 accumulators that travel round the ring
with their K / V shard and end, one hop after the last step, at the shard's
owner; then dQ, dK and dV are all-gathered whole (q, k and v are whole on
every rank). Cross-attention differentiates each query shard's sdpa (the
registry's Function) between two more: _RingCopy on q, k and v (backward:
the gradient summed over the ring, which all-gathers dQ and sums dK and dV)
and _RingGather on the outputs (backward: each rank's slice).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from fastdm_tpu_torch.kernels.registry import kernel_registry
from fastdm_tpu_torch.parallel import cp_state

Tensor = torch.Tensor
KV = Tuple[Tensor, Tensor]
# rotate(k, v, step) -> wait, where wait() gives the K/V shard of step + 1
Rotate = Callable[[Tensor, Tensor, int], Callable[[], KV]]


def _merge(acc: Tensor, m_run: Tensor, l_run: Tensor, out: Tensor, lse: Tensor):
    """One block into the online softmax: acc (B, s, H, D), m_run / l_run (B,
    s, H, 1) f32; out (B, s, H*D) normalized over the block's keys, lse (B,
    H, s) its rows' log-sum-exp. A block's unnormalized sums are exp(lse) *
    out, so acc gathers exp(lse - m) * out and l exp(lse - m) against the
    running maximum m. A row with no mass yet (m = -inf) subtracts 0, so
    exp(-inf - -inf) never makes a NaN."""
    b, s, h, d = acc.shape
    lse = lse.permute(0, 2, 1).unsqueeze(-1)
    m_new = torch.maximum(m_run, lse)
    base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
    alpha, beta = torch.exp(m_run - base), torch.exp(lse - base)
    acc.mul_(alpha).add_(out.view(b, s, h, d).float() * beta)
    return m_new, l_run * alpha + beta


def ring_attention(query: Tensor, key: Tensor, value: Tensor, n: int, rotate: Rotate,
                   num_q_heads: int, num_kv_heads: int, head_dim: int,
                   scale: Optional[float] = None, with_lse: bool = False):
    """One rank's exact attention of its query shard (B, s, Hq*D) over the n
    K/V shards of the ring: the shard it holds first, then n - 1 more, each
    handed over by rotate while the block of the current one runs. The
    blocks merge in f32 (JAX starts from m = -1e30, l = 0; here -inf with the
    guard of _merge); one cast to the query's dtype at the end. with_lse:
    (output, the merged f32 log-sum-exp (B, Hq, s)), +inf on a row without
    mass (so that the backward's probabilities there are 0, not NaN)."""
    from fastdm_tpu_torch.kernels import scaled_dot_product_attention_lse

    b, s, _ = query.shape
    acc = torch.zeros(b, s, num_q_heads, head_dim, dtype=torch.float32, device=query.device)
    m_run = torch.full((b, s, num_q_heads, 1), float("-inf"), device=query.device)
    l_run = torch.zeros((b, s, num_q_heads, 1), device=query.device)
    k, v = key, value
    for step in range(n):
        wait = rotate(k, v, step) if step < n - 1 else None
        out, lse = scaled_dot_product_attention_lse(query, k, v, num_q_heads, num_kv_heads,
                                                    head_dim, scale)
        m_run, l_run = _merge(acc, m_run, l_run, out, lse)
        del out, lse
        if wait is not None:
            k, v = wait()
    acc.div_(l_run.clamp_min(1e-20))
    out = acc.to(query.dtype).view(b, s, num_q_heads * head_dim)
    if not with_lse:
        return out
    lse = torch.where(l_run > 0, m_run + torch.log(l_run), float("inf"))
    return out, lse.squeeze(-1).permute(0, 2, 1).contiguous()


class GroupRing:
    """The ring over a torch.distributed process group (a mesh.Axis): this
    process is rank axis.rank of axis.size; a shard passes from rank i to
    rank i + 1, as JAX's ppermute does."""

    def __init__(self, axis):
        self.axis = axis
        self.size = axis.size

    def local_ranks(self) -> Sequence[int]:
        return (self.axis.rank,)

    def rotator(self, rank: int, shards: Callable[[int], KV]) -> Rotate:
        import torch.distributed as dist

        ranks, n, group = self.axis.ranks, self.size, self.axis.group
        nxt, prev = ranks[(rank + 1) % n], ranks[(rank - 1) % n]

        def rotate(k: Tensor, v: Tensor, step: int):
            k, v = k.contiguous(), v.contiguous()
            k_in, v_in = torch.empty_like(k), torch.empty_like(v)
            # every rank posts its sends, then its receives, in one order
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.isend, v, nxt, group),
                dist.P2POp(dist.irecv, k_in, prev, group),
                dist.P2POp(dist.irecv, v_in, prev, group)])

            def wait() -> KV:
                for r in reqs:
                    r.wait()
                return k_in, v_in

            return wait

        return rotate

    def gather(self, outs: List[Tensor]) -> Tensor:
        import torch.distributed as dist

        (out,) = outs
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(self.size)]
        dist.all_gather(parts, out, group=self.axis.group)
        return torch.cat(parts, dim=1)

    def shift(self, states: List[List[Tensor]]) -> List[List[Tensor]]:
        """This rank's tensors to the next rank, the previous rank's here:
        every rank posts its sends, then its receives, in one order."""
        import torch.distributed as dist

        (state,) = states
        ranks, n, group, r = self.axis.ranks, self.size, self.axis.group, self.axis.rank
        nxt, prev = ranks[(r + 1) % n], ranks[(r - 1) % n]
        state = [t.contiguous() for t in state]
        got = [torch.empty_like(t) for t in state]
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in state]
        ops += [dist.P2POp(dist.irecv, t, prev, group) for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]

    def reduce(self, t: Tensor) -> Tensor:
        """The sum over the ring's processes of t (this rank's part), whole
        on every rank."""
        import torch.distributed as dist

        t = t.contiguous().clone()
        dist.all_reduce(t, group=self.axis.group)
        return t


class VirtualRing:
    """n ranks of a ring run one after another in this process: rank r's
    shard of step t is shard (r - t) mod n, as on the real ring."""

    def __init__(self, n: int):
        self.size = n

    def local_ranks(self) -> Sequence[int]:
        return range(self.size)

    def rotator(self, rank: int, shards: Callable[[int], KV]) -> Rotate:
        n = self.size

        def rotate(k: Tensor, v: Tensor, step: int):
            return lambda: shards((rank - step - 1) % n)

        return rotate

    def gather(self, outs: List[Tensor]) -> Tensor:
        return torch.cat(outs, dim=1)

    def shift(self, states: List[List[Tensor]]) -> List[List[Tensor]]:
        return [states[(r - 1) % self.size] for r in range(self.size)]

    def reduce(self, t: Tensor) -> Tensor:
        return t  # every rank is in this process: t already sums them


def _shard(t: Tensor, r: int, s: int) -> Tensor:
    return t[:, r * s:(r + 1) * s]


def _self_ring(query: Tensor, key: Tensor, value: Tensor, ring, num_q_heads: int,
               num_kv_heads: int, head_dim: int, scale: Optional[float], with_lse: bool) -> list:
    """ring_attention of each of this process's ranks of the ring, in order."""
    n, s = ring.size, query.shape[1] // ring.size

    def shards(i: int) -> KV:
        return _shard(key, i, s), _shard(value, i, s)

    return [ring_attention(_shard(query, r, s), *shards(r), n, ring.rotator(r, shards),
                           num_q_heads, num_kv_heads, head_dim, scale, with_lse)
            for r in ring.local_ranks()]


class _RingSDPA(torch.autograd.Function):
    """Self-attention over the ring (sq == skv, sp dividing it)."""

    @staticmethod
    def forward(ctx, query: Tensor, key: Tensor, value: Tensor, ring, num_q_heads: int,
                num_kv_heads: int, head_dim: int, scale: float) -> Tensor:
        outs, lses = zip(*_self_ring(query, key, value, ring, num_q_heads, num_kv_heads,
                                     head_dim, scale, True))
        out = ring.gather(list(outs))
        ctx.save_for_backward(query, key, value, out, *lses)
        ctx.ring, ctx.dims = ring, (num_q_heads, num_kv_heads, head_dim, scale)
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        from fastdm_tpu_torch.kernels.autograd import sdpa_backward, sdpa_delta

        query, key, value, out, *lses = ctx.saved_tensors
        ring, (hq, hkv, d, scale) = ctx.ring, ctx.dims
        n, s = ring.size, query.shape[1] // ring.size
        ranks = list(ring.local_ranks())
        qs = [_shard(query, r, s) for r in ranks]
        dos = [_shard(dout, r, s) for r in ranks]
        deltas = [sdpa_delta(do, _shard(out, r, s), hq) for do, r in zip(dos, ranks)]
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
        # each rank starts with its own K / V shard and that shard's accumulators
        states = []
        for r in ranks:
            k, v = _shard(key, r, s), _shard(value, r, s)
            states.append([k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                           torch.zeros(v.shape, dtype=torch.float32, device=v.device)])
        for step in range(n):
            for i in range(len(ranks)):
                k, v, dk, dv = states[i]
                dq_b, dk_b, dv_b = sdpa_backward(dos[i], qs[i], k, v, None, lses[i], hq, hkv, d,
                                                 scale, delta=deltas[i],
                                                 grad_dtype=torch.float32)
                dqs[i] += dq_b
                dk += dk_b
                dv += dv_b
                del dq_b, dk_b, dv_b
            if step < n - 1:
                states = ring.shift(states)
        accs = [st[2:] for st in states]
        if n > 1:
            # rank r holds shard r + 1's accumulators: one hop to their owner
            accs = ring.shift(accs)
        dq = ring.gather([t.to(query.dtype) for t in dqs])
        dk = ring.gather([dk.to(key.dtype) for dk, _ in accs])
        dv = ring.gather([dv.to(value.dtype) for _, dv in accs])
        return dq, dk, dv, None, None, None, None, None


class _RingCopy(torch.autograd.Function):
    """t itself, whole on every rank; its gradient, which each rank's shard
    of the work gives a part of, summed over the ring."""

    @staticmethod
    def forward(ctx, t: Tensor, ring) -> Tensor:
        ctx.ring = ring
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: Tensor):
        return ctx.ring.reduce(g), None


class _RingGather(torch.autograd.Function):
    """This process's ranks' outputs gathered whole along the tokens; each
    rank's gradient is its slice."""

    @staticmethod
    def forward(ctx, ring, *outs: Tensor) -> Tensor:
        ctx.ring = ring
        return ring.gather(list(outs))

    @staticmethod
    def backward(ctx, g: Tensor):
        ring = ctx.ring
        s = g.shape[1] // ring.size
        return (None, *(_shard(g, r, s) for r in ring.local_ranks()))


def sdpa_ring(query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
              num_kv_heads: int, head_dim: int, is_causal: bool = False,
              scale: Optional[float] = None, ring=None) -> Tensor:
    """The sdpa op with the sequence sharded over the active ring (cp_state,
    or `ring`): the flattened-head contract of sdpa, the whole (B, Sq,
    Hq*D) output on every rank."""
    from fastdm_tpu_torch.kernels import contracts

    ring = ring if ring is not None else cp_state.get_cp_ring()
    if is_causal:
        raise NotImplementedError("ring sdpa is non-causal (diffusion attention)")
    if ring is None:
        raise RuntimeError("sdpa_ring needs an active ring (cp_state.set_cp_ring)")
    contracts.check_sdpa("sdpa_ring", query, key, value, num_q_heads, num_kv_heads, head_dim)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value))
    sq, n = query.shape[1], ring.size
    if sq % n:
        # a query stream sp does not divide (odd joint lengths): one device
        local = (kernel_registry.select_grad("sdpa", query, routed=False) if grad
                 else kernel_registry.select("sdpa", query.device, routed=False))
        return local(query, key, value, num_q_heads, num_kv_heads, head_dim, False, scale)
    if sq == key.shape[1]:
        if grad:
            return _RingSDPA.apply(query, key, value, ring, num_q_heads, num_kv_heads, head_dim,
                                   head_dim**-0.5 if scale is None else scale)
        return ring.gather(_self_ring(query, key, value, ring, num_q_heads, num_kv_heads,
                                      head_dim, scale, False))
    # cross-attention: K/V whole on every rank, the query shard local
    s = sq // n
    if grad:
        local = kernel_registry.select_grad("sdpa", query, routed=False)
        query, key, value = (_RingCopy.apply(t, ring) for t in (query, key, value))
        return _RingGather.apply(ring, *(local(_shard(query, r, s), key, value, num_q_heads,
                                               num_kv_heads, head_dim, False, scale)
                                         for r in ring.local_ranks()))
    local = kernel_registry.select("sdpa", query.device, routed=False)
    return ring.gather([local(_shard(query, r, s), key, value, num_q_heads, num_kv_heads,
                              head_dim, False, scale) for r in ring.local_ranks()])


kernel_registry.register("sdpa", "ring")(sdpa_ring)
