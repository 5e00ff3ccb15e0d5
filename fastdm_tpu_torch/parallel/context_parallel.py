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
                   scale: Optional[float] = None) -> Tensor:
    """One rank's exact attention of its query shard (B, s, Hq*D) over the n
    K/V shards of the ring: the shard it holds first, then n - 1 more, each
    handed over by rotate while the block of the current one runs. The
    blocks merge in f32 (JAX starts from m = -1e30, l = 0; here -inf with the
    guard of _merge); one cast to the query's dtype at the end."""
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
    return acc.to(query.dtype).view(b, s, num_q_heads * head_dim)


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
    local = kernel_registry.select("sdpa", query.device, routed=False)
    b, sq, _ = query.shape
    n = ring.size
    if sq % n:
        # a query stream sp does not divide (odd joint lengths): one device
        return local(query, key, value, num_q_heads, num_kv_heads, head_dim, False, scale)
    s = sq // n

    def shard(t: Tensor, r: int) -> Tensor:
        return t[:, r * s:(r + 1) * s]

    outs = []
    for r in ring.local_ranks():
        if sq == key.shape[1]:
            def shards(i: int) -> KV:
                return shard(key, i), shard(value, i)

            outs.append(ring_attention(shard(query, r), *shards(r), n, ring.rotator(r, shards),
                                       num_q_heads, num_kv_heads, head_dim, scale))
        else:
            # cross-attention: K/V whole on every rank, the query shard local
            outs.append(local(shard(query, r), key, value, num_q_heads, num_kv_heads,
                              head_dim, False, scale))
    return ring.gather(outs)


kernel_registry.register("sdpa", "ring")(sdpa_ring)
