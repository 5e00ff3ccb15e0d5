"""Plain PyTorch versions of the slice's ops (port of
fastdm_tpu/kernels/jnp_backend/impl.py: rms_norm_jnp :19-26, _rotate and
rotary_pos_embedding_jnp :29-54/:100-114, sdpa_jnp :248-280).

They keep the oracle's rounding points — float32 math, one cast back to the
input dtype — so the CPU tests can hold them to the JAX package, and
chip_smoke.py holds each Hopper kernel to them on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastdm_tpu_torch.kernels import contracts
from fastdm_tpu_torch.kernels.registry import kernel_registry

Tensor = torch.Tensor


@kernel_registry.register("rmsnorm", "torch")
def rms_norm_torch(x: Tensor, weight: Optional[Tensor], eps: float) -> Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _rotate(x: Tensor, cos: Tensor, sin: Tensor, is_neox: bool) -> Tensor:
    # x: (B, S, H, D); cos/sin: (S, D/2) f32. Slice in the input dtype, upcast
    # the halves, round each product back once (impl.py:29-54).
    cos = cos.float()[None, :, None, :]
    sin = sin.float()[None, :, None, :]
    if is_neox:
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2], x[..., d2:]
    else:
        x1, x2 = x[..., 0::2], x[..., 1::2]
    x1 = x1.float()
    x2 = x2.float()
    o1 = (x1 * cos - x2 * sin).to(x.dtype)
    o2 = (x2 * cos + x1 * sin).to(x.dtype)
    if is_neox:
        return torch.cat([o1, o2], dim=-1)
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


@kernel_registry.register("rotembd", "torch")
def rotary_pos_embedding_torch(
    query: Tensor, key: Tensor, head_size: int, cos: Tensor, sin: Tensor,
    is_neox: bool = False,
) -> Tuple[Tensor, Tensor]:
    qs, ks = query.shape, key.shape
    q4 = _rotate(query.reshape(qs[0], qs[1], -1, head_size), cos, sin, is_neox)
    k4 = _rotate(key.reshape(ks[0], ks[1], -1, head_size), cos, sin, is_neox)
    return q4.reshape(qs), k4.reshape(ks)


@kernel_registry.register("sdpa", "torch")
def sdpa_torch(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, is_causal: bool = False,
    scale: Optional[float] = None,
) -> Tensor:
    contracts.check_sdpa("sdpa_torch", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    b, sq, _ = query.shape
    skv = key.shape[1]
    q = query.reshape(b, sq, num_q_heads, head_dim)
    k = key.reshape(b, skv, num_kv_heads, head_dim)
    v = value.reshape(b, skv, num_kv_heads, head_dim)
    rep = num_q_heads // num_kv_heads
    if scale is None:
        scale = head_dim**-0.5
    mask = None
    if is_causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=query.device).tril(skv - sq)
    out = torch.empty(b, sq, num_q_heads, head_dim, dtype=query.dtype, device=query.device)
    # one head at a time: the same math as the all-heads einsum of sdpa_jnp,
    # with the (Sq, Skv) float32 logits of a single head alive at once
    for h in range(num_q_heads):
        kh, vh = k[:, :, h // rep].float(), v[:, :, h // rep]
        logits = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), kh) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        out[:, :, h] = torch.einsum(
            "bqk,bkd->bqd", probs.to(vh.dtype).float(), vh.float()).to(query.dtype)
    return out.reshape(b, sq, num_q_heads * head_dim)
