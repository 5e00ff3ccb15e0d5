"""Kernel-op interface: the ops of this slice (port of the rmsnorm, rotembd
and sdpa contracts of fastdm_tpu/kernels/ops.py:29-60, :216).

Same argument lists and semantics as the JAX ops: RoPE returns new (q, k)
instead of writing into its inputs, cos/sin are two (S, head_size/2) float32
tables, attention takes and returns the flattened-head (B, S, H*D) layout.
Each call dispatches on the device of its first tensor (see registry.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastdm_tpu_torch.kernels.registry import kernel_registry

Tensor = torch.Tensor


@kernel_registry.dispatch("rmsnorm")
def rms_norm(x: Tensor, weight: Optional[Tensor], eps: float) -> Tensor:
    """RMS-normalize ``x`` over its last dim, then multiply by ``weight``
    (None = no affine). Math in float32, one cast back to x's dtype."""
    raise NotImplementedError


@kernel_registry.dispatch("rotembd")
def rotary_pos_embedding(
    query: Tensor, key: Tensor, head_size: int, cos: Tensor, sin: Tensor,
    is_neox: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Apply rotary embedding to query (B, S, Hq*D) and key (B, S, Hkv*D).

    cos, sin: (S, head_size // 2) float32, one entry per rotation pair.
    is_neox=False (interleaved): pairs are (x[..., 0::2], x[..., 1::2]);
    is_neox=True (half-split):   pairs are (x[..., :d/2], x[..., d/2:]).
    Returns rotated (query, key) in the input dtype."""
    raise NotImplementedError


@kernel_registry.dispatch("sdpa")
def scaled_dot_product_attention(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, is_causal: bool = False,
    scale: Optional[float] = None,
) -> Tensor:
    """Attention over flattened-head layouts: query (B, Sq, Hq*D), key/value
    (B, Skv, Hkv*D), GQA when Hkv < Hq. Returns (B, Sq, Hq*D)."""
    raise NotImplementedError
