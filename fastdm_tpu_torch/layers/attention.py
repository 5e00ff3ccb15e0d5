"""Joint (dual-stream) attention of the FLUX, SD3.5 and Qwen-Image blocks
(port of fastdm_tpu/layers/attention.py attention_apply and
qwen_attention_apply).

Fused-QKV projections, per-head RMSNorm on q/k (the rmsnorm kernel), the
context stream concatenated IN FRONT of the image stream, interleaved RoPE
(the rotembd kernel), flash attention (the sdpa kernel), then the split and
the output projections.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from fastdm_tpu_torch.kernels import rms_norm, rotary_pos_embedding, scaled_dot_product_attention
from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor


def _param(t: Optional[Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class JointAttention(nn.Module):
    """Parameters of one attention layer. qkv/add_qkv are the fused
    projections of the image and context streams; the FLUX single blocks hold
    only the q/k norms (their QKV comes out of the shared qkv_mlp matmul).
    tp: the tp group of a layer split by heads (parallel/tensor_parallel.py):
    its projections then hold heads / tp.size heads."""

    tp = None

    def __init__(self, *, qkv: Optional[QLinear] = None, add_qkv: Optional[QLinear] = None,
                 to_out: Optional[QLinear] = None, to_add_out: Optional[QLinear] = None,
                 norm_q: Optional[Tensor] = None, norm_k: Optional[Tensor] = None,
                 norm_added_q: Optional[Tensor] = None, norm_added_k: Optional[Tensor] = None):
        super().__init__()
        self.qkv, self.add_qkv = qkv, add_qkv
        self.to_out, self.to_add_out = to_out, to_add_out
        self.norm_q, self.norm_k = _param(norm_q), _param(norm_k)
        self.norm_added_q, self.norm_added_k = _param(norm_added_q), _param(norm_added_k)


def _qk_headnorm(x: Tensor, weight: Optional[Tensor], heads: int, eps: float,
                 tp=None) -> Tensor:
    """Per-head RMSNorm: (B, S, H*D) -> (B, S, H, D), normalize the last dim.
    Under tp the (D,) weight, replicated, serves only the rank's heads: under
    autograd it passes through tp_copy, so that its gradient sums every
    rank's heads."""
    if weight is None:
        return x
    if tp is not None:
        from fastdm_tpu_torch.parallel.tensor_parallel import tp_copy

        weight = tp_copy(weight, tp)
    b, s, hd = x.shape
    return rms_norm(x.reshape(b, s, heads, hd // heads), weight, eps).reshape(b, s, hd)


def attention_apply(
    attn: JointAttention, hidden_states: Tensor, encoder_hidden_states: Optional[Tensor], *,
    heads: int, head_dim: int, rope_cos: Optional[Tensor] = None,
    rope_sin: Optional[Tensor] = None, pre_only: bool = False,
    context_pre_only: bool = False, eps: float = 1e-6,
    qkv_override: Optional[Tensor] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Returns the attention output; with a context stream, the pair
    (image output, context output). qkv_override: a precomputed
    (B, S, 3*inner) fused-QKV projection (FLUX single blocks). heads is the
    model's count; a layer split by heads runs its own heads / tp.size."""
    if encoder_hidden_states is not None and attn.add_qkv is None:
        raise ValueError("encoder_hidden_states passed but the layer has no add_qkv "
                         "context projection — the joint split would be silently wrong")
    if attn.tp is not None:
        heads //= attn.tp.size
    inner = heads * head_dim
    qkv = qkv_override if qkv_override is not None else attn.qkv(hidden_states)
    q, k, v = qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
    q = _qk_headnorm(q, attn.norm_q, heads, eps, attn.tp)
    k = _qk_headnorm(k, attn.norm_k, heads, eps, attn.tp)

    if encoder_hidden_states is not None:
        ctx = attn.add_qkv(encoder_hidden_states)
        cq, ck, cv = ctx[..., :inner], ctx[..., inner:2 * inner], ctx[..., 2 * inner:]
        cq = _qk_headnorm(cq, attn.norm_added_q, heads, eps, attn.tp)
        ck = _qk_headnorm(ck, attn.norm_added_k, heads, eps, attn.tp)
        # context tokens go FIRST
        q = torch.cat([cq, q], dim=1)
        k = torch.cat([ck, k], dim=1)
        v = torch.cat([cv, v], dim=1)

    if rope_cos is not None:
        q, k = rotary_pos_embedding(q, k, head_dim, rope_cos, rope_sin, is_neox=False)

    out = scaled_dot_product_attention(q, k, v, heads, heads, head_dim, False, head_dim**-0.5)
    out = out.to(hidden_states.dtype)

    if encoder_hidden_states is not None:
        ctx_len = encoder_hidden_states.shape[1]
        ctx_out, img_out = out[:, :ctx_len], out[:, ctx_len:]
        if not context_pre_only:
            ctx_out = attn.to_add_out(ctx_out)
        if not pre_only:
            img_out = attn.to_out(img_out)
        return img_out, ctx_out
    if not pre_only:
        out = attn.to_out(out)
    return out


def qwen_attention_apply(attn: JointAttention, hidden_states: Tensor,
                         encoder_hidden_states: Tensor, *, heads: int, head_dim: int,
                         rope_cos: Tensor, rope_sin: Tensor,
                         eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """Qwen-Image joint attention: the joint branch of attention_apply in the
    same op order (text first, per-head q/k norms, interleaved RoPE over the
    joint sequence, both outputs projected), so it delegates. Returns
    (image output, text output)."""
    return attention_apply(attn, hidden_states, encoder_hidden_states, heads=heads,
                           head_dim=head_dim, rope_cos=rope_cos, rope_sin=rope_sin,
                           context_pre_only=False, eps=eps)
