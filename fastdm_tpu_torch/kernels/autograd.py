"""Gradients of the kernel ops that LoRA training differentiates: rmsnorm,
rotembd and sdpa, as torch.autograd.Functions (the counterparts of XLA's
derivatives of rms_norm_jnp, _rotate / rotary_pos_embedding_jnp and sdpa_jnp,
fastdm_tpu/kernels/jnp_backend/impl.py:20, :29 / :101, :249, which
examples/lora-train/train.py:25 differentiates by routing every op to jnp).

Each Function's forward is the op itself (kernels/ops.py): on the card the
hand-written kernel, on the CPU its plain version. Its backward is
device-independent PyTorch: the TPU kernels have no backward kernel, so the
products stay torch.matmul, as JAX leaves them to XLA. The registry
(kernels/registry.py) routes an op here when grad mode is on and one of its
tensor arguments requires a gradient; the serving path keeps the plain
dispatch (sdpa, not sdpa_lse).

  RMSNormFn: forward rmsnorm; backward in f32,
             dx = rstd * (g*w - x_hat * mean(g*w*x_hat)), dw = sum(g*x_hat).
  RotaryFn:  forward rotembd; the rotation is linear and orthogonal, so its
             transpose is the same op with sin negated: on the card the
             backward is the rotembd kernel again.
  SDPAFn:    forward sdpa_lse (its output bit-identical to sdpa's, plus each
             row's f32 log-sum-exp); the backward recomputes the
             probabilities from the log-sum-exp a chunk of heads at a time
             (no (B, H, Sq, Skv) tensor for every head at once). Causal
             attention with a gradient raises: nothing in the port trains
             causally and the sdpa_lse kernel is non-causal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastdm_tpu_torch.kernels.ops import (
    rms_norm,
    rotary_pos_embedding,
    scaled_dot_product_attention_lse,
)
from fastdm_tpu_torch.kernels.registry import kernel_registry

Tensor = torch.Tensor

# the f32 (probabilities, their gradient) working set of one chunk of heads in
# the sdpa backward: 12 of FLUX's 24 heads at 1152 tokens
SDPA_BWD_CHUNK_BYTES = 64 << 20


class RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, weight: Optional[Tensor], eps: float) -> Tensor:
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, g: Tensor):
        x, weight = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + ctx.eps)
        x_hat = x32 * rstd
        gw = g32 if weight is None else g32 * weight.float()
        dx = rstd * (gw - x_hat * (gw * x_hat).mean(dim=-1, keepdim=True))
        dw = None
        if weight is not None and ctx.needs_input_grad[1]:
            dw = (g32 * x_hat).reshape(-1, x.shape[-1]).sum(dim=0).reshape(weight.shape)
            dw = dw.to(weight.dtype)
        return dx.to(x.dtype), dw, None


class RotaryFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query: Tensor, key: Tensor, head_size: int, cos: Tensor, sin: Tensor,
                is_neox: bool) -> Tuple[Tensor, Tensor]:
        ctx.save_for_backward(cos, sin)
        ctx.head_size, ctx.is_neox = head_size, is_neox
        return rotary_pos_embedding(query, key, head_size, cos, sin, is_neox)

    @staticmethod
    def backward(ctx, gq: Tensor, gk: Tensor):
        cos, sin = ctx.saved_tensors
        dq, dk = rotary_pos_embedding(gq.contiguous(), gk.contiguous(), ctx.head_size, cos,
                                      -sin, ctx.is_neox)
        return dq, dk, None, None, None, None


class SDPAFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
                num_kv_heads: int, head_dim: int, scale: float) -> Tensor:
        out, lse = scaled_dot_product_attention_lse(query, key, value, num_q_heads,
                                                    num_kv_heads, head_dim, scale)
        ctx.save_for_backward(query, key, value, out, lse)
        ctx.dims = (num_q_heads, num_kv_heads, head_dim, scale)
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = sdpa_backward(dout, q, k, v, out, lse, *ctx.dims)
        return dq, dk, dv, None, None, None, None


def _heads(t: Tensor, h0: int, h1: int, n: int, group: int) -> Tensor:
    """Heads [h0, h1) of a (B, S, H, D) tensor as f32 (B, (h1-h0)/group,
    group, S, D)."""
    b, s, _, d = t.shape
    return t[:, :, h0:h1].float().permute(0, 2, 1, 3).reshape(b, n, group, s, d)


def sdpa_delta(dout: Tensor, out: Tensor, num_q_heads: int) -> Tensor:
    """D = rowsum(dO * O) in f32, (B, Hq, Sq), of flattened-head dO and O."""
    b, sq, _ = out.shape
    return (dout.float() * out.float()).reshape(b, sq, num_q_heads, -1).sum(dim=-1) \
        .permute(0, 2, 1)


def sdpa_backward(dout: Tensor, q: Tensor, k: Tensor, v: Tensor, out: Optional[Tensor],
                  lse: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int, scale: float,
                  chunk_bytes: int = SDPA_BWD_CHUNK_BYTES, *, delta: Optional[Tensor] = None,
                  grad_dtype=None) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of non-causal sdpa in the flattened-head layout, from the
    saved inputs, output and f32 log-sum-exp (B, Hq, Sq): D = rowsum(dO*O),
    P = exp(scale*QK^T - lse), dV = P^T dO with P rounded to v's dtype (as
    sdpa_jnp rounds it, impl.py:278), dP = dO V^T, dS = P*(dP - D),
    dQ = scale*dS K, dK = scale*dS^T Q; a KV head sums over the query heads
    it serves (GQA). f32 math, one cast to each input's dtype (to grad_dtype
    when given); KV heads in chunks of at most chunk_bytes of f32
    probabilities.

    With delta (sdpa_delta of the whole attention's dO and O) and lse the
    whole attention's log-sum-exp, k and v may be one block of its keys:
    the result is that block's exact part of the gradients (the ring's
    backward, parallel/context_parallel.py). A row whose lse is +inf has
    P = 0."""
    b, sq, _ = q.shape
    skv = k.shape[1]
    rep = num_q_heads // num_kv_heads
    q4, do4 = (t.reshape(b, sq, num_q_heads, head_dim) for t in (q, dout))
    o4 = None if delta is not None else out.reshape(b, sq, num_q_heads, head_dim)
    k4, v4 = (t.reshape(b, skv, num_kv_heads, head_dim) for t in (k, v))
    dq = torch.empty(b, sq, num_q_heads, head_dim, dtype=grad_dtype or q.dtype, device=q.device)
    dk = torch.empty(b, skv, num_kv_heads, head_dim, dtype=grad_dtype or k.dtype,
                     device=k.device)
    dv = torch.empty(b, skv, num_kv_heads, head_dim, dtype=grad_dtype or v.dtype,
                     device=v.device)
    per_kv_head = b * rep * sq * skv * 4
    step = max(1, min(num_kv_heads, chunk_bytes // max(1, per_kv_head)))
    for j0 in range(0, num_kv_heads, step):
        j1 = min(num_kv_heads, j0 + step)
        n, h0, h1 = j1 - j0, j0 * rep, j1 * rep
        qc, doc = (_heads(t, h0, h1, n, rep) for t in (q4, do4))
        kc, vc = (_heads(t, j0, j1, n, 1) for t in (k4, v4))
        lc = lse[:, h0:h1].float().reshape(b, n, rep, sq, 1)
        if delta is None:
            delta_c = (doc * _heads(o4, h0, h1, n, rep)).sum(dim=-1, keepdim=True)
        else:
            delta_c = delta[:, h0:h1].reshape(b, n, rep, sq, 1)
        p = torch.exp(torch.matmul(qc, kc.transpose(-1, -2)) * scale - lc)
        dvc = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), doc).sum(dim=2)
        ds = p.mul_(torch.matmul(doc, vc.transpose(-1, -2)).sub_(delta_c))
        dqc = torch.matmul(ds, kc).mul_(scale)
        dkc = torch.matmul(ds.transpose(-1, -2), qc).sum(dim=2).mul_(scale)
        dq[:, :, h0:h1] = dqc.reshape(b, n * rep, sq, head_dim).permute(0, 2, 1, 3)
        dk[:, :, j0:j1] = dkc.permute(0, 2, 1, 3)
        dv[:, :, j0:j1] = dvc.permute(0, 2, 1, 3)
        del qc, doc, kc, vc, p, ds, dqc, dkc, dvc
    return dq.reshape(b, sq, -1), dk.reshape(b, skv, -1), dv.reshape(b, skv, -1)


@kernel_registry.register_grad("rmsnorm")
def rms_norm_grad(x: Tensor, weight: Optional[Tensor], eps: float) -> Tensor:
    return RMSNormFn.apply(x, weight, eps)


@kernel_registry.register_grad("rotembd")
def rotary_pos_embedding_grad(query: Tensor, key: Tensor, head_size: int, cos: Tensor,
                              sin: Tensor, is_neox: bool = False) -> Tuple[Tensor, Tensor]:
    return RotaryFn.apply(query, key, head_size, cos, sin, is_neox)


@kernel_registry.register_grad("sdpa")
def scaled_dot_product_attention_grad(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int, num_kv_heads: int,
    head_dim: int, is_causal: bool = False, scale: Optional[float] = None,
) -> Tensor:
    if is_causal:
        raise NotImplementedError("causal sdpa has no gradient in the port: the sdpa_lse kernel "
                                  "is non-causal and nothing in the port trains causally")
    return SDPAFn.apply(query, key, value, num_q_heads, num_kv_heads, head_dim,
                        head_dim**-0.5 if scale is None else scale)
