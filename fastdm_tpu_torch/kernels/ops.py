"""Kernel-op interface: the ported ops (port of the rmsnorm, rotembd,
qk_norm_rope, qk_norm_rope2, gelu_and_mul, W8A8, W4A4, sdpa and the four
sparse-attention contracts of fastdm_tpu/kernels/ops.py:29-338), and
unpack_int4, the int4p weight unpack (fastdm_tpu/layers/qlinear.py:75-83),
which has a kernel of its own on the card, and w4a4_linear, the whole W4A4
branch of qlinear_apply (:280-291) as one op, whose kernels read the packed
weights at small M and take the low-rank branch into their epilogue.

The variants of the tensor-parallel path (parallel/tensor_parallel.py) have
no JAX op of their own (GSPMD partitions the whole-row ops there): the row
statistics and the given-statistics forms of the quantizers and of the
across-heads norms, and the f32 partial sums of the W8A8 / W4A4 GEMMs.

Same argument lists and semantics as the JAX ops: RoPE returns new (q, k)
instead of writing into its inputs, cos/sin are two (S, head_size/2) float32
tables, attention takes and returns the flattened-head (B, S, H*D) layout,
the W8A8 and W4A4 GEMMs take b as a (K, N) tensor (on the card a view of a
K-contiguous (N, K) buffer, see layers/qlinear.py).
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


@kernel_registry.dispatch("qk_norm_rope")
def qk_norm_rope(
    qk: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor], head_size: int,
    cos: Tensor, sin: Tensor, is_neox: bool = False, eps: float = 1e-6,
    inner_dim: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """RMSNorm(q) and RMSNorm(k) over the full width D (gamma (D,), None = no
    affine), each rounded to qk's dtype, then rotary embedding with the
    (S, head_size/2) float32 tables. qk: (B, S, 2D) [q|k], or the full
    (B, S, 3D) qkv with inner_dim=D (q and k are read in place). Returns
    (q, k), each (B, S, D) in qk's dtype."""
    raise NotImplementedError


@kernel_registry.dispatch("qk_norm_rope2")
def qk_norm_rope2(
    q: Tensor, k: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor],
    head_size: int, cos: Tensor, sin: Tensor, is_neox: bool = False, eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    """qk_norm_rope with q and k (B, S, D) as separate operands (the
    split-QKV projection path). Same semantics."""
    raise NotImplementedError


@kernel_registry.dispatch("gelu_and_mul")
def gelu_and_mul(x: Tensor) -> Tensor:
    """x[..., :d] * GELU(x[..., d:]) with d = x.shape[-1] // 2, exact (erf)
    GELU, f32 math, one cast back to x's dtype (bf16 or f32). The gate is the
    SECOND half, as in the reference. Returns (..., d)."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_to_int8")
def quantize_to_int8(x: Tensor, symmetric: bool = True
                     ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Per-token (row) int8 quantization of a 2D tensor.

    symmetric: scale = rowmax(|x|)/127, zp None.
    asymmetric: scale = (rowmax-rowmin)/255, zp = -128 - round(rowmin/scale).
    Scales are floored at 1e-12. Returns (q int8 (M,K), scale f32 (M,1),
    zp int32 (M,1) | None)."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_to_int4")
def quantize_to_int4(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-token symmetric int4 quantization of a 2D tensor: scale =
    max(rowmax(|x|), 1e-12)/7, q = clip(round(x/scale), -8, 7). Returns
    (q (M,K) int4-range values in an int8 carrier, scale f32 (M,1))."""
    raise NotImplementedError


@kernel_registry.dispatch("int4_matmul")
def int4_matmul(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                bias: Optional[Tensor] = None) -> Tensor:
    """W4A4 matmul, symmetric on both sides (no zero point): a (M,K) and b
    (K,N) int4-range values in int8 carriers, s32 accumulate,
    out = f32(a.b) * (scale_a (x) scale_b) + f32(bias), one cast to out_dtype."""
    raise NotImplementedError


@kernel_registry.dispatch("w4a4_linear")
def w4a4_linear(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                bias: Optional[Tensor], xu: Tensor, lora_v: Tensor) -> Tensor:
    """The W4A4 linear of an int4 / int4p QLinear (the JAX package's
    qlinear_apply branch, fastdm_tpu/layers/qlinear.py:280-291): b (K, N)
    int4 values in int8 carriers, or (K/2, N) packed pairs (pack_int4's halves
    layout), told apart by its shape; out = int4_matmul(a, b, scale_a,
    scale_b, out_dtype, bias) + (xu @ lora_v), the low-rank term rounded to
    bf16 and added in out_dtype, with xu = bf16(x) @ lora_u (M, r)."""
    raise NotImplementedError


@kernel_registry.dispatch("unpack_int4")
def unpack_int4(p: Tensor) -> Tensor:
    """Inverse of layers.qlinear.pack_int4: (..., K/2, N) int8 of packed
    nibbles (low = row k, high = row k + K/2) -> (..., K, N) int4-range
    values in int8 carriers, each sign-extended. On the card p is the (K/2, N)
    view of a contiguous (N, K/2) buffer and the result the (K, N) view of a
    fresh (N, K) buffer."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_to_fp8")
def quantize_to_fp8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-token float8_e4m3fn quantization: scale = rowmax(|x|)/448.
    Returns (q fp8 (M,K), scale f32 (M,1))."""
    raise NotImplementedError


@kernel_registry.dispatch("int8_matmul")
def int8_matmul(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                azp_adj: Tensor, azp: Optional[Tensor], bias: Optional[Tensor] = None
                ) -> Tensor:
    """W8A8 int8 matmul with asymmetric activation zero points.

    a: (M,K) int8 (per-token quantized), b: (K,N) int8 (per-channel sym).
    azp_adj: (N,) int32 column sums of b; azp: (M,1) int32 zero points.
    out = (a.b - azp (x) azp_adj) * (scale_a (x) scale_b) + bias, in out_dtype;
    the s32 accumulate is exact."""
    raise NotImplementedError


@kernel_registry.dispatch("fp8_matmul")
def fp8_matmul(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
               bias: Optional[Tensor] = None) -> Tensor:
    """(M,K) e4m3 @ (K,N) e4m3 with per-token (M,1) x per-channel (N,) f32
    scales, f32 accumulation: out = (a.b) * (scale_a (x) scale_b) + bias."""
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


@kernel_registry.dispatch("sdpa_lse")
def scaled_dot_product_attention_lse(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """Non-causal sdpa that also returns each query row's log-sum-exp of the
    scaled logits: (out (B, Sq, Hq*D) in query's dtype, lse (B, Hq, Sq)
    float32, -inf for a row that saw no key). The block of one K/V shard in
    the ring attention; blocks over disjoint key sets merge exactly as
    out = sum_i exp(lse_i - logaddexp_i lse_i) * out_i."""
    raise NotImplementedError


@kernel_registry.dispatch("sdpa_gather_super")
def gather_super_attention(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_valbits: Tensor,
    block_rows: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int,
    scale: Optional[float] = None, block_q: int = 512, group: int = 8, fine: int = 64,
    superblock: int = 4,
) -> Tensor:
    """Superblock gather-sparse attention over flattened-head layouts.

    Query rows [i*block_q, (i+1)*block_q) attend to the keys that table row i
    allows: block_rows[i] = [start, count] names the entries
    block_indices[start : start + count] (superblock ids; a superblock is the
    aligned run of `superblock` fine blocks of `fine` tokens) with
    block_valbits (bit j set = fine sub-block j is allowed). Segments are
    padded to a multiple of `group` entries (padding: valbits 0). Keys past
    the sequence end are never allowed; a query row that sees no key returns
    0. Tables: sparse.xsparse.RadialAttn.block_lists_super."""
    raise NotImplementedError


@kernel_registry.dispatch("sdpa_sparse")
def sparse_scaled_dot_product_attention(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int, num_kv_heads: int,
    head_dim: int, is_causal: bool = False, scale: Optional[float] = None,
    sparse_mask: Optional[Tensor] = None, block_q: int = 128, block_k: int = 128,
) -> Tensor:
    """Block-sparse attention over flattened-head layouts.

    sparse_mask: (B, num_q_heads, ceil(Sq/block_q), ceil(Skv/block_k)) int
    (or bool), one mask per batch entry and head: 1 computes the (block_q,
    block_k) tile, 0 skips it. A query row with no allowed key returns 0.
    sparse_mask=None is dense attention (the sdpa op). Tables:
    sparse.xsparse.RadialAttn.block_mask."""
    raise NotImplementedError


@kernel_registry.dispatch("sdpa_gather")
def gather_sparse_attention(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_counts: Tensor,
    num_q_heads: int, num_kv_heads: int, head_dim: int, scale: Optional[float] = None,
    block_q: int = 512, block_k: int = 1024,
) -> Tensor:
    """Gather-form block-sparse attention, one table for every batch entry
    and head: query rows [i*block_q, (i+1)*block_q) attend to the KV tiles
    block_indices[i, :block_counts[i, 0]] of block_k tokens (padding entries
    past the count are never computed). A query row with no allowed key
    returns 0. Tables: sparse.xsparse.RadialAttn.block_lists."""
    raise NotImplementedError


@kernel_registry.dispatch("sdpa_gather_fine")
def gather_fine_attention(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_valid: Tensor,
    block_rows: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int,
    scale: Optional[float] = None, block_q: int = 512, group: int = 8, fine: int = 64,
) -> Tensor:
    """Fine-granularity gather-sparse attention: query rows [i*block_q,
    (i+1)*block_q) attend to the fine KV blocks (`fine` tokens) of the
    entries block_indices[start : start + count], block_rows[i] = [start,
    count]; of fine block f an entry allows tokens [f*fine, f*fine +
    block_valid[e]). Segments are padded to a multiple of `group` entries
    (padding: valid 0). A query row with no allowed key returns 0. Tables:
    sparse.xsparse.RadialAttn.block_lists_fine."""
    raise NotImplementedError


# ------------------------------------------------------- tensor parallelism


@kernel_registry.dispatch("rms_sumsq")
def rms_sumsq(x: Tensor) -> Tensor:
    """Each row's sum of squares over the last dim in float32: x (..., D) ->
    (...). Rows may be strided views (the q|k columns of a fused projection
    as (B, S, 2, D)). Summed over the tp group, the whole row's statistic of
    an RMSNorm across heads."""
    raise NotImplementedError


@kernel_registry.dispatch("rmsnorm_given")
def rms_norm_given(x: Tensor, weight: Optional[Tensor], sumsq: Tensor, n_total: int,
                   eps: float) -> Tensor:
    """rms_norm with each row's statistic given: y = x / sqrt(sumsq / n_total +
    eps) * weight, sumsq (...) float32 over the whole row of n_total elements
    (x holds this rank's columns of it, weight their (D,) slice)."""
    raise NotImplementedError


@kernel_registry.dispatch("qk_norm_rope_given")
def qk_norm_rope_given(
    qk: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor], head_size: int,
    cos: Tensor, sin: Tensor, sumsq: Tensor, n_total: int, is_neox: bool = False,
    eps: float = 1e-6, inner_dim: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """qk_norm_rope with each token's (q, k) sums of squares given: sumsq (B,
    S, 2) float32 over the whole width n_total, of which qk's q and k hold
    this rank's heads (gamma_q / gamma_k their slices)."""
    raise NotImplementedError


@kernel_registry.dispatch("qk_norm_rope2_given")
def qk_norm_rope2_given(
    q: Tensor, k: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor],
    head_size: int, cos: Tensor, sin: Tensor, sumsq: Tensor, n_total: int,
    is_neox: bool = False, eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    """qk_norm_rope_given with q and k as separate (B, S, D) operands."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_stats")
def quantize_stats(x: Tensor, symmetric: bool = True) -> Tensor:
    """The statistics a per-token quantizer takes of each row of a 2D x:
    symmetric, (M, 1) float32 max|x|; asymmetric, (M, 2) float32 [-min, max].
    Either reduces over the row's shards by one MAX (they are exact)."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_to_int8_given")
def quantize_to_int8_given(x: Tensor, stats: Tensor, symmetric: bool = True
                           ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """quantize_to_int8 with each row's statistics given (quantize_stats'
    layout, reduced over the whole row): (q, scale, zp) bit-identical to the
    whole row's quantization restricted to x's columns."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_to_fp8_given")
def quantize_to_fp8_given(x: Tensor, stats: Tensor) -> Tuple[Tensor, Tensor]:
    """quantize_to_fp8 with each row's (M, 1) max|x| given."""
    raise NotImplementedError


@kernel_registry.dispatch("quantize_to_int4_given")
def quantize_to_int4_given(x: Tensor, stats: Tensor) -> Tuple[Tensor, Tensor]:
    """quantize_to_int4 with each row's (M, 1) max|x| given."""
    raise NotImplementedError


@kernel_registry.dispatch("int8_matmul_partial")
def int8_matmul_partial(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor,
                        azp_adj: Tensor, azp: Optional[Tensor]) -> Tensor:
    """A row-parallel rank's int8_matmul: the float32 (M, N) partial
    (a.b - azp (x) azp_adj) * (scale_a (x) scale_b), no bias, no rounding;
    azp_adj is the column sum of this rank's K rows of b."""
    raise NotImplementedError


@kernel_registry.dispatch("fp8_matmul_partial")
def fp8_matmul_partial(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor) -> Tensor:
    """A row-parallel rank's fp8_matmul: the float32 partial, no bias."""
    raise NotImplementedError


@kernel_registry.dispatch("int4_matmul_partial")
def int4_matmul_partial(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor) -> Tensor:
    """A row-parallel rank's int4_matmul: the float32 partial, no bias."""
    raise NotImplementedError
