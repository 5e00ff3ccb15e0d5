"""Plain PyTorch versions of the ported ops (port of
fastdm_tpu/kernels/jnp_backend/impl.py: rms_norm_jnp :19-26, _rotate and
rotary_pos_embedding_jnp :29-54/:100-114, qk_norm_rope_jnp and
qk_norm_rope2_jnp :57-97, gelu_and_mul_jnp :117-120, quantize_to_int8_jnp
:123-140, quantize_to_int4_jnp :143-162, int4_matmul_jnp :163-188,
quantize_to_fp8_jnp :191-197, fp8_matmul_jnp :200-218,
int8_matmul_jnp :221-240, sdpa_jnp
:248-280, sdpa_gather_jnp :283-311, sdpa_gather_fine_jnp :314-370,
sdpa_gather_super_jnp :373-437, sdpa_sparse_jnp :440-486; and the int4p
weight unpack of fastdm_tpu/layers/qlinear.py unpack_int4 :75-83).

They keep the oracle's rounding points — float32 math, one cast back to the
input dtype — so the CPU tests can hold them to the JAX package, and
chip_smoke.py holds each Hopper kernel to them on the card. The W8A8 and
W4A4 versions are bit-exact with jnp wherever the math is integer: the int8
(and int4) product is taken in float64, where every partial sum of s8*s8
products over K <= 2^38 is an integer below 2^53 and therefore exact in any
summation order (torch has no integer matmul on CUDA, and int8 @ int8 on the
CPU wraps in int8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fastdm_tpu_torch.kernels import contracts
from fastdm_tpu_torch.kernels.registry import kernel_registry

Tensor = torch.Tensor

_EPS_SCALE = 1e-12  # scale floor of the jnp oracle (impl.py:16)
_FP8_MAX = 448.0    # float8_e4m3fn finfo.max


def true_div(x: Tensor, c: float) -> Tensor:
    """x / c correctly rounded on every device. PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is one ulp off for
    c = 127, 255 or 448 on some inputs; a 0-dim tensor divisor is divided."""
    return x / x.new_full((), c)


def _to_int32_saturating(x: Tensor) -> Tensor:
    """float -> int32 as XLA and the card's cvt do it: out-of-range values
    clamp to the int32 range, NaN becomes 0 (a plain .to(int32) is undefined
    there)."""
    return x.double().nan_to_num(0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int32)


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


@kernel_registry.register("qk_norm_rope", "torch")
def qk_norm_rope_torch(
    qk: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor], head_size: int,
    cos: Tensor, sin: Tensor, is_neox: bool = False, eps: float = 1e-6,
    inner_dim: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    d = qk.shape[-1] // 2 if inner_dim is None else inner_dim
    return qk_norm_rope2_torch(qk[..., :d], qk[..., d:2 * d], gamma_q, gamma_k, head_size,
                               cos, sin, is_neox, eps)


@kernel_registry.register("qk_norm_rope2", "torch")
def qk_norm_rope2_torch(
    q: Tensor, k: Tensor, gamma_q: Optional[Tensor], gamma_k: Optional[Tensor],
    head_size: int, cos: Tensor, sin: Tensor, is_neox: bool = False, eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    # the oracle's composition: a full-width RMSNorm of each, rounded to the
    # I/O dtype, then the rotation (impl.py:57-97)
    b, s, d = q.shape
    qn = rms_norm_torch(q, gamma_q, eps)
    kn = rms_norm_torch(k, gamma_k, eps)
    qn = _rotate(qn.reshape(b, s, -1, head_size), cos, sin, is_neox)
    kn = _rotate(kn.reshape(b, s, -1, head_size), cos, sin, is_neox)
    return qn.reshape(b, s, d), kn.reshape(b, s, d)


@kernel_registry.register("gelu_and_mul", "torch")
def gelu_and_mul_torch(x: Tensor) -> Tensor:
    # one rounding from f32, as the Pallas kernel and csrc/gelu_mul.cu; the
    # jnp oracle rounds GELU(gate) to x's dtype before the product
    contracts.check_gelu_and_mul("gelu_and_mul_torch", x)
    d = x.shape[-1] // 2
    x32 = x.float()
    return (x32[..., :d] * F.gelu(x32[..., d:], approximate="none")).to(x.dtype)


@kernel_registry.register("quantize_to_int8", "torch")
def quantize_to_int8_torch(x: Tensor, symmetric: bool = True
                           ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    x32 = x.float()
    row_min = x32.amin(dim=-1, keepdim=True)
    row_max = x32.amax(dim=-1, keepdim=True)
    if symmetric:
        abs_max = torch.maximum(row_min.abs(), row_max.abs())
        scale = true_div(abs_max.clamp_min(_EPS_SCALE), 127.0)
        q = torch.round(x32 / scale).clamp(-128, 127).to(torch.int8)
        return q, scale, None
    scale = true_div((row_max - row_min).clamp_min(_EPS_SCALE), 255.0)
    zp = _to_int32_saturating(-128.0 - torch.round(row_min / scale))
    q = (torch.round(x32 / scale) + zp.float()).clamp(-128, 127).to(torch.int8)
    return q, scale, zp


@kernel_registry.register("quantize_to_int4", "torch")
def quantize_to_int4_torch(x: Tensor) -> Tuple[Tensor, Tensor]:
    x32 = x.float()
    scale = true_div(x32.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS_SCALE), 7.0)
    q = torch.round(x32 / scale).clamp(-8, 7).to(torch.int8)
    return q, scale


@kernel_registry.register("quantize_to_fp8", "torch")
def quantize_to_fp8_torch(x: Tensor) -> Tuple[Tensor, Tensor]:
    x32 = x.float()
    scale = true_div(x32.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS_SCALE), _FP8_MAX)
    q = (x32 / scale).clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn)
    return q, scale


def _dequant_epilogue(acc: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                      bias: Optional[Tensor]) -> Tensor:
    # jnp's order: f32(acc) * (sa (x) sb), then + f32(bias), one cast
    out = acc.float() * (scale_a.float().reshape(-1, 1) * scale_b.float().reshape(1, -1))
    if bias is not None:
        out = out + bias.float().reshape(1, -1)
    return out.to(out_dtype)


@kernel_registry.register("int8_matmul", "torch")
def int8_matmul_torch(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                      azp_adj: Tensor, azp: Optional[Tensor], bias: Optional[Tensor] = None
                      ) -> Tensor:
    contracts.check_scaled_mm("int8_matmul_torch", a, b, scale_a, scale_b, azp_adj=azp_adj,
                              azp=azp, bias=bias, int8=True)
    acc = (a.double() @ b.double()).to(torch.int32)  # exact: see the module note
    if azp is not None:
        acc = acc - azp.to(torch.int32).reshape(-1, 1) * azp_adj.to(torch.int32).reshape(1, -1)
    return _dequant_epilogue(acc, scale_a, scale_b, out_dtype, bias)


@kernel_registry.register("int4_matmul", "torch")
def int4_matmul_torch(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                      bias: Optional[Tensor] = None) -> Tensor:
    contracts.check_scaled_mm("int4_matmul_torch", a, b, scale_a, scale_b, bias=bias, int8=True)
    acc = (a.double() @ b.double()).to(torch.int32)  # exact: see the module note
    return _dequant_epilogue(acc, scale_a, scale_b, out_dtype, bias)


@kernel_registry.register("unpack_int4", "torch")
def unpack_int4_torch(p: Tensor) -> Tensor:
    # (..., K/2, N) -> (..., K, N): low nibbles are rows [0, K/2), high nibbles
    # rows [K/2, K), each sign-extended by arithmetic shifts of the int8 byte;
    # built K-contiguous, the layout the card's GEMM reads
    pt = p.transpose(-1, -2)
    return torch.cat([(pt << 4) >> 4, pt >> 4], dim=-1).transpose(-1, -2)


@kernel_registry.register("fp8_matmul", "torch")
def fp8_matmul_torch(a: Tensor, b: Tensor, scale_a: Tensor, scale_b: Tensor, out_dtype,
                     bias: Optional[Tensor] = None) -> Tensor:
    contracts.check_scaled_mm("fp8_matmul_torch", a, b, scale_a, scale_b, bias=bias)
    acc = a.float() @ b.float()  # e4m3 -> f32 is exact; f32 accumulation
    return _dequant_epilogue(acc, scale_a, scale_b, out_dtype, bias)


def _masked_attention(query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
                      num_kv_heads: int, head_dim: int, scale: float,
                      allowed=None, zero_empty_rows: bool = False) -> Tensor:
    """sdpa_jnp's math one head at a time (the (Sq, Skv) float32 logits of a
    single head alive at once): f32 logits, masked entries set to the f32
    minimum, softmax, probabilities rounded to v's dtype, f32 sums, one cast.
    allowed: None, an (Sq, Skv) bool mask shared by every batch entry and
    head, or a function of the query head giving its (B, Sq, Skv) bool mask.
    zero_empty_rows: a row with no allowed key returns 0 (the sparse kernels'
    l == 0 rule) instead of the uniform average the softmax of equal minima
    gives."""
    b, sq, _ = query.shape
    skv = key.shape[1]
    q = query.reshape(b, sq, num_q_heads, head_dim)
    k = key.reshape(b, skv, num_kv_heads, head_dim)
    v = value.reshape(b, skv, num_kv_heads, head_dim)
    rep = num_q_heads // num_kv_heads
    out = torch.empty(b, sq, num_q_heads, head_dim, dtype=query.dtype, device=query.device)
    per_head = callable(allowed)
    shared = None if per_head or allowed is None else (~allowed, ~allowed.any(dim=-1))
    for h in range(num_q_heads):
        blocked, empty_rows = shared or (None, None)
        if per_head:
            a = allowed(h)
            blocked, empty_rows = ~a, ~a.any(dim=-1)
        kh, vh = k[:, :, h // rep].float(), v[:, :, h // rep]
        logits = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), kh) * scale
        if blocked is not None:
            logits = logits.masked_fill(blocked, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        if zero_empty_rows:
            probs = probs.masked_fill(empty_rows[..., None], 0.0)
        out[:, :, h] = torch.einsum(
            "bqk,bkd->bqd", probs.to(vh.dtype).float(), vh.float()).to(query.dtype)
    return out.reshape(b, sq, num_q_heads * head_dim)


@kernel_registry.register("sdpa", "torch")
def sdpa_torch(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int,
    num_kv_heads: int, head_dim: int, is_causal: bool = False,
    scale: Optional[float] = None,
) -> Tensor:
    contracts.check_sdpa("sdpa_torch", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    sq, skv = query.shape[1], key.shape[1]
    if scale is None:
        scale = head_dim**-0.5
    return _masked_attention(query, key, value, num_q_heads, num_kv_heads, head_dim, scale,
                             _causal_mask(sq, skv, query.device) if is_causal else None)


def _causal_mask(sq: int, skv: int, device) -> Tensor:
    """Bottom-right aligned, as sdpa_jnp: tril(k = skv - sq)."""
    return torch.ones(sq, skv, dtype=torch.bool, device=device).tril(skv - sq)


@kernel_registry.register("sdpa_sparse", "torch")
def sdpa_sparse_torch(
    query: Tensor, key: Tensor, value: Tensor, num_q_heads: int, num_kv_heads: int,
    head_dim: int, is_causal: bool = False, scale: Optional[float] = None,
    sparse_mask: Optional[Tensor] = None, block_q: int = 128, block_k: int = 128,
) -> Tensor:
    if sparse_mask is None:
        return sdpa_torch(query, key, value, num_q_heads, num_kv_heads, head_dim, is_causal,
                          scale)
    contracts.check_sdpa("sdpa_sparse_torch", query, key, value, num_q_heads, num_kv_heads,
                         head_dim)
    b, sq, _ = query.shape
    skv = key.shape[1]
    contracts.check_sparse_mask("sdpa_sparse_torch", sparse_mask, b, num_q_heads, sq, skv,
                                block_q, block_k)
    dev = query.device
    m = sparse_mask.to(device=dev, dtype=torch.bool)
    rq = torch.arange(sq, device=dev) // block_q
    rk = torch.arange(skv, device=dev) // block_k
    causal = _causal_mask(sq, skv, dev) if is_causal else None

    def allowed(h: int) -> Tensor:  # head h's (B, Sq, Skv) token mask
        a = m[:, h][:, rq][:, :, rk]
        return a if causal is None else a & causal

    if scale is None:
        scale = head_dim**-0.5
    return _masked_attention(query, key, value, num_q_heads, num_kv_heads, head_dim, scale,
                             allowed, zero_empty_rows=True)


def gather_lists_allowed(block_indices: Tensor, block_counts: Tensor, skv: int,
                         block_k: int) -> Tensor:
    """(nq, ceil(skv/block_k)) bool block mask of the coarse gather lists
    (sdpa_gather_jnp's reconstruction, impl.py:299-305): entries past a
    row's count allow nothing; indices are clipped to the KV tiles, as the
    Pallas wrapper clips them."""
    dev = block_indices.device
    nq, max_nb = block_indices.shape
    nk = -(-skv // block_k)
    valid = torch.arange(max_nb, device=dev)[None, :] < block_counts.long().reshape(nq, 1)
    rows = torch.arange(nq, device=dev)[:, None].expand(nq, max_nb)
    mask = torch.zeros(nq, nk, dtype=torch.bool, device=dev)
    mask[rows[valid], block_indices.long().clamp(0, nk - 1)[valid]] = True
    return mask


@kernel_registry.register("sdpa_gather", "torch")
def sdpa_gather_torch(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_counts: Tensor,
    num_q_heads: int, num_kv_heads: int, head_dim: int, scale: Optional[float] = None,
    block_q: int = 512, block_k: int = 1024,
) -> Tensor:
    contracts.check_sdpa("sdpa_gather_torch", query, key, value, num_q_heads, num_kv_heads,
                         head_dim)
    sq, skv = query.shape[1], key.shape[1]
    contracts.check_gather_lists("sdpa_gather_torch", block_indices, block_counts, sq, skv,
                                 block_q, block_k)
    dev = query.device
    mask = gather_lists_allowed(block_indices, block_counts, skv, block_k)
    allowed = mask[torch.arange(sq, device=dev) // block_q][
        :, torch.arange(skv, device=dev) // block_k]
    if scale is None:
        scale = head_dim**-0.5
    return _masked_attention(query, key, value, num_q_heads, num_kv_heads, head_dim, scale,
                             allowed, zero_empty_rows=True)


def _rows_of_slots(block_rows: Tensor, t: int) -> Tuple[Tensor, Tensor]:
    """For each of the t slots of a CSR-flat table: its row (the last row
    whose start is at or before it) and whether it lies within that row's
    `count` entries."""
    dev = block_rows.device
    starts = block_rows[:, 0].long()
    slot = torch.arange(t, device=dev)
    row_of_slot = (torch.searchsorted(starts.contiguous(), slot, right=True) - 1).clamp_min(0)
    in_row = slot - starts[row_of_slot] < block_rows[:, 1].long()[row_of_slot]
    return row_of_slot, in_row


def gather_fine_allowed(block_indices: Tensor, block_valid: Tensor, block_rows: Tensor,
                        skv: int, fine: int) -> Tensor:
    """(nq, skv) bool: the keys each fine-table row allows
    (sdpa_gather_fine_jnp's expansion, impl.py:341-347): of fine block f an
    entry allows tokens f*fine + [0, valid); only a row's first `count`
    entries count, indices outside the sequence allow nothing, and keys past
    skv do not exist."""
    dev = block_indices.device
    nq, nfine = block_rows.shape[0], -(-skv // fine)
    idx = block_indices.long()
    row_of_slot, use = _rows_of_slots(block_rows, idx.shape[0])
    use &= (idx >= 0) & (idx < nfine)
    grid = torch.zeros(nq * nfine, dtype=torch.long, device=dev)
    grid.scatter_reduce_(0, (row_of_slot * nfine + idx.clamp(0, nfine - 1))[use],
                         block_valid.long()[use], "amax")
    tok = torch.arange(skv, device=dev)
    return (tok % fine)[None, :] < grid.view(nq, nfine)[:, tok // fine]


@kernel_registry.register("sdpa_gather_fine", "torch")
def sdpa_gather_fine_torch(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_valid: Tensor,
    block_rows: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int,
    scale: Optional[float] = None, block_q: int = 512, group: int = 8, fine: int = 64,
) -> Tensor:
    contracts.check_sdpa("sdpa_gather_fine_torch", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    sq, skv = query.shape[1], key.shape[1]
    contracts.check_gather_fine("sdpa_gather_fine_torch", block_indices, block_valid,
                                block_rows, sq, skv, block_q, group, fine)
    allowed = gather_fine_allowed(block_indices, block_valid, block_rows, skv, fine)
    rows = torch.arange(sq, device=query.device) // block_q
    if scale is None:
        scale = head_dim**-0.5
    return _masked_attention(query, key, value, num_q_heads, num_kv_heads, head_dim, scale,
                             allowed[rows], zero_empty_rows=True)


def gather_super_allowed(block_indices: Tensor, block_valbits: Tensor, block_rows: Tensor,
                         skv: int, fine: int, superblock: int) -> Tensor:
    """(nq, skv) bool: the keys each table row allows (sdpa_gather_super_jnp's
    table expansion, impl.py:397-417). A key is allowed when the bit of its
    fine block is set in one of the row's `count` entries; padding slots
    (valbits 0) allow nothing, and keys past skv do not exist, which caps
    the global tail fine block at its remainder."""
    dev = block_indices.device
    nq, t = block_rows.shape[0], block_indices.shape[0]
    sb = superblock
    nsup = -(-(-(-skv // fine)) // sb)
    row_of_slot, in_row = _rows_of_slots(block_rows, t)
    sub = torch.arange(sb, device=dev)
    fids = block_indices.long()[:, None] * sb + sub[None, :]                    # (T, sb)
    active = ((block_valbits.long()[:, None] >> sub[None, :]) & 1) == 1       # (T, sb)
    active &= in_row[:, None]
    grid = torch.zeros(nq, nsup * sb, dtype=torch.bool, device=dev)
    rows = row_of_slot[:, None].expand(-1, sb)
    grid[rows[active], fids[active]] = True
    tok = torch.arange(skv, device=dev)
    return grid[:, tok // fine]


@kernel_registry.register("sdpa_gather_super", "torch")
def sdpa_gather_super_torch(
    query: Tensor, key: Tensor, value: Tensor, block_indices: Tensor, block_valbits: Tensor,
    block_rows: Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int,
    scale: Optional[float] = None, block_q: int = 512, group: int = 8, fine: int = 64,
    superblock: int = 4,
) -> Tensor:
    contracts.check_sdpa("sdpa_gather_super_torch", query, key, value, num_q_heads,
                         num_kv_heads, head_dim)
    sq, skv = query.shape[1], key.shape[1]
    contracts.check_gather_super("sdpa_gather_super_torch", block_indices, block_valbits,
                                 block_rows, sq, skv, block_q, group, fine, superblock)
    allowed = gather_super_allowed(block_indices, block_valbits, block_rows, skv, fine,
                                   superblock)
    rows = torch.arange(sq, device=query.device) // block_q
    if scale is None:
        scale = head_dim**-0.5
    return _masked_attention(query, key, value, num_q_heads, num_kv_heads, head_dim, scale,
                             allowed[rows], zero_empty_rows=True)
