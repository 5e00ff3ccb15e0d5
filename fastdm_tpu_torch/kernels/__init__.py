"""Kernel ops of the port: rms_norm, rotary_pos_embedding, qk_norm_rope,
qk_norm_rope2, gelu_and_mul, scaled_dot_product_attention (and its log-sum-exp variant), the sparse
attentions (sparse_scaled_dot_product_attention, gather_sparse_attention,
gather_fine_attention, gather_super_attention), the W8A8 ops
(quantize_to_int8, quantize_to_fp8, int8_matmul, fp8_matmul) and the W4A4 ops
(quantize_to_int4, int4_matmul, unpack_int4, w4a4_linear) and the tensor-parallel
variants (rms_sumsq, rms_norm_given, qk_norm_rope_given, qk_norm_rope2_given,
quantize_stats, quantize_to_*_given, *_matmul_partial), dispatched by
tensor device to the plain PyTorch versions (CPU) or the hand-written Hopper
kernels (CUDA); under autograd rms_norm, rotary_pos_embedding and
scaled_dot_product_attention go through the Functions of kernels/autograd.py."""

from fastdm_tpu_torch.kernels import cuda_backend, torch_backend  # noqa: F401  (registration)
from fastdm_tpu_torch.kernels.ops import (
    fp8_matmul,
    fp8_matmul_partial,
    gather_fine_attention,
    gather_sparse_attention,
    gather_super_attention,
    gelu_and_mul,
    int4_matmul,
    int4_matmul_partial,
    int8_matmul,
    int8_matmul_partial,
    qk_norm_rope,
    qk_norm_rope2,
    qk_norm_rope2_given,
    qk_norm_rope_given,
    quantize_stats,
    quantize_to_fp8,
    quantize_to_fp8_given,
    quantize_to_int4,
    quantize_to_int4_given,
    quantize_to_int8,
    quantize_to_int8_given,
    rms_norm,
    rms_norm_given,
    rms_sumsq,
    rotary_pos_embedding,
    scaled_dot_product_attention,
    scaled_dot_product_attention_lse,
    sparse_scaled_dot_product_attention,
    unpack_int4,
    w4a4_linear,
)
from fastdm_tpu_torch.kernels import autograd  # noqa: F401,E402  (registration)
from fastdm_tpu_torch.kernels.registry import kernel_registry

__all__ = [
    "fp8_matmul",
    "fp8_matmul_partial",
    "gather_fine_attention",
    "gather_sparse_attention",
    "gather_super_attention",
    "gelu_and_mul",
    "int4_matmul",
    "int4_matmul_partial",
    "int8_matmul",
    "int8_matmul_partial",
    "kernel_registry",
    "qk_norm_rope",
    "qk_norm_rope2",
    "qk_norm_rope2_given",
    "qk_norm_rope_given",
    "quantize_stats",
    "quantize_to_fp8",
    "quantize_to_fp8_given",
    "quantize_to_int4",
    "quantize_to_int4_given",
    "quantize_to_int8",
    "quantize_to_int8_given",
    "rms_norm",
    "rms_norm_given",
    "rms_sumsq",
    "rotary_pos_embedding",
    "scaled_dot_product_attention",
    "scaled_dot_product_attention_lse",
    "sparse_scaled_dot_product_attention",
    "unpack_int4",
    "w4a4_linear",
]
