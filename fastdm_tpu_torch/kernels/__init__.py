"""Kernel ops of the port: rms_norm, rotary_pos_embedding, qk_norm_rope,
qk_norm_rope2, gelu_and_mul, scaled_dot_product_attention, the sparse
attentions (sparse_scaled_dot_product_attention, gather_sparse_attention,
gather_fine_attention, gather_super_attention), the W8A8 ops
(quantize_to_int8, quantize_to_fp8, int8_matmul, fp8_matmul) and the W4A4 ops
(quantize_to_int4, int4_matmul, unpack_int4), dispatched by
tensor device to the plain PyTorch versions (CPU) or the hand-written Hopper
kernels (CUDA)."""

from fastdm_tpu_torch.kernels import cuda_backend, torch_backend  # noqa: F401  (registration)
from fastdm_tpu_torch.kernels.ops import (
    fp8_matmul,
    gather_fine_attention,
    gather_sparse_attention,
    gather_super_attention,
    gelu_and_mul,
    int4_matmul,
    int8_matmul,
    qk_norm_rope,
    qk_norm_rope2,
    quantize_to_fp8,
    quantize_to_int4,
    quantize_to_int8,
    rms_norm,
    rotary_pos_embedding,
    scaled_dot_product_attention,
    sparse_scaled_dot_product_attention,
    unpack_int4,
)
from fastdm_tpu_torch.kernels.registry import kernel_registry

__all__ = [
    "fp8_matmul",
    "gather_fine_attention",
    "gather_sparse_attention",
    "gather_super_attention",
    "gelu_and_mul",
    "int4_matmul",
    "int8_matmul",
    "kernel_registry",
    "qk_norm_rope",
    "qk_norm_rope2",
    "quantize_to_fp8",
    "quantize_to_int4",
    "quantize_to_int8",
    "rms_norm",
    "rotary_pos_embedding",
    "scaled_dot_product_attention",
    "sparse_scaled_dot_product_attention",
    "unpack_int4",
]
