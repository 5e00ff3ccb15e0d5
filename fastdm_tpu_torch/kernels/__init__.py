"""Kernel ops of the port: rms_norm, rotary_pos_embedding,
scaled_dot_product_attention and the W8A8 ops (quantize_to_int8,
quantize_to_fp8, int8_matmul, fp8_matmul), dispatched by tensor device to the
plain PyTorch versions (CPU) or the hand-written Hopper kernels (CUDA)."""

from fastdm_tpu_torch.kernels import cuda_backend, torch_backend  # noqa: F401  (registration)
from fastdm_tpu_torch.kernels.ops import (
    fp8_matmul,
    int8_matmul,
    quantize_to_fp8,
    quantize_to_int8,
    rms_norm,
    rotary_pos_embedding,
    scaled_dot_product_attention,
)
from fastdm_tpu_torch.kernels.registry import kernel_registry

__all__ = [
    "fp8_matmul",
    "int8_matmul",
    "kernel_registry",
    "quantize_to_fp8",
    "quantize_to_int8",
    "rms_norm",
    "rotary_pos_embedding",
    "scaled_dot_product_attention",
]
