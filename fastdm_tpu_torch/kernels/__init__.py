"""Kernel ops of the port: rms_norm, rotary_pos_embedding and
scaled_dot_product_attention, dispatched by tensor device to the plain
PyTorch versions (CPU) or the hand-written Hopper kernels (CUDA)."""

from fastdm_tpu_torch.kernels import cuda_backend, torch_backend  # noqa: F401  (registration)
from fastdm_tpu_torch.kernels.ops import (
    rms_norm,
    rotary_pos_embedding,
    scaled_dot_product_attention,
)
from fastdm_tpu_torch.kernels.registry import kernel_registry

__all__ = [
    "kernel_registry",
    "rms_norm",
    "rotary_pos_embedding",
    "scaled_dot_product_attention",
]
