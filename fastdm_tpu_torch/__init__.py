"""fastdm_tpu_torch — the PyTorch/CUDA port of fastdm_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference (fastdm_tpu/): it imports torch
and nothing of JAX or of fastdm_tpu. Plain tensor code is PyTorch; every op the
JAX package ran as a Pallas TPU kernel runs here as a kernel written by hand
for sm_90a (csrc/), behind a plain PyTorch version that the CPU path and the
tests use. Entry points run on the GPU ("cuda") unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"
