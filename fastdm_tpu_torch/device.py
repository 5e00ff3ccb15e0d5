"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device to run on. The default, "cuda", raises when no GPU is
    visible: the port never carries on quietly on the CPU — callers that want
    the plain PyTorch path (the tests) pass device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch sees no CUDA device; pass device='cpu' "
            "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    return dev
