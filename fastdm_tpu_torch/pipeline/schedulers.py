"""FlowMatch-Euler scheduler (port of fastdm_tpu/pipeline/schedulers.py:31-86).

The sigma ladder is computed on the host in numpy (float64, stored float32),
as in the JAX package; the step is one fused-in-float32 tensor update."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def flow_match_shift_mu(seq_len: int, base_len: int = 256, max_len: int = 4096,
                        base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """Resolution-dependent timestep shift (FLUX dynamic shifting: linear in
    the token count)."""
    m = (max_shift - base_shift) / (max_len - base_len)
    b = base_shift - m * base_len
    return seq_len * m + b


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerScheduler:
    """Rectified-flow Euler. sigmas: (num_steps + 1,) descending float32,
    sigmas[-1] = 0; the model predicts velocity and
    x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v."""

    sigmas: np.ndarray
    num_train_timesteps: int = 1000

    @classmethod
    def create(cls, num_steps: int, *, shift: float = 3.0, use_dynamic_shifting: bool = False,
               mu: Optional[float] = None,
               num_train_timesteps: int = 1000) -> "FlowMatchEulerScheduler":
        sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
        if use_dynamic_shifting:
            if mu is None:
                raise ValueError("dynamic shifting needs mu (flow_match_shift_mu)")
            sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
        else:
            sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
        sigmas = np.append(sigmas, 0.0).astype(np.float32)
        return cls(sigmas=sigmas, num_train_timesteps=num_train_timesteps)

    @property
    def timesteps(self) -> np.ndarray:
        """Model-facing timesteps in [0, 1] (the model multiplies by 1000)."""
        return self.sigmas[:-1]

    def step(self, model_output: Tensor, step_index: int, sample: Tensor) -> Tensor:
        """One Euler step in float32. The sigma difference of two float32
        values is exact in float64, so it rounds to the same float32 as the
        JAX package's on-device subtraction."""
        dt = float(self.sigmas[step_index + 1]) - float(self.sigmas[step_index])
        return sample + np.float32(dt).item() * model_output.float()
