"""FlowMatch-Euler, EulerDiscrete, UniPC and DDIM schedulers (port of
fastdm_tpu/pipeline/schedulers.py:31-86, :87-144, :147-300 and :301-331).

The sigma ladders are computed on the host in numpy (float64, stored
float32), as in the JAX package. The step index is a Python int here (the
loops are Python loops), so a step's scalar coefficients are computed on the
host in float64 and only the tensor updates run on the device, in float32."""

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


def _betas_scaled_linear(num_train_timesteps: int, beta_start: float = 0.00085,
                         beta_end: float = 0.012) -> np.ndarray:
    return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                       dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    """k-diffusion Euler without ancestral noise (SDXL's default), epsilon
    prediction, diffusers' "leading" timestep spacing with steps_offset 1.
    sigmas: (num_steps + 1,) float32, descending, last 0; timesteps:
    (num_steps,) float32 train-timestep values. The ladder is the JAX
    package's numpy computation, so it is bit-exact with it."""

    sigmas: np.ndarray
    timesteps: np.ndarray
    init_noise_sigma: float

    @classmethod
    def create(cls, num_steps: int, num_train_timesteps: int = 1000,
               steps_offset: int = 1) -> "EulerDiscreteScheduler":
        """Linear sigma interpolation (the SDXL config value; the JAX create
        raises for any other)."""
        alphas_cumprod = np.cumprod(1.0 - _betas_scaled_linear(num_train_timesteps))
        full_sigmas = np.sqrt((1 - alphas_cumprod) / alphas_cumprod)
        step_ratio = num_train_timesteps // num_steps
        ts = ((np.arange(num_steps) * step_ratio).round()[::-1]
              + steps_offset).astype(np.float64)
        sigmas = np.interp(ts, np.arange(num_train_timesteps), full_sigmas)
        sigmas = np.append(sigmas, 0.0).astype(np.float32)
        return cls(sigmas=sigmas, timesteps=ts.astype(np.float32),
                   init_noise_sigma=float(np.sqrt(sigmas[0] ** 2 + 1)))

    def _sigma(self, like: Tensor, step_index: int) -> Tensor:
        """sigmas[step_index] as a 0-dim float32 tensor: divisions by it are
        correctly rounded on every device (see torch_backend.true_div)."""
        return like.new_full((), float(self.sigmas[step_index]), dtype=torch.float32)

    def scale_model_input(self, sample: Tensor, step_index: int) -> Tensor:
        """sample / sqrt(sigma^2 + 1), in float32."""
        sigma = self._sigma(sample, step_index)
        return sample / torch.sqrt(sigma * sigma + 1)

    def step(self, model_output: Tensor, step_index: int, sample: Tensor) -> Tensor:
        """One Euler step in float32 from an epsilon prediction."""
        sigma = self._sigma(sample, step_index)
        pred_x0 = sample - sigma * model_output.float()
        derivative = (sample - pred_x0) / sigma
        dt = float(self.sigmas[step_index + 1] - self.sigmas[step_index])  # f32 difference
        return sample + derivative * dt


def _flow_lambda(sigma: float) -> float:
    """log(alpha) - log(sigma) with alpha = 1 - sigma, clamped as the JAX
    _lambda (the clamp only matters at the ladder's ends)."""
    s = min(max(float(sigma), 1e-9), 1.0 - 1e-9)
    return math.log1p(-s) - math.log(s)


@dataclasses.dataclass(frozen=True)
class UniPCMultistepScheduler:
    """UniPC multistep, order 2, data prediction, the bh2 variant, flow sigmas,
    lower_order_final: diffusers' WanPipeline default (port of the JAX
    UniPCMultistepScheduler). The model predicts velocity; x0 = sample -
    sigma * v is what UniPC integrates. State: the last two x0 predictions
    (m0, m1) and the pre-predictor sample. The predictor runs order 2 on steps
    [1, N-2], the corrector order 2 from step 2."""

    sigmas: np.ndarray  # (num_steps + 1,) descending float32, sigmas[-1] = 0
    num_train_timesteps: int = 1000
    solver_order: int = 2

    @classmethod
    def create(cls, num_steps: int, *, shift: float = 5.0, solver_order: int = 2,
               num_train_timesteps: int = 1000) -> "UniPCMultistepScheduler":
        if solver_order != 2:
            raise ValueError("only the order-2 solver (the Wan default) is built")
        alphas = np.linspace(1.0, 1.0 / num_train_timesteps, num_steps + 1, dtype=np.float64)
        s = 1.0 - alphas
        s = np.flip(shift * s / (1.0 + (shift - 1.0) * s))[:-1]
        sigmas = np.append(s, 0.0).astype(np.float32)
        return cls(sigmas=sigmas, num_train_timesteps=num_train_timesteps,
                   solver_order=solver_order)

    @property
    def timesteps(self) -> np.ndarray:
        """Model-facing timesteps in [0, 1] (the model multiplies by 1000)."""
        return self.sigmas[:-1]

    def init_state(self, like: Tensor) -> dict:
        z = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
        return {"m0": z, "m1": z, "last_sample": z}

    def step(self, model_output: Tensor, step_index: int, sample: Tensor, state: dict,
             num_steps: int):
        """One UniPC predictor (+ corrector from step 1) update ->
        (prev_sample, new_state); model_output is the velocity at (sample,
        sigmas[step_index])."""
        i = int(step_index)
        sig = [float(v) for v in self.sigmas]
        sig_i, sig_next = sig[i], sig[i + 1]
        sig_im1, sig_im2 = sig[max(i - 1, 0)], sig[max(i - 2, 0)]
        x = sample.float()
        m0_prev, m1_prev = state["m0"], state["m1"]
        model_t = x - sig_i * model_output.float()

        if i >= 1:  # corrector (uni_c) on the current sample, from step i-1
            lam_s0 = _flow_lambda(sig_im1)
            h_c = _flow_lambda(sig_i) - lam_s0
            h_phi_1 = math.expm1(-h_c)
            alpha_t = 1.0 - sig_i
            x_t = (sig_i / max(sig_im1, 1e-9)) * state["last_sample"] \
                - alpha_t * h_phi_1 * m0_prev
            d1_t = model_t - m0_prev
            if i == 1:
                x = x_t - alpha_t * h_phi_1 * (0.5 * d1_t)
            else:
                b1 = (h_phi_1 / -h_c - 1.0) / h_phi_1
                b2 = ((h_phi_1 / -h_c - 1.0) / -h_c - 0.5) * 2.0 / h_phi_1
                r1 = (_flow_lambda(sig_im2) - lam_s0) / h_c
                rho1 = (b1 - b2) / (1.0 if abs(1.0 - r1) < 1e-12 else 1.0 - r1)
                d1_1 = (m1_prev - m0_prev) / (1.0 if abs(r1) < 1e-12 else r1)
                x = x_t - alpha_t * h_phi_1 * (rho1 * d1_1 + (b1 - rho1) * d1_t)

        # predictor (uni_p) from the corrected sample to step i+1
        lam_s0 = _flow_lambda(sig_i)
        h = _flow_lambda(sig_next) - lam_s0
        # exact endpoint: at sigma_next = 0 the order-1 step returns model_t
        h_phi_1 = -1.0 if sig_next <= 0.0 else math.expm1(-h)
        alpha_t = 1.0 - sig_next
        prev = (sig_next / max(sig_i, 1e-9)) * x - alpha_t * h_phi_1 * model_t
        if 1 <= i <= num_steps - 2:
            r1 = (_flow_lambda(sig_im1) - lam_s0) / (1.0 if abs(h) < 1e-12 else h)
            d1_1 = (m0_prev - model_t) / (1.0 if abs(r1) < 1e-12 else r1)
            prev = prev - alpha_t * h_phi_1 * (0.5 * d1_1)
        return prev, {"m0": model_t, "m1": m0_prev, "last_sample": x}


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """Deterministic DDIM (eta 0), epsilon prediction, scaled-linear betas,
    diffusers' "leading" spacing with steps_offset 1 and set_alpha_to_one
    (the final step denoises to the clean sample). The tables are the JAX
    package's numpy computation, so they are bit-exact with it."""

    timesteps: np.ndarray  # (num_steps,) int64, descending
    alphas_cumprod: np.ndarray  # (num_train_timesteps,) float32
    final_alpha_cumprod: float

    @classmethod
    def create(cls, num_steps: int, num_train_timesteps: int = 1000,
               steps_offset: int = 1) -> "DDIMScheduler":
        ac = np.cumprod(1.0 - _betas_scaled_linear(num_train_timesteps)).astype(np.float32)
        step_ratio = num_train_timesteps // num_steps
        ts = ((np.arange(num_steps) * step_ratio).round()[::-1]
              + steps_offset).astype(np.int64)
        return cls(timesteps=ts, alphas_cumprod=ac, final_alpha_cumprod=1.0)

    def step(self, model_output: Tensor, timestep, prev_timestep, sample: Tensor,
             alphas: Tensor) -> Tensor:
        """One DDIM step in float32. timestep / prev_timestep are ints or
        integer tensors; alphas is alphas_cumprod as a float32 tensor on the
        sample's device. A prev_timestep < 0 takes final_alpha_cumprod."""
        t = torch.as_tensor(timestep, device=alphas.device)
        prev = torch.as_tensor(prev_timestep, device=alphas.device)
        at = alphas[t]
        at_prev = torch.where(prev >= 0, alphas[prev.clamp_min(0)],
                              alphas.new_full((), self.final_alpha_cumprod))
        eps = model_output.float()
        x0 = (sample - torch.sqrt(1 - at) * eps) / torch.sqrt(at)
        return torch.sqrt(at_prev) * x0 + torch.sqrt(1 - at_prev) * eps
