"""Diffusion noise schedule: the DDPM tables SDS needs, and the DDIM step.

Tables from the Stable-Diffusion config (scaled_linear β ∈ [0.00085,
0.012], 1000 train steps). The DDIM-inverse and PNDM samplers of the JAX
package are not ported yet: ROADMAP.md item A.6.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from tpunerf_torch.utils import resolve_device

NUM_TRAIN_TIMESTEPS = 1000
BETA_START = 0.00085
BETA_END = 0.012


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed DDPM tables."""
    betas: torch.Tensor            # (T,)
    alphas: torch.Tensor           # (T,)
    alphas_cumprod: torch.Tensor   # (T,)
    num_train_timesteps: int = NUM_TRAIN_TIMESTEPS
    # the SD DDIM default (set_alpha_to_one=False): the step past t = 0
    # uses ᾱ₀
    final_alpha_cumprod_is_one: bool = False

    @property
    def final_alpha_cumprod(self) -> torch.Tensor:
        if self.final_alpha_cumprod_is_one:
            return torch.ones_like(self.alphas_cumprod[0])
        return self.alphas_cumprod[0]

    @classmethod
    def scaled_linear(cls, num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                      beta_start: float = BETA_START,
                      beta_end: float = BETA_END,
                      device: Optional[torch.device] = None
                      ) -> "NoiseSchedule":
        """The tables on `device` (CUDA unless the caller names another)."""
        device = resolve_device(device)
        sqrt_betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                    num_train_timesteps, dtype=torch.float32,
                                    device=device)
        betas = sqrt_betas ** 2
        alphas = 1.0 - betas
        return cls(betas=betas, alphas=alphas,
                   alphas_cumprod=torch.cumprod(alphas, dim=0),
                   num_train_timesteps=num_train_timesteps)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε."""
        a = self.alphas_cumprod[t]
        a = a.reshape(a.shape + (1,) * (sample.ndim - a.ndim))
        return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise

    def sds_weight(self, t: torch.Tensor) -> torch.Tensor:
        """SDS weight w(t) = √ᾱ_t·(1−ᾱ_t)."""
        a = self.alphas_cumprod[t]
        return torch.sqrt(a) * (1.0 - a)


def ddim_timesteps(num_inference_steps: int,
                   num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Descending timestep grid ('leading' spacing, as SD uses it):
    t_i = (S−1−i)·(T//S) + 1 (50 steps: 981, 961, … 1), int64, on `device`
    (CUDA unless the caller names another)."""
    ratio = num_train_timesteps // num_inference_steps
    steps = torch.arange(num_inference_steps - 1, -1, -1, dtype=torch.int64,
                         device=resolve_device(device))
    return steps * ratio + 1


class DDIMStepOutput(NamedTuple):
    prev_sample: torch.Tensor
    pred_x0: torch.Tensor


def ddim_step(sched: NoiseSchedule, eps: torch.Tensor, t: torch.Tensor,
              sample: torch.Tensor, num_inference_steps: int
              ) -> DDIMStepOutput:
    """Deterministic DDIM update x_t → x_{t−Δ} (ε-prediction, η = 0)."""
    step = sched.num_train_timesteps // num_inference_steps
    prev_t = t - step
    a_t = sched.alphas_cumprod[t]
    a_prev = torch.where(prev_t >= 0,
                         sched.alphas_cumprod[prev_t.clamp(min=0)],
                         sched.final_alpha_cumprod)
    shape = (1,) * sample.ndim
    a_t, a_prev = a_t.reshape(shape), a_prev.reshape(shape)
    pred_x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * eps
    return DDIMStepOutput(prev_sample=prev, pred_x0=pred_x0)
