"""Diffusion noise schedule: the DDPM tables SDS needs.

Tables from the Stable-Diffusion config (scaled_linear β ∈ [0.00085,
0.012], 1000 train steps). The DDIM / PNDM samplers of the JAX package come
with a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
