"""Diffusion noise schedules: the DDPM tables SDS needs, the DDIM step and
its inverse (DDIM inversion), the PNDM (PLMS) step and img2img's strength
truncation.

Tables from the Stable-Diffusion config (scaled_linear β ∈ [0.00085,
0.012], 1000 train steps).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

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
        a = self._alpha_bar(t)
        a = a.reshape(a.shape + (1,) * (sample.ndim - a.ndim))
        return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise

    def sds_weight(self, t: torch.Tensor, form: str = "sqrt"
                   ) -> torch.Tensor:
        """SDS weight w(t): "sqrt" √ᾱ_t·(1−ᾱ_t) (text-guided SD), "sigma2"
        1−ᾱ_t (depth-conditioned SD)."""
        a = self._alpha_bar(t)
        if form == "sqrt":
            return torch.sqrt(a) * (1.0 - a)
        if form == "sigma2":
            return 1.0 - a
        raise ValueError(form)

    def pred_x0_from_eps(self, x_t: torch.Tensor, eps: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
        """x̂₀ = (x_t − √(1−ᾱ_t)·ε) / √ᾱ_t."""
        a = self._alpha_bar(t)
        a = a.reshape(a.shape + (1,) * (x_t.ndim - a.ndim))
        return (x_t - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)

    def _alpha_bar(self, t) -> torch.Tensor:
        """ᾱ_t, shaped as t, by a gather on the device: indexing by a 0-dim
        tensor would read t back to the host (which a CUDA graph's capture
        refuses)."""
        t = torch.as_tensor(t, device=self.alphas_cumprod.device)
        return self.alphas_cumprod.index_select(0, t.reshape(-1)).reshape(
            t.shape)


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


def ddim_inverse_step(sched: NoiseSchedule, eps: torch.Tensor,
                      t: torch.Tensor, sample: torch.Tensor,
                      num_inference_steps: int) -> DDIMStepOutput:
    """DDIM inversion x_t → x_{t+Δ}: x̂₀ from ε at t, renoised to t + Δ
    (clamped to the last train step); at t < 0 ᾱ is the final one."""
    step = sched.num_train_timesteps // num_inference_steps
    t = torch.as_tensor(t, device=sample.device)
    a_t = torch.where(t >= 0, sched._alpha_bar(t.clamp(min=0)),
                      sched.final_alpha_cumprod)
    a_next = sched._alpha_bar(
        (t + step).clamp(max=sched.num_train_timesteps - 1))
    shape = (1,) * sample.ndim
    a_t, a_next = a_t.reshape(shape), a_next.reshape(shape)
    pred_x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    nxt = torch.sqrt(a_next) * pred_x0 + torch.sqrt(1.0 - a_next) * eps
    return DDIMStepOutput(prev_sample=nxt, pred_x0=pred_x0)


# PNDM as SD pipelines run it (skip_prk_steps): the first step uses ε as it
# is, later ones the linear multistep combination of the stored ε's.

class PNDMState(NamedTuple):
    ets: torch.Tensor        # (4, *sample_shape) past ε, newest first
    counter: torch.Tensor    # int64, steps completed
    cur_sample: torch.Tensor


def pndm_init(sample_shape: Tuple[int, ...],
              device: Optional[torch.device] = None) -> PNDMState:
    """An empty PNDM state on `device` (CUDA unless the caller names
    another)."""
    device = resolve_device(device)
    return PNDMState(
        ets=torch.zeros((4, *sample_shape), dtype=torch.float32,
                        device=device),
        counter=torch.zeros((), dtype=torch.int64, device=device),
        cur_sample=torch.zeros(sample_shape, dtype=torch.float32,
                               device=device))


def _pndm_prev_sample(sched: NoiseSchedule, sample: torch.Tensor,
                      t: torch.Tensor, prev_t: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
    """diffusers' PNDM closed form x_t → x_{t−Δ}."""
    a_t = sched._alpha_bar(torch.as_tensor(t).clamp(min=0))
    prev_t = torch.as_tensor(prev_t, device=a_t.device)
    a_prev = torch.where(prev_t >= 0,
                         sched._alpha_bar(prev_t.clamp(min=0)),
                         sched.final_alpha_cumprod)
    shape = (1,) * sample.ndim
    a_t, a_prev = a_t.reshape(shape), a_prev.reshape(shape)
    sample_coeff = torch.sqrt(a_prev / a_t)
    denom = (a_t * torch.sqrt(1.0 - a_prev)
             + torch.sqrt(a_t * a_prev * (1.0 - a_t)))
    return sample_coeff * sample - (a_prev - a_t) * eps / denom


def pndm_step(sched: NoiseSchedule, state: PNDMState, eps: torch.Tensor,
              t: torch.Tensor, sample: torch.Tensor,
              num_inference_steps: int) -> Tuple[torch.Tensor, PNDMState]:
    """One PLMS step: ε joins the ring of past ε's, whose combination
    (1, 2, 3 or 4 terms by the steps done) gives x_{t−Δ}."""
    step = sched.num_train_timesteps // num_inference_steps
    t = torch.as_tensor(t, device=sample.device)
    prev_t = t - step
    c = state.counter
    ets = torch.cat([eps[None], state.ets[:-1]])
    e1, e2, e3, e4 = ets
    eps_prime = torch.where(
        c == 0, e1,
        torch.where(c == 1, (e1 + e2) / 2.0,
                    torch.where(c == 2, (23 * e1 - 16 * e2 + 5 * e3) / 12.0,
                                (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4)
                                / 24.0)))
    prev = _pndm_prev_sample(sched, sample, t, prev_t, eps_prime)
    return prev, PNDMState(ets=ets, counter=c + 1, cur_sample=sample)


def strength_timesteps(num_inference_steps: int, strength: float,
                       num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                       device: Optional[torch.device] = None
                       ) -> Tuple[torch.Tensor, int]:
    """img2img's truncation: the last `strength` fraction of the DDIM grid,
    and the index it starts at."""
    ts = ddim_timesteps(num_inference_steps, num_train_timesteps, device)
    init_timestep = min(int(num_inference_steps * strength),
                        num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    return ts[t_start:], t_start
