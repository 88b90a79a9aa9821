"""Score Distillation Sampling (and Delta Denoising Score) as a
differentiable scalar.

    loss = Σ latents · sg(w·(ε̂ − ε))

so the gradient of the render → loss composition w.r.t. the latents is
exactly w·(ε̂ − ε) (DDS: w·(ε̂ − ε̂_ref)). The UNet runs under
`torch.no_grad`. Every random draw (t, ε) can be passed in; otherwise it
comes from `generator`.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from tpunerf_torch.guidance.schedulers import NoiseSchedule


def sample_timestep(min_step: int, max_step: int, device: torch.device,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """t ~ U{min_step, …, max_step}, a 0-dim int64 tensor."""
    return torch.randint(min_step, max_step + 1, (), generator=generator,
                         device=device)


def step_draws(order: Sequence[Tuple[str, str, Optional[Tuple[int, ...]]]],
               given: Mapping[str, Optional[torch.Tensor]], min_step: int,
               max_step: int, device: torch.device,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """A training step's random draws, made up front in the order the step
    uses them: for each (name, kind, shape) of `order`, `given[name]` where
    it is there and not None, else a draw from `generator` — kind
    "timestep": `sample_timestep`; "uniform": U[0, 1) of `shape`;
    "normal": N(0, 1) of `shape`. Other entries of `given` are kept."""
    out = {k: v for k, v in given.items() if v is not None}
    for name, kind, shape in order:
        if name in out:
            continue
        if kind == "timestep":
            out[name] = sample_timestep(min_step, max_step, device,
                                        generator)
        elif kind == "uniform":
            out[name] = torch.rand(shape, generator=generator, device=device)
        else:
            out[name] = torch.randn(shape, generator=generator,
                                    device=device)
    return out


def cfg_eps(unet_apply: Callable, latents_noisy: torch.Tensor,
            t: torch.Tensor, text_embeddings: torch.Tensor,
            guidance_scale: float) -> torch.Tensor:
    """Classifier-free-guided ε̂ from one batched [uncond; cond] UNet pass.
    text_embeddings is (2B, L, D) with the uncond half first."""
    B = latents_noisy.shape[0]
    eps = unet_apply(torch.cat([latents_noisy] * 2), t, text_embeddings)
    eps_uncond, eps_text = eps[:B], eps[B:]
    return eps_uncond + guidance_scale * (eps_text - eps_uncond)


def score_gradient(unet_apply: Callable, sched: NoiseSchedule,
                   latents: torch.Tensor, text_embeddings: torch.Tensor,
                   guidance_scale: float = 100.0, min_step: int = 20,
                   max_step: int = 980, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw SDS latent gradient w·(ε̂ − ε) (no autograd history) and the
    timestep t used."""
    with torch.no_grad():
        lat = latents.detach()
        if t is None:
            t = sample_timestep(min_step, max_step, lat.device, generator)
        t = torch.as_tensor(t, dtype=torch.int64, device=lat.device)
        if noise is None:
            noise = torch.randn(lat.shape, generator=generator,
                                device=lat.device)
        noise = noise.to(lat)
        latents_noisy = sched.add_noise(lat, noise, t)
        eps_hat = cfg_eps(unet_apply, latents_noisy, t, text_embeddings,
                          guidance_scale)
        w = sched.sds_weight(t)
        return w * (eps_hat - noise), t


def nan_guard(grad: torch.Tensor) -> torch.Tensor:
    """NaN → 0, ±inf → the dtype's largest finite values (the depth
    backend's guard on its SDS gradient)."""
    return torch.nan_to_num(grad)


def sds_loss(unet_apply: Callable, sched: NoiseSchedule,
             latents: torch.Tensor, text_embeddings: torch.Tensor,
             guidance_scale: float = 100.0, min_step: int = 20,
             max_step: int = 980, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scalar whose gradient w.r.t. `latents` is exactly w·(ε̂ − ε)."""
    grad, _ = score_gradient(unet_apply, sched, latents, text_embeddings,
                             guidance_scale, min_step, max_step, t=t,
                             noise=noise, generator=generator)
    return torch.sum(latents * grad)


def dds_loss(unet_apply: Callable, sched: NoiseSchedule,
             latents: torch.Tensor, ref_latents: torch.Tensor,
             text_embeddings: torch.Tensor,
             ref_text_embeddings: torch.Tensor, guidance_scale: float = 7.5,
             min_step: int = 20, max_step: int = 980,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Delta Denoising Score: a scalar whose gradient w.r.t. `latents` is
    w·(ε̂ − ε̂_ref), the reference branch's CFG score (`ref_latents` under
    `ref_text_embeddings`) subtracted, which cancels the prompt-independent
    part. One t and one noise serve both branches, drawn from `generator`
    unless given (t, then noise); w has the "sqrt" form."""
    with torch.no_grad():
        lat, ref = latents.detach(), ref_latents.detach()
        if t is None:
            t = sample_timestep(min_step, max_step, lat.device, generator)
        t = torch.as_tensor(t, dtype=torch.int64, device=lat.device)
        if noise is None:
            noise = torch.randn(lat.shape, generator=generator,
                                device=lat.device)
        noise = noise.to(lat)
        eps_cur = cfg_eps(unet_apply, sched.add_noise(lat, noise, t), t,
                          text_embeddings, guidance_scale)
        eps_ref = cfg_eps(unet_apply, sched.add_noise(ref, noise, t), t,
                          ref_text_embeddings, guidance_scale)
        grad = sched.sds_weight(t, form="sqrt") * (eps_cur - eps_ref)
    return torch.sum(latents * grad)
