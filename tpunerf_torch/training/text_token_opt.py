"""Optimised text tokens: fit a prompt's token embeddings to a reference
image.

Gradient descent on the token embeddings of a prompt (before the CLIP text
transformer) so that images sampled from them match a reference image under
a CLIP image loss, differentiating through a short DDIM chain of the full
UNet and the VAE decode (`through_sampling`), or against the pooled text
embedding (the cheap proxy). On the card the chain's backward runs the
attention kernels #12 and #13 at the UNet's 64² self-attention.

The trainer does not call this: `optim.use_opt_txt` stays refused, as the
JAX package's trainer never reads that flag (training/trainer.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance import vae as vae_lib
from tpunerf_torch.guidance.clip_vision import clip_preprocess
from tpunerf_torch.guidance.schedulers import ddim_step, ddim_timesteps
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance


def encode_text_embedding(guidance: StableDiffusionGuidance,
                          token_embeddings: torch.Tensor) -> torch.Tensor:
    """(B, L, D) token embeddings → the text tower's (B, L, D_ctx) output,
    differentiable to the embeddings."""
    return guidance.text_encoder(None, input_embeddings=token_embeddings)


def initial_token_embeddings(guidance: StableDiffusionGuidance,
                             prompt: str) -> torch.Tensor:
    """(1, L, D) token-table rows of the prompt's ids."""
    table = guidance.text_encoder.embeddings.token_embedding.weight
    ids = torch.as_tensor(guidance.tokenizer([prompt]), dtype=torch.int64,
                          device=table.device)
    return table.detach()[ids].clone()


def _unit(z: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    norm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z / (norm.clamp(min=floor) if floor else norm)


def text_token_loss(guidance: StableDiffusionGuidance,
                    clip_embed_fn: Callable, ref_z: torch.Tensor,
                    uncond: torch.Tensor, tok_emb: torch.Tensor,
                    latents: torch.Tensor, num_sample_steps: int = 4,
                    guidance_scale: float = 7.5,
                    through_sampling: bool = True,
                    clip_size: int = 224) -> torch.Tensor:
    """−cos(z, ref_z) for the token embeddings `tok_emb` (1, L, D): z is the
    CLIP embedding of the image that `num_sample_steps` CFG DDIM steps from
    `latents` (1, h, h, 4) and the VAE decode give (`through_sampling`), or
    the pooled text embedding cut or zero-padded to ref_z's width."""
    ctx = encode_text_embedding(guidance, tok_emb)
    if through_sampling:
        emb = torch.cat([uncond, ctx])
        lat = latents
        for t in ddim_timesteps(num_sample_steps, device=lat.device):
            eps = sds_lib.cfg_eps(guidance.unet_apply, lat, t, emb,
                                  guidance_scale)
            lat = ddim_step(guidance.sched, eps, t, lat,
                            num_sample_steps).prev_sample
        img = vae_lib.decode_latents(guidance.vae, lat)
        z = clip_embed_fn(clip_preprocess(img, clip_size))
    else:
        z = ctx.mean(dim=1)
        width = ref_z.shape[-1]
        z = (z[..., :width] if z.shape[-1] >= width
             else torch.nn.functional.pad(z, (0, width - z.shape[-1])))
    z = _unit(z, 1e-8)
    return -torch.mean(torch.sum(z * ref_z, dim=-1))


def optimize_text_token(
        guidance: StableDiffusionGuidance,
        clip_embed_fn: Callable,          # [0,1] NHWC → (B, D) embeddings
        ref_image01: torch.Tensor,        # (1, H, W, 3)
        prompt: str,
        num_steps: int = 100,
        lr: float = 1e-3,
        num_sample_steps: int = 4,
        guidance_scale: float = 7.5,
        through_sampling: bool = True,
        clip_size: int = 224,
        latents: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        on_step: Optional[Callable[[int, torch.Tensor], None]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (optimised token embeddings (1, L, D), the final CFG context
    (2, L, D_ctx)). Adam (optax's defaults: β = 0.9, 0.999, ε = 1e-8) on the
    prompt's token embeddings for `num_steps` steps of `text_token_loss`;
    step i starts the chain from `latents[i]` (1, h, h, 4), drawn from
    `generator` unless given. `on_step(i, loss)` is called after each
    update."""
    with torch.no_grad():
        uncond = guidance.get_text_embeds([""])[0:1]
        ref_z = _unit(clip_embed_fn(clip_preprocess(ref_image01, clip_size)))
    tok = initial_token_embeddings(guidance, prompt).requires_grad_(True)
    opt = torch.optim.Adam([tok], lr=lr)
    h = guidance.latent_size
    for i in range(num_steps):
        lat = (latents[i] if latents is not None else torch.randn(
            (1, h, h, 4), generator=generator, device=tok.device))
        with torch.enable_grad():
            loss = text_token_loss(guidance, clip_embed_fn, ref_z, uncond,
                                   tok, lat.to(tok.device), num_sample_steps,
                                   guidance_scale, through_sampling,
                                   clip_size)
            (tok.grad,) = torch.autograd.grad(loss, tok)
        opt.step()
        if on_step is not None:
            on_step(i, loss.detach())
    tok = tok.detach()
    with torch.no_grad():
        ctx = encode_text_embedding(guidance, tok)
    return tok, torch.cat([uncond, ctx])
