"""Paint-by-Example guidance: diffusion conditioned on an exemplar image.

A 9-channel inpainting UNet on [noisy latent, masked latent, mask],
conditioned on one exemplar embedding from `PaintByExampleImageEncoder`
(the CLIP vision tower → a mapper of 1-head transformer blocks → LayerNorm
→ projection), with a learned unconditional embedding for classifier-free
guidance.

`train_step_loss` is SDS on masked latents: the foreground filled with the
grey latent, the narrow t ∈ [0.2, 0.6] window, w = 1 − ᾱ_t; with
`use_clip`, a drawn t ≤ 0.4·T takes the CLIP branch instead (one
full-schedule DDIM step from the noised latents, the VAE decode and the
CLIP image loss against the exemplar, differentiated back to the latents).
`latent_forward` and `forward` are the DDIM inpainting samplers in latent
and image space; `approx_latent2rgb` fits a 4×3 latent→RGB matrix. The
stack is read from a diffusers-layout directory (`model_dir`: unet/, vae/,
image_encoder/) or random-initialised from a generator. Every random draw
can be passed in; otherwise it comes from `generator`, in the order each
method lists.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance import vae as vae_lib
from tpunerf_torch.guidance import weights
from tpunerf_torch.guidance.clip_vision import (CLIPVisionConfig,
                                                CLIPVisionModel,
                                                clip_preprocess,
                                                img_clip_loss,
                                                init_vision_embeddings_)
from tpunerf_torch.guidance.schedulers import (NoiseSchedule, ddim_step,
                                               ddim_timesteps)
from tpunerf_torch.guidance.stable_diffusion import (LATENT_GRAY, VAEStack,
                                                     _build, _on_meta)
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.utils import resolve_device, resolve_dtype

CLIP_LOSS_WEIGHT = 10.0


def pbe_num_mapper_blocks(vision_config: CLIPVisionConfig) -> int:
    """The mapper's depth, (num_layers + 1) // 5: 5 blocks for ViT-L, at
    least 1."""
    return max(1, (vision_config.num_layers + 1) // 5)


class MapperAttention(nn.Module):
    """One head with biased q, k, v; the scale on the logits."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        attn = torch.softmax(torch.einsum("bqd,bkd->bqk", q, k)
                             * (x.shape[-1] ** -0.5), dim=-1)
        return self.to_out[0](torch.einsum("bqk,bkd->bqd", attn, v))


class GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x))          # exact (erf)


class MapperBlock(nn.Module):
    """Pre-norm self-attention and an exact-GELU feed-forward (diffusers'
    `BasicTransformerBlock` without cross-attention: `norm1`, `attn1`,
    `norm3`, `ff.net.0.proj`, `ff.net.2`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = MapperAttention(dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GELUProj(dim, 4 * dim), nn.Identity(),
                                     nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        h = self.norm3(x)
        for layer in self.ff.net:
            h = layer(h)
        return x + h


class PaintByExampleImageEncoder(nn.Module):
    """The CLIP vision tower (`model`), the mapper (`mapper.blocks`),
    `final_layer_norm`, `proj_out` and the learned `uncond_vector`: the
    names of diffusers' `PaintByExampleImageEncoder`."""

    def __init__(self, vision_config: CLIPVisionConfig, proj_dim: int = 768):
        super().__init__()
        D = vision_config.hidden_size
        self.model = CLIPVisionModel(vision_config)
        self.mapper = nn.Module()
        self.mapper.blocks = nn.ModuleList(
            MapperBlock(D) for _ in range(pbe_num_mapper_blocks(
                vision_config)))
        self.final_layer_norm = nn.LayerNorm(D, eps=1e-5)
        self.proj_out = nn.Linear(D, proj_dim)
        self.uncond_vector = nn.Parameter(torch.empty(1, 1, proj_dim))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) CLIP-normalised → (B, 1, proj_dim) condition."""
        x = self.model(pixel_values)[:, None, :]
        for block in self.mapper.blocks:
            x = block(x)
        return self.proj_out(self.final_layer_norm(x))


@dataclasses.dataclass
class PaintByExampleGuidance(VAEStack):
    """`unet` takes 9 channels, [noisy latent, masked latent, mask], with
    the exemplar's (2, 1, D) [uncond; cond] embedding as its context; the
    VAE's decode and encodes are `VAEStack`'s."""
    unet: UNet2DCondition
    image_encoder: PaintByExampleImageEncoder
    min_step: int = 200            # t ∈ [0.2, 0.6]·T, whatever optim says
    max_step: int = 600
    latent_size: int = 64
    image_size: int = 512

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @classmethod
    def create(cls, tiny: bool = False, model_dir=None,
               unet_dtype: str = "float32",
               device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None
               ) -> "PaintByExampleGuidance":
        """Build the 9-channel UNet (in `unet_dtype`: "auto" = bf16 on CUDA,
        f32 on the CPU), the f32 VAE and the exemplar encoder (ViT-L/14,
        f32) on `device` (CUDA unless the caller names another): read from
        the diffusers-layout `model_dir` where one is given, else
        random-initialised like flax from `generator`, in that order (the
        encoder's class token, positions and `uncond_vector`, N(0, 0.02²),
        after its layers)."""
        device = resolve_device(device)
        if tiny:
            ucfg = UNetConfig.tiny(in_channels=9)
            vcfg = vae_lib.VAEConfig.tiny()
            vis, proj = CLIPVisionConfig.tiny(), 32
            latent_size, image_size = 16, 64
        else:
            ucfg = UNetConfig.sd_v1(in_channels=9)
            vcfg = vae_lib.VAEConfig.sd_v1()
            vis, proj = CLIPVisionConfig.vit_l_14(), 768
            latent_size, image_size = 64, 512
        dtype = resolve_dtype(unet_dtype, device)

        def encoder(c):
            return PaintByExampleImageEncoder(c, proj)

        if model_dir is not None:
            unet, vae, enc = weights.load_pbe_params(
                model_dir, _on_meta(UNet2DCondition, ucfg, dtype),
                _on_meta(vae_lib.AutoencoderKL, vcfg), _on_meta(encoder, vis),
                device)
        else:
            unet = _build(UNet2DCondition, ucfg, device, generator).to(dtype)
            vae = _build(vae_lib.AutoencoderKL, vcfg, device, generator)
            enc = _build(encoder, vis, device, generator)
            init_vision_embeddings_(enc.model.vision_model, generator)
            with torch.no_grad():
                enc.uncond_vector.normal_(0.0, 0.02, generator=generator)
        sched = NoiseSchedule.scaled_linear(device=device)
        T = sched.num_train_timesteps
        return cls(vae=vae, sched=sched, unet=unet, image_encoder=enc,
                   min_step=int(T * 0.2), max_step=int(T * 0.6),
                   latent_size=latent_size, image_size=image_size)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def encode_exemplar(self, image01: torch.Tensor) -> torch.Tensor:
        """An exemplar (1, H, W, 3) in [0, 1] → (2, 1, D) [uncond; cond]."""
        enc = self.image_encoder
        px = clip_preprocess(image01.to(self.device),
                             enc.model.config.image_size)
        cond = enc(px)
        return torch.cat([enc.uncond_vector.expand_as(cond), cond], dim=0)

    @torch.no_grad()
    def _unet_9ch(self, latents_noisy: torch.Tensor,
                  masked_latents: torch.Tensor, mask64: torch.Tensor,
                  t: torch.Tensor, image_embeds: torch.Tensor,
                  guidance_scale: float) -> torch.Tensor:
        """ε̂ from one [uncond; cond] pass of the UNet on [noisy latent,
        masked latent, mask] (this channel order, not the depth backend's
        inpainting [latent, mask, masked latent])."""
        B = latents_noisy.shape[0]
        inp = torch.cat([latents_noisy, masked_latents.to(latents_noisy),
                         mask64.to(latents_noisy)], dim=-1)
        ctx = image_embeds.repeat_interleave(B, dim=0)  # [uncond×B; cond×B]
        return sds_lib.cfg_eps(self.unet, inp, t, ctx, guidance_scale)

    def takes_clip_branch(self, t: torch.Tensor) -> bool:
        """With `use_clip`, whether a drawn t takes the CLIP branch
        (t ≤ 0.4·T; reads t on the host)."""
        return int(t) <= (4 * self.sched.num_train_timesteps) // 10

    def train_step_loss(self, latents: torch.Tensor, mask: torch.Tensor,
                        image_embeds: torch.Tensor,
                        guidance_scale: float = 7.5, use_clip: bool = False,
                        clip_embed_fn: Optional[Callable] = None,
                        ref_image01: Optional[torch.Tensor] = None,
                        clip_image_size: int = 224,
                        t: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        clip_branch: Optional[bool] = None
                        ) -> torch.Tensor:
        """SDS on masked latents (B, h, w, 4); `mask` (B, h, w, 1) is 1 on
        the foreground, which is filled with the grey latent, and the UNet's
        mask channel is the keep mask 1 − mask. The SDS branch returns
        Σ latents·sg(nan_guard(w·(ε̂ − ε))), w = 1 − ᾱ_t. With `use_clip`
        and t ≤ 0.4·T, the CLIP branch returns 10 · img_clip_loss(decode(
        ddim_step(ε̂, add_noise(latents, ε, t))), ref_image01), with the
        gradient through the noising, the DDIM step (ε̂ held), the VAE
        decode and `clip_embed_fn`. A caller that has read the branch of
        its t already passes it as `clip_branch`; otherwise t is read on the
        host here. Draws: `t`, then `noise`."""
        with torch.no_grad():
            lat = latents.detach()
            if t is None:
                t = sds_lib.sample_timestep(self.min_step, self.max_step,
                                            lat.device, generator)
            t = torch.as_tensor(t, dtype=torch.int64, device=lat.device)
            if noise is None:
                noise = torch.randn(lat.shape, generator=generator,
                                    device=lat.device)
            noise = noise.to(lat)
            mask = mask.to(lat)
            masked = lat * (1 - mask) + LATENT_GRAY.to(lat) * mask
            lat_noisy = self.sched.add_noise(lat, noise, t)
            eps_hat = self._unet_9ch(lat_noisy, masked, 1.0 - mask, t,
                                     image_embeds, guidance_scale)
        if use_clip:
            if clip_embed_fn is None or ref_image01 is None:
                raise ValueError("use_clip needs clip_embed_fn and "
                                 "ref_image01")
            if clip_branch is None:
                clip_branch = self.takes_clip_branch(t)
            if clip_branch:
                lat_noisy_g = self.sched.add_noise(latents, noise, t)
                prev = ddim_step(self.sched, eps_hat, t, lat_noisy_g,
                                 self.sched.num_train_timesteps).prev_sample
                imgs = vae_lib.decode_latents(self.vae, prev)
                return CLIP_LOSS_WEIGHT * img_clip_loss(
                    clip_embed_fn, imgs, ref_image01, size=clip_image_size)
        with torch.no_grad():
            w = self.sched.sds_weight(t, form="sigma2")
            grad = sds_lib.nan_guard(w * (eps_hat - noise))
        return torch.sum(latents * grad)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def latent_forward(self, latents: torch.Tensor, mask: torch.Tensor,
                       image_embeds: torch.Tensor,
                       num_inference_steps: int = 50,
                       guidance_scale: float = 7.5, strength: float = 1.0,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """Latent-space DDIM inpainting over the last `strength` of the
        grid. One draw, `noise`, is both the start (strength 1) and the
        renoising of `latents` to the first step (strength < 1), as the JAX
        package draws both from one key."""
        dev = latents.device
        masked = latents * (1 - mask) + LATENT_GRAY.to(latents) * mask
        start = int(num_inference_steps * (1.0 - strength))
        ts = ddim_timesteps(num_inference_steps, device=dev)[start:]
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev)
        lat = noise.to(latents)
        if start > 0:
            lat = self.sched.add_noise(latents, lat, ts[0])
        for t in ts:
            eps = self._unet_9ch(lat, masked, 1.0 - mask, t, image_embeds,
                                 guidance_scale)
            lat = ddim_step(self.sched, eps, t, lat,
                            num_inference_steps).prev_sample
        return lat

    @torch.no_grad()
    def forward(self, image01: torch.Tensor, mask: torch.Tensor,
                exemplar01: torch.Tensor, num_inference_steps: int = 50,
                guidance_scale: float = 7.5,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Image-space inpainting: the mode encode of `image01`, the mask
        resized nearest to the latent grid, `latent_forward` from pure noise
        and the decode. Draw: `noise`."""
        latents = self.encode_imgs_mode(image01)
        h = latents.shape[1]
        mask_lat = texk.resize_nearest(mask, h, h)
        out = self.latent_forward(latents, mask_lat,
                                  self.encode_exemplar(exemplar01),
                                  num_inference_steps, guidance_scale,
                                  noise=noise, generator=generator)
        return self.decode_latents(out)


def approx_latent2rgb(latents: torch.Tensor, rgbs: torch.Tensor,
                      regularizer: float = 1e-3) -> torch.Tensor:
    """A 4×3 latent→RGB matrix by ridge regression: latents (N, 4), rgbs
    (N, 3)."""
    A = latents
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    return torch.linalg.pinv(A.T @ A + regularizer * eye) @ A.T @ rgbs
