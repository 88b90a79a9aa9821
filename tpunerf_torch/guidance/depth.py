"""Depth-conditioned Stable Diffusion guidance (the SD2-depth family).

A 5-channel UNet ([latent, depth]) with a 1024-wide text context, its own
text tower (hidden 1024, 16 heads, 23 layers, quick-GELU) and VAE; SDS with
w = 1 − ᾱ_t and a NaN guard (`train_step_loss`); single-step and masked
iterative img2img (`img2img_single_step`, `img2img_step`: strength-truncated
DDIM walk, update and check masks, and inside the inpaint window the
9-channel inpainting UNet on [latent, mask, masked latent]); depth-channel
txt2img (`prompt_to_img`). The stack is read from diffusers-layout
directories (`model_dir`, the inpainting UNet's `inpaint_model_dir`) or
random-initialised from a generator. Every random draw can be passed in;
otherwise it comes from `generator`, in the order each method lists.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance import vae as vae_lib
from tpunerf_torch.guidance import weights
from tpunerf_torch.guidance.clip_text import (CLIPTextConfig, CLIPTextModel,
                                              make_tokenizer)
from tpunerf_torch.guidance.schedulers import (NoiseSchedule, ddim_step,
                                               ddim_timesteps,
                                               strength_timesteps)
from tpunerf_torch.guidance.stable_diffusion import (
    SDStack, _build, _on_meta, init_text_positions_)
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.utils import resolve_device, resolve_dtype

TEXT_WIDE = CLIPTextConfig(hidden_size=1024, num_heads=16,
                           intermediate_size=4096, num_layers=23)


def normalize_depth(depth: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth (B, H, W, 1) → [−1, 1] over each view's valid region (mask >
    0). A view with an empty mask has lo = +inf, hi = −inf, as in the JAX
    package."""
    dims = (1, 2, 3)
    if mask is None:
        lo = depth.amin(dim=dims, keepdim=True)
        hi = depth.amax(dim=dims, keepdim=True)
    else:
        inf = torch.tensor(float("inf"), dtype=depth.dtype,
                           device=depth.device)
        lo = torch.where(mask > 0, depth, inf).amin(dim=dims, keepdim=True)
        hi = torch.where(mask > 0, depth, -inf).amax(dim=dims, keepdim=True)
    d = (depth - lo) / torch.clamp(hi - lo, min=1e-6)
    return d * 2.0 - 1.0


@dataclasses.dataclass
class StableDiffusionDepthGuidance(SDStack):
    """`unet` takes 5 channels, [latent, depth]; the text tower's CFG pair
    (2B, L, 1024) and the VAE's decode and encode are `SDStack`'s."""
    min_step: int = 20
    max_step: int = 980
    latent_size: int = 64
    image_size: int = 512
    # the 9-channel inpainting UNet ([latent, mask, masked latent]) of the
    # img2img inpaint window
    inpaint_unet: Optional[UNet2DCondition] = None

    @classmethod
    def create(cls, tiny: bool = False, model_dir=None,
               min_step: float = 0.02, max_step: float = 0.98,
               use_inpaint: bool = False, inpaint_model_dir=None,
               unet_dtype: str = "float32",
               device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None
               ) -> "StableDiffusionDepthGuidance":
        """Build the depth UNet, the text tower, the VAE and (with
        `use_inpaint`) the inpainting UNet on `device` (CUDA unless the
        caller names another): the first three read from the
        diffusers-layout `model_dir` (its tokenizer too, where it has one)
        and the inpainting UNet from `inpaint_model_dir` where they are
        given, else random-initialised like flax from `generator` in that
        order. `unet_dtype` is the UNets' weight and compute dtype ("auto" =
        bf16 on CUDA, f32 on the CPU); the VAE and the text tower stay
        f32."""
        device = resolve_device(device)
        if tiny:
            ucfg = UNetConfig.tiny(in_channels=5)
            vcfg = vae_lib.VAEConfig.tiny()
            tcfg = CLIPTextConfig.tiny()
            latent_size, image_size = 16, 64
        else:
            ucfg = dataclasses.replace(UNetConfig.sd_v1(in_channels=5),
                                       cross_attention_dim=1024)
            vcfg = vae_lib.VAEConfig.sd_v1()
            tcfg = TEXT_WIDE
            latent_size, image_size = 64, 512
        dtype = resolve_dtype(unet_dtype, device)
        if model_dir is not None:
            unet, vae, text = weights.load_sd_params(
                model_dir, _on_meta(UNet2DCondition, ucfg, dtype),
                _on_meta(vae_lib.AutoencoderKL, vcfg),
                _on_meta(CLIPTextModel, tcfg), device)
        else:
            unet = _build(UNet2DCondition, ucfg, device, generator).to(dtype)
            text = init_text_positions_(
                _build(CLIPTextModel, tcfg, device, generator), generator)
            vae = _build(vae_lib.AutoencoderKL, vcfg, device, generator)
        inpaint = None
        icfg = dataclasses.replace(ucfg, in_channels=9)
        if use_inpaint and inpaint_model_dir is not None:
            inpaint = weights.load_unet_params(
                inpaint_model_dir, _on_meta(UNet2DCondition, icfg, dtype),
                device)
        elif use_inpaint:
            inpaint = _build(UNet2DCondition, icfg, device,
                             generator).to(dtype)
        sched = NoiseSchedule.scaled_linear(device=device)
        return cls(unet=unet, vae=vae, text_encoder=text,
                   tokenizer=make_tokenizer(model_dir,
                                            vocab_size=tcfg.vocab_size,
                                            max_length=tcfg.max_length),
                   sched=sched,
                   min_step=int(sched.num_train_timesteps * min_step),
                   max_step=int(sched.num_train_timesteps * max_step),
                   latent_size=latent_size, image_size=image_size,
                   inpaint_unet=inpaint)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _cfg_eps_depth(self, latents_noisy: torch.Tensor,
                       depth64: torch.Tensor, t: torch.Tensor,
                       text_embeddings: torch.Tensor, guidance_scale: float
                       ) -> torch.Tensor:
        """ε̂ from one [uncond; cond] pass of the depth UNet on
        [latent, depth]."""
        inp = torch.cat([latents_noisy, depth64.to(latents_noisy)], dim=-1)
        return sds_lib.cfg_eps(self.unet, inp, t, text_embeddings,
                               guidance_scale)

    @torch.no_grad()
    def _cfg_eps_inpaint(self, latents_noisy: torch.Tensor,
                         mask64: torch.Tensor, masked_latents: torch.Tensor,
                         t: torch.Tensor, text_embeddings: torch.Tensor,
                         guidance_scale: float) -> torch.Tensor:
        """ε̂ from one [uncond; cond] pass of the inpainting UNet on
        [latent, mask, masked latent]."""
        inp = torch.cat([latents_noisy, mask64.to(latents_noisy),
                         masked_latents.to(latents_noisy)], dim=-1)
        return sds_lib.cfg_eps(self.inpaint_unet, inp, t, text_embeddings,
                               guidance_scale)

    def train_step_loss(self, text_embeddings: torch.Tensor,
                        latents: torch.Tensor, depth: torch.Tensor,
                        guidance_scale: float = 100.0,
                        t: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """SDS with depth conditioning: Σ latents·sg(nan_guard(w·(ε̂ − ε))),
        w = 1 − ᾱ_t. `depth` (B, H, W, 1) is resized bilinearly (JAX's
        weights) to the latents' grid. Draws: `t`, then `noise`."""
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
            lat_noisy = self.sched.add_noise(lat, noise, t)
            depth64 = texk.resize_bilinear(depth, lat.shape[1], lat.shape[2])
            eps_hat = self._cfg_eps_depth(lat_noisy, depth64, t,
                                          text_embeddings, guidance_scale)
            w = self.sched.sds_weight(t, form="sigma2")
            grad = sds_lib.nan_guard(w * (eps_hat - noise))
        return torch.sum(latents * grad)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def img2img_single_step(self, text_embeddings: torch.Tensor,
                            latents: torch.Tensor, depth64: torch.Tensor,
                            step: int, num_inference_steps: int = 50,
                            guidance_scale: float = 7.5,
                            noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
        """Noise the latents to the grid's `step`-th level, predict, take
        the DDIM step back: (prev_sample, pred_x0). Draw: `noise`."""
        t = ddim_timesteps(num_inference_steps, device=latents.device)[step]
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=latents.device)
        lat_noisy = self.sched.add_noise(latents, noise.to(latents), t)
        eps = self._cfg_eps_depth(lat_noisy, depth64, t, text_embeddings,
                                  guidance_scale)
        out = ddim_step(self.sched, eps, t, lat_noisy, num_inference_steps)
        return out.prev_sample, out.pred_x0

    @torch.no_grad()
    def img2img_step(self, text_embeddings: torch.Tensor,
                     latents: torch.Tensor, depth64: torch.Tensor,
                     update_mask: Optional[torch.Tensor] = None,
                     check_mask: Optional[torch.Tensor] = None,
                     num_inference_steps: int = 50,
                     guidance_scale: float = 7.5, strength: float = 0.8,
                     inpaint_lo: int = 10, inpaint_hi: int = 20,
                     check_mask_iters: float = 0.5,
                     masked_latents: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     start: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Masked iterative img2img: the strength-truncated DDIM walk.

        At step i, outside the inpaint window, the region where the current
        mask is 0 is set back to the original latents noised to that step;
        the current mask is `check_mask` for the first `check_mask_iters`
        of the steps and `update_mask` after. Inside the window
        (inpaint_lo < i < inpaint_hi), when the inpainting UNet exists and
        `masked_latents` and `update_mask` are given, the latents are left
        as they are and that UNet predicts the noise on [latent,
        update_mask, masked_latents]. With `update_mask` the walk starts
        from pure noise. Draws: `noise` (the re-noising of the original),
        then, with `update_mask`, `start`."""
        dev = latents.device
        ts, _ = strength_timesteps(num_inference_steps, strength,
                                   device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev)
        noise = noise.to(latents)
        if update_mask is not None:
            if start is None:
                start = torch.randn(latents.shape, generator=generator,
                                    device=dev)
            lat = start.to(latents)
        else:
            lat = self.sched.add_noise(latents, noise, ts[0])
        use_inpaint = (self.inpaint_unet is not None
                       and masked_latents is not None
                       and update_mask is not None)
        n_check = int(len(ts) * check_mask_iters)
        for i, t in enumerate(ts):
            in_window = use_inpaint and inpaint_lo < i < inpaint_hi
            if update_mask is not None and not in_window:
                noised_truth = self.sched.add_noise(latents, noise, t)
                curr = (check_mask if check_mask is not None and i < n_check
                        else update_mask)
                lat = lat * curr + noised_truth * (1 - curr)
            if in_window:
                eps = self._cfg_eps_inpaint(lat, update_mask, masked_latents,
                                            t, text_embeddings,
                                            guidance_scale)
            else:
                eps = self._cfg_eps_depth(lat, depth64, t, text_embeddings,
                                          guidance_scale)
            lat = ddim_step(self.sched, eps, t, lat,
                            num_inference_steps).prev_sample
        return lat

    @torch.no_grad()
    def prompt_to_img(self, prompts: Union[str, Sequence[str]],
                      depth: torch.Tensor, num_inference_steps: int = 50,
                      guidance_scale: float = 7.5,
                      latents: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Depth-conditioned txt2img: the DDIM walk from pure noise, decoded
        to [0, 1] images. Draw: the starting `latents`."""
        emb = self.get_text_embeds(prompts)
        B, n = emb.shape[0] // 2, self.latent_size
        if latents is None:
            latents = torch.randn((B, n, n, 4), generator=generator,
                                  device=self.device)
        lat = latents.to(self.device, torch.float32)
        depth64 = texk.resize_bilinear(depth, n, n)
        for t in ddim_timesteps(num_inference_steps, device=self.device):
            eps = self._cfg_eps_depth(lat, depth64, t, emb, guidance_scale)
            lat = ddim_step(self.sched, eps, t, lat,
                            num_inference_steps).prev_sample
        return self.decode_latents(lat)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def encode_masked_inputs(self, imgs01: torch.Tensor,
                             update_mask: torch.Tensor,
                             noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
        """The inpainting UNet's masked latents: the update region (mask,
        resized nearest to the images) filled with mid-grey, then encoded.
        Draw: the posterior's `noise`."""
        m = texk.resize_nearest(update_mask, imgs01.shape[1],
                                imgs01.shape[2])
        masked = torch.where(m < 0.5, imgs01, 0.5)
        return self.encode_imgs(masked, noise=noise, generator=generator)
