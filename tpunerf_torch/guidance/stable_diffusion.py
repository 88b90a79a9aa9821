"""StableDiffusion guidance backend — text-conditioned SDS in latent mode.

Holds the UNet, the VAE, the CLIP text tower, the tokenizer and the noise
schedule: CFG text embeddings (`get_text_embeds`), the SDS loss on rendered
latents or, in RGB mode, on renders encoded through the VAE
(`train_step_loss`), VAE encode/decode with the 0.18215 latent scaling,
and the fixed latent→RGB preview matrix. The DDIM sampling loops,
inversion and pretrained-weight loading come with later slices of the
port.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Union

import torch

from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance import vae as vae_lib
from tpunerf_torch.guidance.clip_text import (CLIPTextConfig, CLIPTextModel,
                                              make_tokenizer)
from tpunerf_torch.guidance.schedulers import NoiseSchedule
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.utils import (init_like_flax_, resolve_device,
                                 resolve_dtype)

# Fixed 4×3 latent→RGB preview matrix.
LINEAR_RGB_ESTIMATOR = torch.tensor([
    #   R       G       B
    [0.298, 0.207, 0.208],     # L1
    [0.187, 0.286, 0.173],     # L2
    [-0.158, 0.189, 0.264],    # L3
    [-0.184, -0.271, -0.473],  # L4
], dtype=torch.float32)

# The latent of a mid-grey image.
LATENT_GRAY = torch.tensor([0.9071, -0.7711, 0.7437, 0.1510],
                           dtype=torch.float32)


def latent_to_rgb_preview(latents: torch.Tensor) -> torch.Tensor:
    """Cheap latent→RGB linear preview, NHWC (..., 4) → (..., 3)."""
    return latents @ LINEAR_RGB_ESTIMATOR.to(latents)


def rgb_to_latent_init(rgb: torch.Tensor, regularizer: float = 1e-2
                       ) -> torch.Tensor:
    """Ridge-regularized pseudo-inverse of the preview matrix — the latent
    that previews as `rgb`."""
    A = LINEAR_RGB_ESTIMATOR.T.to(rgb)             # (3, 4)
    M = torch.linalg.pinv(A.T @ A + regularizer * torch.eye(4).to(rgb)) @ A.T
    return rgb @ M.T


ROADMAP_A8 = ("the loaders of pretrained SD weights are not ported yet: "
              "ROADMAP.md item A.8")


def _build(module_cls, cfg, device: torch.device,
           generator: Optional[torch.Generator]) -> torch.nn.Module:
    """Construct without PyTorch's own init (meta device), allocate on
    `device` and draw flax's init there: the 859M-parameter UNet is never
    initialised on the host."""
    with torch.device("meta"):
        module = module_cls(cfg)
    module = module.to_empty(device=device)
    return init_like_flax_(module, generator).requires_grad_(False).eval()


def init_text_positions_(text: CLIPTextModel,
                         generator: Optional[torch.Generator]
                         ) -> CLIPTextModel:
    """flax's N(0, 0.01²) position table, drawn after the rest."""
    with torch.no_grad():
        text.embeddings.position_embedding.weight.normal_(
            0.0, 0.01, generator=generator)
    return text


@dataclasses.dataclass
class VAEStack:
    """The frozen f32 VAE and the noise schedule every guidance backend
    holds (text-guided and depth-conditioned SD, Paint-by-Example), with the
    VAE's decode and encodes."""
    vae: vae_lib.AutoencoderKL
    sched: NoiseSchedule

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, 4) → [0, 1] images (B, 8h, 8w, 3)."""
        return vae_lib.decode_latents(self.vae, latents)

    def encode_imgs(self, imgs01: torch.Tensor,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """[0, 1] images (B, 8h, 8w, 3) → scaled latents, a sample of the
        posterior; differentiable to the images (the weights are
        frozen)."""
        return vae_lib.encode_imgs(self.vae, imgs01, noise=noise,
                                   generator=generator)

    @torch.no_grad()
    def encode_imgs_mode(self, imgs01: torch.Tensor) -> torch.Tensor:
        return vae_lib.encode_imgs_mode(self.vae, imgs01)


@dataclasses.dataclass
class SDStack(VAEStack):
    """The frozen parts both SD backends hold (this one and the
    depth-conditioned one): `VAEStack`'s, the UNet, the text tower and its
    tokenizer, with the text tower's CFG pair."""
    unet: UNet2DCondition
    text_encoder: CLIPTextModel
    tokenizer: object

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @torch.no_grad()
    def encode_text_ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, dtype=torch.int64,
                              device=self.device)
        return self.text_encoder(ids)

    def get_text_embeds(self, prompts: Union[str, Sequence[str]],
                        negative_prompts: Union[None, str,
                                                Sequence[str]] = None
                        ) -> torch.Tensor:
        """[uncond; cond] (2B, L, D) CFG pair. `negative_prompts` replaces
        the empty-string uncond branch."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if negative_prompts is None:
            negative_prompts = [""] * len(prompts)
        elif isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts] * len(prompts)
        cond = self.encode_text_ids(self.tokenizer(list(prompts)))
        uncond = self.encode_text_ids(self.tokenizer(list(negative_prompts)))
        return torch.cat([uncond, cond], dim=0)


@dataclasses.dataclass
class StableDiffusionGuidance(SDStack):
    latent_mode: bool = True
    min_step: int = 20            # int(1000·0.02)
    max_step: int = 980           # int(1000·0.98)
    latent_size: int = 64
    image_size: int = 512

    @classmethod
    def create(cls, tiny: bool = False, model_dir: Optional[Path] = None,
               latent_mode: bool = True,
               min_step: float = 0.02, max_step: float = 0.98,
               unet_dtype: str = "float32",
               device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None
               ) -> "StableDiffusionGuidance":
        """Build the UNet, the text tower and the VAE on `device` (CUDA
        unless the caller names another), random-initialised like flax from
        `generator`, in that order. `unet_dtype` is the weight/compute
        dtype of the frozen UNet ("auto" = bf16 on CUDA, f32 on the CPU);
        the VAE and the text tower stay f32."""
        if model_dir is not None:
            raise NotImplementedError(f"guide.model_dir: {ROADMAP_A8}")
        device = resolve_device(device)
        ucfg = UNetConfig.tiny() if tiny else UNetConfig.sd_v1()
        vcfg = vae_lib.VAEConfig.tiny() if tiny else vae_lib.VAEConfig.sd_v1()
        tcfg = CLIPTextConfig.tiny() if tiny else CLIPTextConfig.vit_l_14()
        latent_size, image_size = (16, 64) if tiny else (64, 512)
        unet = _build(UNet2DCondition, ucfg, device, generator)
        unet = unet.to(resolve_dtype(unet_dtype, device))
        text = init_text_positions_(
            _build(CLIPTextModel, tcfg, device, generator), generator)
        vae = _build(vae_lib.AutoencoderKL, vcfg, device, generator)
        tokenizer = make_tokenizer(model_dir, vocab_size=tcfg.vocab_size,
                                   max_length=tcfg.max_length)
        sched = NoiseSchedule.scaled_linear(device=device)
        return cls(unet=unet, vae=vae, text_encoder=text,
                   tokenizer=tokenizer, sched=sched, latent_mode=latent_mode,
                   min_step=int(sched.num_train_timesteps * min_step),
                   max_step=int(sched.num_train_timesteps * max_step),
                   latent_size=latent_size, image_size=image_size)

    # ------------------------------------------------------------------ #
    def unet_apply(self, latents: torch.Tensor, t: torch.Tensor,
                   context: torch.Tensor) -> torch.Tensor:
        return self.unet(latents, t, context)

    # ------------------------------------------------------------------ #
    def train_step_loss(self, text_embeddings: torch.Tensor,
                        inputs: torch.Tensor, guidance_scale: float = 100.0,
                        t: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        vae_noise: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """SDS loss on rendered latents (B, H, W, 4), or in RGB mode on
        renders (B, H, W, 3) in [0, 1]: those are resized bilinearly to
        `image_size` and encoded through the VAE (a sample of the posterior,
        differentiable to the render) first. The gradient w.r.t. the latents
        is w·(ε̂ − ε). The draws — in RGB mode the posterior's standard
        normal `vae_noise` (B, image_size/8, image_size/8, 4), then `t` and
        `noise` — are taken from `generator` unless given, in that
        order."""
        if self.latent_mode:
            latents = inputs
        else:
            rgb = texk.resize_bilinear(inputs, self.image_size,
                                       self.image_size)
            latents = self.encode_imgs(rgb, noise=vae_noise,
                                       generator=generator)
        return sds_lib.sds_loss(self.unet_apply, self.sched, latents,
                                text_embeddings, guidance_scale,
                                self.min_step, self.max_step, t=t,
                                noise=noise, generator=generator)
