"""StableDiffusion guidance backend — text-conditioned SDS, samplers,
inversion.

Holds the UNet, the VAE, the CLIP text tower, the tokenizer and the noise
schedule: CFG text embeddings (`get_text_embeds`), the SDS loss on rendered
latents or, in RGB mode, on renders encoded through the VAE
(`train_step_loss`), the DDS loss (`train_step_delta_loss`), DDIM sampling
with a start-index skip (`produce_latents`, `embeds_to_img`,
`prompt_to_img`), DDIM inversion and null-text inversion (`invert`,
`null_optimization`), textual-inversion concept tokens (`load_concept*`),
VAE encode/decode with the 0.18215 latent scaling, and the fixed
latent→RGB preview matrix. `create(model_dir=...)` reads pretrained weights
from a diffusers-layout directory (guidance/weights.py); without one the
stack is random-initialised like flax.

The sampling and inversion loops run the UNet in the caller's grad mode:
`null_optimization` differentiates through it (the attention kernels'
backward on the card), as text-token optimisation does
(training/text_token_opt.py); the SDS and DDS losses keep it under
`no_grad`.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance import vae as vae_lib
from tpunerf_torch.guidance import weights
from tpunerf_torch.guidance.clip_text import (CLIPTextConfig, CLIPTextModel,
                                              make_tokenizer)
from tpunerf_torch.guidance.schedulers import (NoiseSchedule,
                                               ddim_inverse_step, ddim_step,
                                               ddim_timesteps)
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


CONCEPT_BPE_REFUSAL = (
    "guide.concept_name with a guide.model_dir that holds tokenizer/ "
    "(vocab.json, merges.txt): the BPE tokenizer takes no added token (in "
    "the JAX package the pair ends in an AttributeError)")


def _on_meta(module_cls, cfg, dtype: torch.dtype = torch.float32
             ) -> torch.nn.Module:
    """A module without storage, for `guidance/weights.py` to fill: no
    random draw and no init for a loaded module."""
    with torch.device("meta"):
        return module_cls(cfg).to(dtype)


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
        unless the caller names another): read from the diffusers-layout
        `model_dir` where one is given (its tokenizer too, where it has
        one), else random-initialised like flax from `generator`, in that
        order. `unet_dtype` is the weight/compute dtype of the frozen UNet
        ("auto" = bf16 on CUDA, f32 on the CPU); the VAE and the text tower
        stay f32."""
        device = resolve_device(device)
        ucfg = UNetConfig.tiny() if tiny else UNetConfig.sd_v1()
        vcfg = vae_lib.VAEConfig.tiny() if tiny else vae_lib.VAEConfig.sd_v1()
        tcfg = CLIPTextConfig.tiny() if tiny else CLIPTextConfig.vit_l_14()
        latent_size, image_size = (16, 64) if tiny else (64, 512)
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

    def train_step_delta_loss(self, text_embeddings: torch.Tensor,
                              inputs: torch.Tensor, ref_inputs: torch.Tensor,
                              ref_text_embeddings: torch.Tensor,
                              guidance_scale: float = 7.5,
                              t: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
        """DDS loss on latents against reference latents and their text
        (sds.dds_loss); `t` and `noise`, shared by both branches, come from
        `generator` unless given."""
        return sds_lib.dds_loss(self.unet_apply, self.sched, inputs,
                                ref_inputs, text_embeddings,
                                ref_text_embeddings, guidance_scale,
                                self.min_step, self.max_step, t=t,
                                noise=noise, generator=generator)

    # ------------------------------------------------------------------ #
    # sampling / inversion
    # ------------------------------------------------------------------ #
    def produce_latents(self, text_embeddings: torch.Tensor,
                        num_inference_steps: int = 50,
                        guidance_scale: float = 7.5,
                        latents: Optional[torch.Tensor] = None,
                        start: int = 0,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """DDIM sampling with CFG from `latents` (B, h, h, 4), drawn from
        `generator` unless given (B = half the CFG batch), over the DDIM
        grid from index `start` on."""
        B = text_embeddings.shape[0] // 2
        if latents is None:
            latents = torch.randn(
                (B, self.latent_size, self.latent_size, 4),
                generator=generator, device=self.device)
        latents = latents.to(self.device, torch.float32)
        ts = ddim_timesteps(num_inference_steps, device=self.device)[start:]
        for t in ts:
            eps = sds_lib.cfg_eps(self.unet_apply, latents, t,
                                  text_embeddings, guidance_scale)
            latents = ddim_step(self.sched, eps, t, latents,
                                num_inference_steps).prev_sample
        return latents

    def embeds_to_img(self, text_embeddings: torch.Tensor,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 7.5,
                      latents: Optional[torch.Tensor] = None,
                      start: int = 0,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Text embeddings → decoded [0, 1] images (B, 8h, 8h, 3),
        differentiable end to end in the caller's grad mode."""
        lat = self.produce_latents(text_embeddings, num_inference_steps,
                                   guidance_scale, latents=latents,
                                   start=start, generator=generator)
        return vae_lib.decode_latents(self.vae, lat)

    @torch.no_grad()
    def prompt_to_img(self, prompts: Union[str, Sequence[str]],
                      num_inference_steps: int = 50,
                      guidance_scale: float = 7.5,
                      latents: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> np.ndarray:
        """txt2img: uint8 images (B, 8h, 8h, 3) on the host."""
        emb = self.get_text_embeds(prompts)
        lat = self.produce_latents(emb, num_inference_steps, guidance_scale,
                                   latents=latents, generator=generator)
        imgs = vae_lib.decode_latents(self.vae, lat)
        return torch.round(imgs * 255).to(torch.uint8).cpu().numpy()

    def invert(self, latents: torch.Tensor, text_embeddings: torch.Tensor,
               num_inference_steps: int = 50) -> torch.Tensor:
        """DDIM inversion x₀ → x_T under the cond half of the CFG pair (scale
        1: the uncond half is not read); the trajectory (S, B, h, w, 4),
        one latent a step, ascending in t."""
        cond = text_embeddings[text_embeddings.shape[0] // 2:]
        ts = ddim_timesteps(num_inference_steps, device=self.device).flip(0)
        lat, traj = latents, []
        for t in ts:
            eps = self.unet_apply(lat, t, cond)
            lat = ddim_inverse_step(self.sched, eps, t, lat,
                                    num_inference_steps).prev_sample
            traj.append(lat)
        return torch.stack(traj)

    def null_optimization(self, latents_traj: torch.Tensor,
                          text_embeddings: torch.Tensor,
                          num_inference_steps: int = 50,
                          num_inner_steps: int = 10, lr: float = 1e-2,
                          guidance_scale: float = 7.5) -> torch.Tensor:
        """Null-text inversion: at each DDIM step, walking the inversion
        trajectory back down, a fresh Adam fits the uncond embedding in
        `num_inner_steps` steps so that the CFG step from the current latent
        lands on the trajectory's next one (mean squared error, the gradient
        through the UNet); the step then moves on with the fitted
        embedding. Returns the embeddings (S, B, L, D), one a step."""
        B = text_embeddings.shape[0] // 2
        uncond, cond = text_embeddings[:B].detach(), text_embeddings[B:]
        ts = ddim_timesteps(num_inference_steps, device=self.device)
        lat_cur = latents_traj[-1]
        out = []
        for i, t in enumerate(ts):
            target_idx = len(ts) - 2 - i
            lat_target = latents_traj[max(target_idx, 0)]
            u = uncond.clone().requires_grad_(True)
            opt = torch.optim.Adam([u], lr=lr)
            for _ in range(num_inner_steps):
                with torch.enable_grad():
                    eps = sds_lib.cfg_eps(self.unet_apply, lat_cur, t,
                                          torch.cat([u, cond]),
                                          guidance_scale)
                    prev = ddim_step(self.sched, eps, t, lat_cur,
                                     num_inference_steps).prev_sample
                    loss = torch.mean((prev - lat_target) ** 2)
                    (g,) = torch.autograd.grad(loss, u)
                u.grad = g
                opt.step()
            uncond = u.detach()
            with torch.no_grad():
                eps = sds_lib.cfg_eps(self.unet_apply, lat_cur, t,
                                      torch.cat([uncond, cond]),
                                      guidance_scale)
                lat_cur = ddim_step(self.sched, eps, t, lat_cur,
                                    num_inference_steps).prev_sample
            out.append(uncond)
        return torch.stack(out)

    # ------------------------------------------------------------------ #
    # textual-inversion concepts
    # ------------------------------------------------------------------ #
    def load_concept(self, token: str, embedding) -> None:
        """Add `token` to the tokenizer and its learned row (D,) to the end
        of the text tower's token table. Refused for a `model_dir`'s BPE
        tokenizer, which takes no added token."""
        if not hasattr(self.tokenizer, "add_token"):
            raise NotImplementedError(CONCEPT_BPE_REFUSAL)
        self.tokenizer.add_token(token)
        emb = self.text_encoder.embeddings
        old = emb.token_embedding.weight
        row = torch.as_tensor(embedding).to(old)[None]
        emb.token_embedding = torch.nn.Embedding.from_pretrained(
            torch.cat([old.detach(), row]), freeze=True)
        self.text_encoder.config = dataclasses.replace(
            self.text_encoder.config, vocab_size=old.shape[0] + 1)

    def load_concept_dir(self, concept_dir: Path) -> str:
        """Load an sd-concepts-library directory (`learned_embeds.bin`, a
        {trained token: (D,)} state dict, and `token_identifier.txt`).
        Returns the token."""
        concept_dir = Path(concept_dir)
        token = (concept_dir / "token_identifier.txt").read_text().strip()
        learned = torch.load(concept_dir / "learned_embeds.bin",
                             map_location="cpu", weights_only=True)
        self.load_concept(token, next(iter(learned.values())))
        return token

    def maybe_load_concept(self, concept_name) -> Optional[str]:
        """`guide.concept_name` names a concept directory: load it; None
        when unset. Raises on a name that is not a directory (a hub name
        cannot be fetched), which the JAX package skips without a word."""
        if not concept_name:
            return None
        cdir = Path(concept_name)
        if not cdir.is_dir():
            raise ValueError(
                f"guide.concept_name {str(concept_name)!r} is not a "
                f"directory: a textual-inversion concept is read from a "
                f"local sd-concepts-library directory (learned_embeds.bin, "
                f"token_identifier.txt); hub names cannot be fetched")
        return self.load_concept_dir(cdir)
