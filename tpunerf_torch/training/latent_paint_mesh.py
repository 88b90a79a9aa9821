"""Latent-Paint-Mesh application: soft-rasterized mesh painting and shaping.

DIB-R soft rasterization, SH lighting, vertex displacement with Laplacian
regularization, body and head cameras, and three training modes dispatched
as loss strategies (`optim.mode`):

* mode 0 — Latent-Paint SDS on 64² latent renders;
* mode 1 — TADA: the RGB render × lighting and the normal map, both encoded
  by the VAE, a blended normal latent, two SDS losses;
* mode 2 — SDEdit: encode the render, renoise at a fixed DDIM step, denoise
  one step, L2 between the rendered and the denoised latents.

Guidance is text-conditioned Stable Diffusion v1 or, with "depth" in
`guide.diffusion_name`, depth-conditioned SD (mode 0 only: its SDS term
reads the render's normalised depth, and the JAX package has no mode 1 or 2
with it). Paint-by-Example, the CLIP image losses and a texture seeded from
a sampled image are not ported yet (ROADMAP.md item A.6) and are refused
by name.
The texture and the dome colours train at `optim.lr`, the displacement and
the lights at `optim.disp_lr`. The chunked trainer (`optim.train_chunk >
1`) is refused by name (`chunk_refusal`, ROADMAP.md item A.12).

Every random draw can be passed in through `draws` (see `loss_fn`).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance.depth import (StableDiffusionDepthGuidance,
                                          normalize_depth)
from tpunerf_torch.guidance.schedulers import ddim_step, ddim_timesteps
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.meshrep.mesh import Mesh
from tpunerf_torch.meshrep.textured_mesh import TexturedMeshScene
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_nerf_app import (
    directional_text_embeddings, select_text_embeddings)
from tpunerf_torch.utils import make_generator, resolve_device

ROADMAP_A6 = "is not ported yet: ROADMAP.md item A.6"
SOFT_MASK_SIGMA = 1e-4
SDEDIT_STEP_INDEX = 40       # mode 2 renoises at this DDIM step
CHUNK_REFUSAL = (
    "optim.train_chunk > 1 (a CUDA-graph step) for latent-paint-mesh comes "
    "with ROADMAP.md item A.12: mode 1's 512² renders read a bin-overflow "
    "count on the host (face selection and the soft silhouette's forward, "
    "kernels/rasterize.py), and modes 0 and 2 have not been tried under "
    "capture")
DEPTH_MODES_REFUSAL = (
    "optim.mode {mode} with 'depth' in guide.diffusion_name: the JAX "
    "package has no such path (its TADA and SDEdit losses use the "
    "text-guided SD stack, which a depth config does not build); use "
    "optim.mode 0")


def unported_guidance_settings(cfg: TrainConfig) -> list:
    """The settings of `cfg` that need a guidance backend or a loss the
    port does not have yet."""
    guide, optim = cfg.guide, cfg.optim
    asks = {
        "guide.use_sd false (Paint-by-Example guidance)": not guide.use_sd,
        "guide.image (reference image: Paint-by-Example, CLIP losses)":
            guide.image is not None,
        "optim.use_clip (CLIP vision tower)": optim.use_clip,
        "guide.sampled_texture (texture seeded from an image file)":
            guide.sampled_texture is not None,
        "guide.concept_name (textual-inversion concepts)":
            bool(guide.concept_name),
    }
    return [k for k, v in asks.items() if v]


@dataclasses.dataclass
class LatentPaintMeshApp:
    cfg: TrainConfig
    scene: TexturedMeshScene
    # depth-conditioned where "depth" is in guide.diffusion_name
    guidance: Union[StableDiffusionGuidance, StableDiffusionDepthGuidance]
    chunk_refusal = CHUNK_REFUSAL
    text_z: torch.Tensor                 # body prompts (D, 2, L, E)
    text_z_head: torch.Tensor            # head prompts (D, 2, L, E)

    @classmethod
    def create(cls, cfg: TrainConfig,
               guidance: Optional[StableDiffusionGuidance] = None,
               mesh: Optional[Mesh] = None,
               device: Optional[torch.device] = None,
               depth_guidance: Optional[StableDiffusionDepthGuidance] = None
               ) -> "LatentPaintMeshApp":
        """Build the guidance stack (depth-conditioned where "depth" is in
        `guide.diffusion_name`, else text-guided SD; a stack passed in,
        `depth_guidance` with depth and `guidance` without as in the JAX
        package, is used as it is) and the scene on `device` (CUDA unless the caller names
        another; raises when there is no card). `mesh` overrides
        `guide.shape_path`."""
        missing = unported_guidance_settings(cfg)
        if missing:
            raise NotImplementedError(f"{'; '.join(missing)} {ROADMAP_A6}")
        if cfg.optim.mode not in (0, 1, 2):
            raise ValueError(f"unknown optim.mode {cfg.optim.mode}")
        use_depth = "depth" in cfg.guide.diffusion_name
        if use_depth and cfg.optim.mode != 0:
            raise NotImplementedError(
                DEPTH_MODES_REFUSAL.format(mode=cfg.optim.mode))
        device = resolve_device(device)
        latent_mode = cfg.optim.mode == 0
        if use_depth:
            guidance = depth_guidance
            if guidance is None:
                guidance = StableDiffusionDepthGuidance.create(
                    tiny=cfg.guide.tiny_diffusion,
                    model_dir=cfg.guide.model_dir,
                    min_step=cfg.optim.min_step, max_step=cfg.optim.max_step,
                    unet_dtype=cfg.guide.unet_dtype, device=device,
                    generator=make_generator(cfg.optim.seed, device))
        elif guidance is None:
            guidance = StableDiffusionGuidance.create(
                tiny=cfg.guide.tiny_diffusion,
                model_dir=cfg.guide.model_dir, latent_mode=latent_mode,
                min_step=cfg.optim.min_step, max_step=cfg.optim.max_step,
                unet_dtype=cfg.guide.unet_dtype, device=device,
                generator=make_generator(cfg.optim.seed, device))
        scene = TexturedMeshScene.create(
            mesh=mesh, shape_path=cfg.guide.shape_path,
            shape_scale=cfg.guide.shape_scale, dy=cfg.guide.dy,
            latent_mode=latent_mode,
            texture_resolution=cfg.guide.texture_resolution,
            render_grid_size=cfg.render.train_grid_size,
            interpolation_mode=cfg.guide.texture_interpolation_mode,
            cache_dir=cfg.log.exp_dir, enable_displacement=True,
            dual_camera=cfg.render.body_prob < 1.0,
            soft_mask_sigma=SOFT_MASK_SIGMA, device=device)
        scene.latent_size = guidance.latent_size

        # body and head prompt banks
        neg = cfg.guide.negative_text if cfg.guide.append_neg_text else ""
        text_z = directional_text_embeddings(
            guidance, cfg.guide.text, cfg.guide.append_direction, neg)
        text_z_head = directional_text_embeddings(
            guidance, f"a close up face of {cfg.guide.text}",
            cfg.guide.append_direction, neg)
        return cls(cfg=cfg, scene=scene, guidance=guidance, text_z=text_z,
                   text_z_head=text_z_head)

    # ------------------------------------------------------------------ #
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> None:
        self.scene.init_params(generator)

    def _select_text(self, views: ViewBatch) -> torch.Tensor:
        """Body or head prompt bank per view → (2B, L, E)."""
        body = select_text_embeddings(self.text_z, views.dirs)
        head = select_text_embeddings(self.text_z_head, views.dirs)
        sel = views.is_body.to(body.dtype)
        sel2 = torch.cat([sel, sel])[:, None, None]
        return body * sel2 + head * (1.0 - sel2)

    def loss_fn(self, views: ViewBatch,
                draws: Optional[Mapping[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Render → the mode's guidance loss + the displacement's
        regularisers. Each random draw is taken from `draws` where it is
        there and from `generator` otherwise, in the order listed:
        mode 0: `t`, `noise` (B, h, w, 4) of the SDS term (with depth
        too);
        mode 1: `vae_noise_img`, `vae_noise_nrm` (the two encodes'
        posterior samples), `t_img`, `noise_img`, `t_nrm`, `noise_nrm`;
        mode 2: `vae_noise`, `noise`."""
        cfg, mode = self.cfg, self.cfg.optim.mode
        draws = dict(draws or {})
        render = self.scene.render_train(views, with_lighting=mode != 0)
        aux: Dict[str, Any] = {"image": render["image"].detach()}
        if mode == 0:
            depth = ()           # the depth backend's condition
            if isinstance(self.guidance, StableDiffusionDepthGuidance):
                with torch.no_grad():
                    depth = (normalize_depth(render["depth"],
                                             render["mask"]),)
            main = self.guidance.train_step_loss(
                self._select_text(views), render["image"], *depth,
                guidance_scale=cfg.guide.guidance_scale, t=draws.get("t"),
                noise=draws.get("noise"), generator=generator)
        elif mode == 1:
            main = self._tada_loss(render, views, draws, generator)
        else:
            main = self._sdedit_loss(render, views, draws, generator)
        loss = (main + cfg.optim.lambda_laplacian * render["laplacian_loss"]
                + cfg.optim.lambda_displacement * render["displacement_norm"])
        aux["laplacian_loss"] = render["laplacian_loss"].detach()
        return loss, aux

    def _encode_render(self, image01: torch.Tensor,
                       noise: Optional[torch.Tensor],
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """A render resized to the VAE's image size and encoded, with the
        gradient to the render."""
        g = self.guidance
        return g.encode_imgs(
            texk.resize_bilinear(image01, g.image_size, g.image_size),
            noise=noise, generator=generator)

    def _tada_loss(self, render, views, draws, generator) -> torch.Tensor:
        """TADA mode: the shaded RGB latent and a latent blended with the
        normal map's, one SDS term each."""
        g, scale = self.guidance, self.cfg.guide.guidance_scale
        text_z = self._select_text(views)
        shaded = render["image"] * render["lighting"]
        lat_img = self._encode_render(shaded, draws.get("vae_noise_img"),
                                      generator)
        lat_nrm = self._encode_render((render["normals"] + 1.0) / 2.0,
                                      draws.get("vae_noise_nrm"), generator)
        lat_blend = 0.5 * lat_img + 0.5 * lat_nrm
        loss_img = sds_lib.sds_loss(
            g.unet_apply, g.sched, lat_img, text_z, scale, g.min_step,
            g.max_step, t=draws.get("t_img"), noise=draws.get("noise_img"),
            generator=generator)
        loss_nrm = sds_lib.sds_loss(
            g.unet_apply, g.sched, lat_blend, text_z, scale, g.min_step,
            g.max_step, t=draws.get("t_nrm"), noise=draws.get("noise_nrm"),
            generator=generator)
        return loss_img + 0.5 * loss_nrm

    def _sdedit_loss(self, render, views, draws, generator) -> torch.Tensor:
        """SDEdit mode: renoise the rendered latent at a fixed DDIM step,
        denoise one step, pull the latent toward the denoised target."""
        g, steps = self.guidance, self.cfg.guide.num_inference_steps
        text_z = self._select_text(views)
        lat = self._encode_render(render["image"] * render["lighting"],
                                  draws.get("vae_noise"), generator)
        ts = ddim_timesteps(steps, device=lat.device)
        t = ts[min(SDEDIT_STEP_INDEX, ts.shape[0] - 1)]
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(lat.shape, generator=generator,
                                device=lat.device)
        with torch.no_grad():
            lat_noisy = g.sched.add_noise(lat.detach(), noise.to(lat), t)
            eps = sds_lib.cfg_eps(g.unet_apply, lat_noisy, t, text_z,
                                  self.cfg.guide.guidance_scale)
            target = ddim_step(g.sched, eps, t, lat_noisy, steps).pred_x0
        return torch.mean((lat - target) ** 2)

    def clip_loss(self, views: ViewBatch) -> torch.Tensor:
        raise NotImplementedError("clip_loss (the CLIP image loss against "
                                  f"guide.image) {ROADMAP_A6}")

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def eval_render(self, views: ViewBatch, dims: Tuple[int, int]
                    ) -> Dict[str, torch.Tensor]:
        return self.scene.render_test(
            views, decode_fn=self.guidance.decode_latents, dims=dims,
            with_lighting=self.cfg.optim.mode != 0)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """One Adam (β = (0.9, 0.99), eps = 1e-15) with two groups: the dome
        colours and the current mode's texture at `optim.lr`, the
        displacement and the lights at `optim.disp_lr`. The other mode's
        texture is in no group and gets no update."""
        scene, optim = self.scene, self.cfg.optim
        return torch.optim.Adam(
            [{"params": [getattr(scene, k) for k in scene.trainable_keys()],
              "lr": optim.lr},
             {"params": [scene.displacement, scene.lights],
              "lr": optim.disp_lr}],
            betas=(0.9, 0.99), eps=1e-15)

    def export(self, path: Path) -> None:
        self.scene.export_mesh(path, decode_fn=self.guidance.decode_latents)

    def preview_latents(self, latents: torch.Tensor) -> torch.Tensor:
        return self.guidance.decode_latents(latents)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """What a checkpoint holds: the scene's parameters."""
        return self.scene.state_dict()

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.scene.load_state_dict(state)

    def migrate_params(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """A checkpoint loads unchanged in every mode, as in the JAX
        package."""
        return params
