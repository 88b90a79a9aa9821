"""Latent-Paint application: SDS texture painting on a fixed mesh.

Optimizes a 4-channel latent UV texture (and the colours of the background
dome) through the hard rasterizer under text-conditioned SDS. The eval
render decodes the latent texture through the VAE. In RGB mode
(`render.nerf_type rgb`) it trains the RGB finetune texture through the
VAE encoder, and loading a latent run's checkpoint decodes its latent
texture as the finetune's start (`migrate_params`).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.dist import mesh as dist_mesh
from tpunerf_torch.dist.mesh import MeshLayout
from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.meshrep.mesh import Mesh
from tpunerf_torch.meshrep.textured_mesh import TexturedMeshScene
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_nerf_app import (  # noqa: F401
    directional_text_embeddings, select_text_embeddings)
from tpunerf_torch.utils import make_generator, resolve_device


@dataclasses.dataclass
class LatentPaintApp:
    cfg: TrainConfig
    guidance: StableDiffusionGuidance
    scene: TexturedMeshScene
    text_z: torch.Tensor
    layout: Optional[MeshLayout] = None

    @classmethod
    def create(cls, cfg: TrainConfig,
               guidance: Optional[StableDiffusionGuidance] = None,
               mesh: Optional[Mesh] = None,
               device: Optional[torch.device] = None) -> "LatentPaintApp":
        """Build the guidance stack and the scene on `device` (CUDA unless
        the caller names another; raises when there is no card). `mesh`
        overrides `guide.shape_path`."""
        device = resolve_device(device)
        latent_mode = cfg.render.nerf_type == "latent"
        if guidance is None:
            guidance = StableDiffusionGuidance.create(
                tiny=cfg.guide.tiny_diffusion, model_dir=cfg.guide.model_dir,
                latent_mode=latent_mode, min_step=cfg.optim.min_step,
                max_step=cfg.optim.max_step, unet_dtype=cfg.guide.unet_dtype,
                device=device,
                generator=make_generator(cfg.optim.seed, device))
            guidance.maybe_load_concept(cfg.guide.concept_name)
        # rank 0 unwraps the UVs and writes their cache, the others read it
        with dist_mesh.main_process_first():
            scene = TexturedMeshScene.create(
                mesh=mesh, shape_path=cfg.guide.shape_path,
                shape_scale=cfg.guide.shape_scale, dy=cfg.guide.dy,
                latent_mode=latent_mode,
                texture_resolution=cfg.guide.texture_resolution,
                render_grid_size=cfg.render.train_grid_size,
                interpolation_mode=cfg.guide.texture_interpolation_mode,
                cache_dir=cfg.log.exp_dir, device=device)
        scene.latent_size = guidance.latent_size
        neg = cfg.guide.negative_text if cfg.guide.append_neg_text else ""
        text_z = directional_text_embeddings(guidance, cfg.guide.text,
                                             cfg.guide.append_direction, neg)
        return cls(cfg=cfg, guidance=guidance, scene=scene, text_z=text_z)

    # ------------------------------------------------------------------ #
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> None:
        self.scene.init_params(generator)

    def set_layout(self, layout: Optional[MeshLayout]) -> None:
        """Wire the device mesh into the step and the renderer: each rank
        renders its views of the global batch, and its rays row splits the
        gradient of the frames' rows (`TexturedMeshScene._rank_rows`)."""
        self.layout = layout
        self.scene.layout = layout

    def loss_fn(self, views: ViewBatch, t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                vae_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Render → SDS. The draws — in RGB mode the VAE posterior's
        `vae_noise` (B, 64, 64, 4), then the SDS timestep `t` and the noise
        (B, 64, 64, 4) — are taken from `generator` unless given, in that
        order, before the render (`sds.step_draws`). On a mesh that splits
        the step (`set_layout`), `views` and the draws are the global
        batch's: the rank takes its slice, and the loss (aux's
        `guidance_loss`) is its share."""
        B = views.batch_size
        g = self.guidance
        h = self.scene.latent_size if g.latent_mode else g.latent_size
        order = [("t", "timestep", None), ("noise", "normal", (B, h, h, 4))]
        if not g.latent_mode:
            order.insert(0, ("vae_noise", "normal", (B, h, h, 4)))
        d = sds_lib.step_draws(order, dict(t=t, noise=noise,
                                           vae_noise=vae_noise),
                               g.min_step, g.max_step, self.scene.device,
                               generator)
        layout = self.layout if self.layout and self.layout.splits else None
        if layout is not None:
            views, d = views[layout.data_rows(B)], layout.shard_draws(d, B)
        render = self.scene.render_train(views)
        text_z = select_text_embeddings(self.text_z, views.dirs)
        loss = self.guidance.train_step_loss(
            text_z, render["image"],
            guidance_scale=self.cfg.guide.guidance_scale, t=d["t"],
            noise=d["noise"], generator=generator,
            vae_noise=d.get("vae_noise"))
        if layout is not None:
            loss = layout.sum_share(loss)
        return loss, {"image": render["image"].detach(),
                      "guidance_loss": loss.detach()}

    @torch.no_grad()
    def eval_render(self, views: ViewBatch, dims: Tuple[int, int]
                    ) -> Dict[str, torch.Tensor]:
        return self.scene.render_test(
            views, decode_fn=self.guidance.decode_latents, dims=dims)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam(lr, β = (0.9, 0.99), eps = 1e-15) over the trainable keys
        only: the texture of the other mode gets no update."""
        params = [getattr(self.scene, k) for k in self.scene.trainable_keys()]
        return torch.optim.Adam(params, lr=self.cfg.optim.lr,
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
        """A latent-mode scene loads a checkpoint unchanged, as does an RGB
        one whose finetune texture is not all zero. A latent checkpoint
        into RGB mode (finetune texture all zero) gets the checkpoint's
        latent texture decoded as the finetune's start."""
        rgb = params.get("texture_img_rgb_finetune")
        if (not self.scene.latent_mode and rgb is not None
                and not bool(rgb.abs().max() != 0)):
            return self.scene.migrate_latent_to_rgb(
                params, self.guidance.decode_latents)
        return params
