"""Latent-NeRF application: text-to-3D volumetric SDS training.

A hash-grid latent-NeRF field optimized by text-conditioned SDS, with
occupancy-grid pruning, sparsity regularization and, where
`guide.shape_path` names a guide shape, the sketch-shape loss
(`optim.lambda_shape`, `guide.proximal_surface`), and its eval orbit: the
field rendered at the latent grid and decoded by the VAE. With
`render.nerf_type rgb` it is the refine stage of the two-stage recipe: an
RGB field trained through the VAE encoder, which loads a latent run's
checkpoint (`optim.ckpt`) with fresh colour heads (`migrate_params`) and
renders its eval orbit at the eval grid. `export` writes the field's
iso-surface as an OBJ.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpunerf_torch.core.camera import VIEW_DIRECTION_SUFFIXES
from tpunerf_torch.core.obj_io import save_obj_with_mtl
from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.dist.mesh import MeshLayout
from tpunerf_torch.fields.latent_nerf import LatentNeRFField
from tpunerf_torch.fields.scene import LatentNeRFScene
from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.meshrep import uv_unwrap
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.utils import make_generator, resolve_device


def directional_text_embeddings(guidance: StableDiffusionGuidance,
                                text: str, append_direction: bool,
                                negative_text: str = "") -> torch.Tensor:
    """(D, 2, L, E) per-direction CFG embeddings; `negative_text` fills
    the uncond branch."""
    neg = negative_text or None
    if not append_direction:
        return guidance.get_text_embeds([text], neg)[None]  # (1, 2, L, E)
    prompts = [f"{text}, {sfx}" for sfx in VIEW_DIRECTION_SUFFIXES]
    embs = guidance.get_text_embeds(prompts, neg)            # (2·6, L, E)
    n = len(prompts)
    return torch.stack([embs[:n], embs[n:]], dim=1)


def select_text_embeddings(text_z: torch.Tensor, dirs: torch.Tensor
                           ) -> torch.Tensor:
    """Per-view direction select → (2B, L, E) with the uncond half first."""
    idx = dirs if text_z.shape[0] > 1 else torch.zeros_like(dirs)
    sel = text_z[idx]                                        # (B, 2, L, E)
    return torch.cat([sel[:, 0], sel[:, 1]], dim=0)


@dataclasses.dataclass
class LatentNeRFApp:
    cfg: TrainConfig
    guidance: StableDiffusionGuidance
    scene: LatentNeRFScene
    text_z: torch.Tensor
    layout: Optional[MeshLayout] = None

    @classmethod
    def create(cls, cfg: TrainConfig,
               guidance: Optional[StableDiffusionGuidance] = None,
               device: Optional[torch.device] = None) -> "LatentNeRFApp":
        """Build the guidance stack and the scene on `device` (CUDA unless
        the caller names another; raises when there is no card)."""
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
        scene = LatentNeRFScene.from_config(cfg, device=device)
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
        renders its views of the global batch and, where the rays axis
        divides the pixels, only its band of them."""
        self.layout = layout
        self.scene.layout = layout

    def step_draws(self, B: int, given: Dict[str, Optional[torch.Tensor]],
                   generator: Optional[torch.Generator]
                   ) -> Dict[str, torch.Tensor]:
        """The step's draws at the batch B, `given`'s where given, the rest
        from `generator` in the order the step uses them: `u`, in RGB mode
        `vae_noise`, `t`, `noise`."""
        g, H = self.guidance, self.scene.train_grid_size
        h = H if g.latent_mode else g.latent_size
        order = [("u", "uniform", (B, H * H, self.scene.march.num_samples))]
        if not g.latent_mode:
            order.append(("vae_noise", "normal", (B, h, h, 4)))
        order += [("t", "timestep", None), ("noise", "normal", (B, h, h, 4))]
        return sds_lib.step_draws(order, given, g.min_step, g.max_step,
                                  self.scene.occ_grid.device, generator)

    def loss_fn(self, views: ViewBatch, u: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                vae_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Render → SDS (+ regularizers, + the shape loss where the scene
        has a guide shape). The draws — stratified jitter `u`
        (B, P, S), in RGB mode the VAE posterior's `vae_noise` (B, 64, 64,
        4), then SDS timestep `t` and noise (B, 64, 64, 4) — are taken from
        `generator` unless given, in that order, before the render
        (`step_draws`). On a mesh that splits the step (`set_layout`),
        `views` and the draws are the global batch's: the rank takes its
        slice, and the loss and each term in aux (`guidance_loss`,
        `sparsity_loss`, `opacity_loss`, `shape_loss`) are its shares,
        whose sum over the world is the one-rank value."""
        B = views.batch_size
        d = self.step_draws(B, dict(u=u, t=t, noise=noise,
                                    vae_noise=vae_noise), generator)
        layout = self.layout if self.layout and self.layout.splits else None
        if layout is not None:
            views, d = views[layout.data_rows(B)], layout.shard_draws(d, B)
        out = self.scene.render_train(views, u=d["u"])
        text_z = select_text_embeddings(self.text_z, views.dirs)
        main = self.guidance.train_step_loss(
            text_z, out["image"], guidance_scale=self.cfg.guide.guidance_scale,
            t=d["t"], noise=d["noise"], generator=generator,
            vae_noise=d.get("vae_noise"))
        if layout is not None:
            main = layout.sum_share(main)
        loss = main + self.cfg.optim.lambda_sparsity * out["sparsity_loss"]
        if self.cfg.optim.lambda_opacity:
            loss = loss + self.cfg.optim.lambda_opacity * out["opacity_loss"]
        aux = {"image": out["image"].detach(),
               "weights_sum": torch.mean(out["weights_sum"]).detach(),
               "guidance_loss": main.detach(),
               "sparsity_loss": out["sparsity_loss"].detach(),
               "opacity_loss": out["opacity_loss"].detach()}
        if "shape_loss" in out:
            loss = loss + self.cfg.optim.lambda_shape * out["shape_loss"]
            aux["shape_loss"] = out["shape_loss"].detach()
        return loss, aux

    def post_step(self, step: int, u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> None:
        """Occupancy refresh at step 1 and every `occ_update_interval`."""
        if step == 1 or step % self.scene.occ_update_interval == 0:
            self.scene.update_occupancy(u=u, generator=generator)

    def metric_scalars(self) -> Dict[str, float]:
        """The occupied fraction of the EMA grid."""
        thresh = self.scene.occ_cfg.density_threshold
        frac = (self.scene.occ_grid > thresh).float().mean().item()
        return {"occ_frac": round(frac, 4)}

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam over the field only; the occupancy grid and its bitfield
        are buffers and the guidance stack is frozen."""
        return torch.optim.Adam(self.scene.trainable_parameters(),
                                lr=self.cfg.optim.lr, betas=(0.9, 0.99),
                                eps=1e-15)

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """What a checkpoint holds: the scene's parameters and buffers (the
        occupancy grid and its bitfield)."""
        return self.scene.state_dict()

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.scene.load_state_dict(state)

    def eval_render(self, views: ViewBatch, dims: Tuple[int, int]
                    ) -> Dict[str, torch.Tensor]:
        return self.scene.render_test(
            views, decode_fn=self.guidance.decode_latents, dims=dims)

    def max_eval_batch(self, dims: Tuple[int, int]) -> int:
        """Eval poses a chunk: no cap at the latent grid (the VAE decodes
        to `dims`); an RGB field marches every output pixel, so at most
        ~40 M ray samples a chunk."""
        if self.scene.field.config.out_channels == 4:
            return 1 << 30
        per_pose = dims[0] * dims[1] * self.scene.march.num_samples
        return max(1, (40 << 20) // max(per_pose, 1))

    def export(self, path: Path) -> None:
        """NeRF → mesh: the 64³ iso-surface at `render.iso_level`'s
        default 10 with a grid UV atlas and a grey albedo, as `mesh.obj`,
        `mesh.mtl` and `albedo.png` under `path`. An empty surface raises
        NotImplementedError (the trainer logs the export as skipped)."""
        verts, faces = self.scene.extract_mesh(resolution=64)
        if len(faces) == 0:
            raise NotImplementedError("no surface at isolevel")
        vt, ft = uv_unwrap.grid_atlas(verts, faces)
        albedo = np.full((256, 256, 3), 0.5, np.float32)
        save_obj_with_mtl(path, verts, faces, vt, ft, albedo)

    def preview_latents(self, latents: torch.Tensor) -> torch.Tensor:
        return self.guidance.decode_latents(latents)

    def migrate_params(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The refine stage's load: a checkpoint whose colour heads are as
        wide as this field's loads unchanged; from a latent (4-channel)
        checkpoint into an RGB field, the last layers of `color_mlp` and
        `bg_mlp` come from a fresh initialisation of the field by a
        generator seeded 0 (the JAX package takes them from its init at
        key 0), and every other tensor (hash table, `sigma_mlp`, the other
        layers, the occupancy grid and bitfield) is the checkpoint's."""
        own = self.scene.state_dict()
        out, fresh = dict(params), None
        for head in ("color_mlp", "bg_mlp"):
            keys = sorted((k for k in own
                           if k.startswith(f"field.{head}.layers.")),
                          key=lambda k: int(k.split(".")[3]))
            last = keys[-1]
            if last in params and params[last].shape != own[last].shape:
                if fresh is None:
                    dev = self.scene.occ_grid.device
                    fresh = LatentNeRFField(
                        self.scene.field.config, dev,
                        make_generator(0, dev)).state_dict()
                out[last] = fresh[last[len("field."):]]
        return out
