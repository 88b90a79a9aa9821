"""Latent-Paint-Mesh application: soft-rasterized mesh painting and shaping.

DIB-R soft rasterization, SH lighting, vertex displacement with Laplacian
regularization, body and head cameras, and three training modes dispatched
as loss strategies (`optim.mode`):

* mode 0 — Latent-Paint SDS on 64² latent renders;
* mode 1 — TADA: the RGB render × lighting and the normal map, both encoded
  by the VAE, a blended normal latent, two SDS losses;
* mode 2 — SDEdit: encode the render, renoise at a fixed DDIM step, denoise
  one step, L2 between the rendered and the denoised latents.

Guidance is text-conditioned Stable Diffusion v1; with "depth" in
`guide.diffusion_name`, depth-conditioned SD (mode 0 only: its SDS term
reads the render's normalised depth); with `guide.use_sd false`,
Paint-by-Example conditioned on the exemplar `guide.image` (mode 0 only:
the JAX package has no mode 1 or 2 with either), whose SDS term reads the
render's mask and, with `optim.use_clip`, takes a CLIP image loss against
the exemplar at low t. `guide.image` also gives `clip_loss` a reference;
`guide.sampled_texture` seeds the textures from an image;
`guide.concept_name` loads a textual-inversion concept directory into the
text-guided SD stack the app builds (a name that is not a directory, or a
concept with the depth or Paint-by-Example backend, raises).
`guide.model_dir` names the diffusers-layout directory of whichever
backend the app builds, `guide.clip_model_dir` the CLIP tower's
(guidance/weights.py).
The texture and the dome colours train at `optim.lr`, the displacement and
the lights at `optim.disp_lr`.

The chunked trainer (`optim.train_chunk > 1`) runs every mode and backend:
on a card a step is a CUDA graph that reads nothing back. The band bins'
overflow of the ≥ 128² renders is decided on the device (the gated kernels
of kernels/rasterize.py). Paint-by-Example's CLIP branch is decided by the
trainer: it draws t before the step through the app's hook (`branches`,
`draw_branch`), reads the flag and replays that branch's step graph.

Every random draw can be passed in through `draws` (see `loss_fn`).
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.guidance import sds as sds_lib
from tpunerf_torch.guidance.clip_vision import (CLIPImageEmbedder,
                                                CLIPVisionConfig,
                                                img_clip_loss,
                                                init_vision_embeddings_)
from tpunerf_torch.guidance.depth import (StableDiffusionDepthGuidance,
                                          normalize_depth)
from tpunerf_torch.guidance.paint_by_example import PaintByExampleGuidance
from tpunerf_torch.guidance.schedulers import ddim_step, ddim_timesteps
from tpunerf_torch.guidance.stable_diffusion import (
    StableDiffusionGuidance, _build, _on_meta, latent_to_rgb_preview)
from tpunerf_torch.guidance.weights import load_clip_vision_params
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.meshrep.mesh import Mesh
from tpunerf_torch.meshrep.textured_mesh import TexturedMeshScene
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_nerf_app import (
    directional_text_embeddings, select_text_embeddings)
from tpunerf_torch.utils import load_image, make_generator, resolve_device

SOFT_MASK_SIGMA = 1e-4
SDEDIT_STEP_INDEX = 40       # mode 2 renoises at this DDIM step
DEPTH_MODES_REFUSAL = (
    "optim.mode {mode} with 'depth' in guide.diffusion_name: the JAX "
    "package has no such path (its TADA and SDEdit losses use the "
    "text-guided SD stack, which a depth config does not build); use "
    "optim.mode 0")
PBE_MODES_REFUSAL = (
    "optim.mode {mode} with guide.use_sd false (Paint-by-Example): the JAX "
    "package has no such path (its TADA and SDEdit losses use the "
    "text-guided SD stack, which a Paint-by-Example config does not "
    "build); use optim.mode 0")
DEPTH_PBE_REFUSAL = (
    "guide.use_sd false (Paint-by-Example) with 'depth' in "
    "guide.diffusion_name: the JAX package then trains with the depth "
    "backend and builds Paint-by-Example beside it unused; choose one")
CONCEPT_REFUSAL = (
    "guide.concept_name: textual-inversion concepts (ROADMAP.md A.6) load "
    "into the text-guided SD-v1 stack only; the {backend} backend leaves "
    "it unused")
PBE_IMAGE_REFUSAL = (
    "guide.use_sd false (Paint-by-Example) requires guide.image: the "
    "exemplar it is conditioned on and, with optim.use_clip, the image the "
    "CLIP loss compares against")


def make_clip_embedder(cfg: TrainConfig, device: torch.device
                       ) -> CLIPImageEmbedder:
    """The CLIP vision tower of the image losses (ViT-L/14; tiny with
    `guide.tiny_diffusion`): read from `guide.clip_model_dir` (a
    transformers `CLIPVisionModelWithProjection` directory) where it is
    set, else random-initialised like flax from `optim.seed`, and then at
    full width its loss is noise guidance and a warning says so."""
    vcfg = (CLIPVisionConfig.tiny() if cfg.guide.tiny_diffusion
            else CLIPVisionConfig.vit_l_14())
    if cfg.guide.clip_model_dir is not None:
        return load_clip_vision_params(
            cfg.guide.clip_model_dir, _on_meta(CLIPImageEmbedder, vcfg),
            device)
    gen = make_generator(cfg.optim.seed, device)
    embedder = _build(CLIPImageEmbedder, vcfg, device, gen)
    init_vision_embeddings_(embedder.vision_model, gen)
    if not cfg.guide.tiny_diffusion:
        logging.getLogger("tpunerf_torch").warning(
            "the CLIP tower is RANDOM-INIT (no guide.clip_model_dir): its "
            "loss is noise guidance, smoke-test only")
    return embedder


@dataclasses.dataclass
class LatentPaintMeshApp:
    cfg: TrainConfig
    scene: TexturedMeshScene
    # depth-conditioned where "depth" is in guide.diffusion_name,
    # Paint-by-Example with guide.use_sd false
    guidance: Union[StableDiffusionGuidance, StableDiffusionDepthGuidance,
                    PaintByExampleGuidance]
    text_z: torch.Tensor                 # body prompts (D, 2, L, E)
    text_z_head: torch.Tensor            # head prompts (D, 2, L, E)
    # from guide.image: Paint-by-Example's (2, 1, D) exemplar embedding,
    # the reference image of the CLIP losses and their tower
    image_embeds: Optional[torch.Tensor] = None
    ref_image: Optional[torch.Tensor] = None
    clip: Optional[CLIPImageEmbedder] = None

    @classmethod
    def create(cls, cfg: TrainConfig,
               guidance: Optional[StableDiffusionGuidance] = None,
               mesh: Optional[Mesh] = None,
               device: Optional[torch.device] = None,
               depth_guidance: Optional[StableDiffusionDepthGuidance] = None,
               pbe: Optional[PaintByExampleGuidance] = None
               ) -> "LatentPaintMeshApp":
        """Build the guidance stack (depth-conditioned where "depth" is in
        `guide.diffusion_name`, Paint-by-Example where `guide.use_sd` is
        false, else text-guided SD; a stack passed in, `depth_guidance`,
        `pbe` or `guidance` as in the JAX package, is used as it is), what
        `guide.image` gives (the exemplar embedding, the reference image
        and, for the CLIP losses, their tower) and the scene on `device`
        (CUDA unless the caller names another; raises when there is no
        card). `mesh` overrides `guide.shape_path`."""
        mode = cfg.optim.mode
        if mode not in (0, 1, 2):
            raise ValueError(f"unknown optim.mode {mode}")
        use_depth = "depth" in cfg.guide.diffusion_name
        use_pbe = not cfg.guide.use_sd
        if use_depth and use_pbe:
            raise NotImplementedError(DEPTH_PBE_REFUSAL)
        if use_depth and mode != 0:
            raise NotImplementedError(DEPTH_MODES_REFUSAL.format(mode=mode))
        if use_pbe and mode != 0:
            raise NotImplementedError(PBE_MODES_REFUSAL.format(mode=mode))
        if use_pbe and cfg.guide.image is None:
            raise ValueError(PBE_IMAGE_REFUSAL)
        if cfg.guide.concept_name and (use_depth or use_pbe):
            raise NotImplementedError(CONCEPT_REFUSAL.format(
                backend="depth" if use_depth else "Paint-by-Example"))
        device = resolve_device(device)
        latent_mode = mode == 0
        stack = dict(tiny=cfg.guide.tiny_diffusion,
                     model_dir=cfg.guide.model_dir,
                     unet_dtype=cfg.guide.unet_dtype, device=device,
                     generator=make_generator(cfg.optim.seed, device))
        if use_depth:
            guidance = depth_guidance
            if guidance is None:
                guidance = StableDiffusionDepthGuidance.create(
                    min_step=cfg.optim.min_step, max_step=cfg.optim.max_step,
                    **stack)
        elif use_pbe:
            # its own t window, [0.2, 0.6], whatever optim.min_step says
            guidance = pbe
            if guidance is None:
                guidance = PaintByExampleGuidance.create(**stack)
        elif guidance is None:
            guidance = StableDiffusionGuidance.create(
                latent_mode=latent_mode, min_step=cfg.optim.min_step,
                max_step=cfg.optim.max_step, **stack)
            guidance.maybe_load_concept(cfg.guide.concept_name)
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
        image_embeds = ref_image = clip = None
        if use_pbe:
            # no text: banks of zeros; the scene keeps its 64² latent grid,
            # as the JAX package's does
            text_z = text_z_head = torch.zeros((1, 2, 1, 1), device=device)
        else:
            scene.latent_size = guidance.latent_size
            # body and head prompt banks
            neg = cfg.guide.negative_text if cfg.guide.append_neg_text \
                else ""
            text_z = directional_text_embeddings(
                guidance, cfg.guide.text, cfg.guide.append_direction, neg)
            text_z_head = directional_text_embeddings(
                guidance, f"a close up face of {cfg.guide.text}",
                cfg.guide.append_direction, neg)
        if cfg.guide.image is not None:
            size = guidance.image_size if use_pbe else 512
            ref_image = load_image(cfg.guide.image, size, device)
            if use_pbe:
                image_embeds = guidance.encode_exemplar(ref_image)
            # the tower of the low-t CLIP branch (Paint-by-Example with
            # optim.use_clip) or of clip_loss (the SD backends)
            if cfg.optim.use_clip or not use_pbe:
                clip = make_clip_embedder(cfg, device)
        return cls(cfg=cfg, scene=scene, guidance=guidance, text_z=text_z,
                   text_z_head=text_z_head, image_embeds=image_embeds,
                   ref_image=ref_image, clip=clip)

    # ------------------------------------------------------------------ #
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> None:
        """The scene's parameters, with `guide.sampled_texture` the RGB
        texture (and, with text-guided SD, the latent texture: the mode
        encode) seeded from that image, read at max(4R, 64)² and resized
        bilinearly to the texture's R²."""
        path = self.cfg.guide.sampled_texture
        tex_lat = tex_rgb = None
        if path is not None:
            R = self.scene.texture_resolution
            img = load_image(path, max(4 * R, 64), self.scene.device)
            if isinstance(self.guidance, StableDiffusionGuidance):
                tex_lat = texk.resize_bilinear(
                    self.guidance.encode_imgs_mode(img), R, R)
            tex_rgb = texk.resize_bilinear(img, R, R)
        self.scene.init_params(generator, texture_latents=tex_lat,
                               texture_rgb=tex_rgb)

    def _select_text(self, views: ViewBatch) -> torch.Tensor:
        """Body or head prompt bank per view → (2B, L, E)."""
        body = select_text_embeddings(self.text_z, views.dirs)
        head = select_text_embeddings(self.text_z_head, views.dirs)
        sel = views.is_body.to(body.dtype)
        sel2 = torch.cat([sel, sel])[:, None, None]
        return body * sel2 + head * (1.0 - sel2)

    def branches(self) -> bool:
        """Whether the step's loss branches on a draw: Paint-by-Example
        with `optim.use_clip`, whose t takes the CLIP branch or the SDS
        one. The trainer then draws t through `draw_branch` before the
        step."""
        return (isinstance(self.guidance, PaintByExampleGuidance)
                and self.cfg.optim.use_clip and self.clip is not None)

    def draw_branch(self, generator: Optional[torch.Generator] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The draw the step branches on, {"t": t}, and its branch flag (a
        bool tensor on the device: t takes the CLIP branch)."""
        g = self.guidance
        t = sds_lib.sample_timestep(g.min_step, g.max_step,
                                    self.scene.device, generator)
        return {"t": t}, g.clip_branch_flag(t)

    def loss_fn(self, views: ViewBatch,
                draws: Optional[Mapping[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                branch: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Render → the mode's guidance loss + the displacement's
        regularisers. Each random draw is taken from `draws` where it is
        there and from `generator` otherwise, in the order listed (the
        render draws nothing):
        mode 0: `t`, `noise` (B, h, w, 4) of the SDS term (with depth and
        Paint-by-Example too). With Paint-by-Example and `optim.use_clip`
        the trainer draws `t` before the step (`draw_branch`, right after
        the poses: the same place in the generator's order) and passes it
        in with `branch`, the branch it read from the flag (a replay of the
        graph of that branch); without `branch` the flag is read here.
        `aux["clip_branch"]` is the flag, a bool tensor;
        mode 1: `vae_noise_img`, `vae_noise_nrm` (the two encodes'
        posterior samples), `t_img`, `noise_img`, `t_nrm`, `noise_nrm`;
        mode 2: `vae_noise`, `noise`.
        Every entry of the returned aux is a tensor."""
        cfg, mode = self.cfg, self.cfg.optim.mode
        draws = dict(draws or {})
        render = self.scene.render_train(views, with_lighting=mode != 0)
        aux: Dict[str, Any] = {"image": render["image"].detach()}
        if mode == 0 and isinstance(self.guidance, PaintByExampleGuidance):
            main = self._pbe_loss(render, draws, generator, aux, branch)
        elif mode == 0:
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

    def _pbe_loss(self, render, draws, generator, aux,
                  branch: Optional[bool]) -> torch.Tensor:
        """Paint-by-Example's SDS term on the latent render and its
        detached mask; with `optim.use_clip`, the CLIP branch at low t
        (`branch` where the caller read it, else read here)."""
        g = self.guidance
        image = render["image"]
        t = draws.get("t")
        if t is None:
            t = sds_lib.sample_timestep(g.min_step, g.max_step, image.device,
                                        generator)
        use_clip = self.branches()
        clip_branch = None
        if use_clip:
            t = torch.as_tensor(t, device=image.device)
            aux["clip_branch"] = g.clip_branch_flag(t)
            clip_branch = (bool(aux["clip_branch"]) if branch is None
                           else branch)
        return g.train_step_loss(
            image, render["mask"].detach(), self.image_embeds,
            guidance_scale=self.cfg.guide.guidance_scale, use_clip=use_clip,
            clip_embed_fn=self.clip, ref_image01=self.ref_image,
            clip_image_size=(self.clip.config.image_size if use_clip
                             else 224),
            t=t, noise=draws.get("noise"), generator=generator,
            clip_branch=clip_branch)

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
        """The CLIP image loss of a training render (a latent render through
        the fixed preview matrix) against `guide.image`."""
        if self.ref_image is None or self.clip is None:
            raise ValueError("clip_loss needs guide.image (its reference "
                             "image and CLIP tower)")
        image = self.scene.render_train(views)["image"]
        if image.shape[-1] == 4:
            image = latent_to_rgb_preview(image)
        return img_clip_loss(self.clip, image, self.ref_image,
                             size=self.clip.config.image_size)

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
