"""TexturedMeshScene — a fixed mesh with a learnable latent UV texture.

An `nn.Module` holding three parameters, all NHWC / face-major exactly as
the JAX package's params pytree holds them (no transposition):

* `background_sphere_colors` (1, Fb, 3, 4) — per-face-vertex colours of the
  background dome;
* `texture_img` (1, R, R, 4) — the latent texture;
* `texture_img_rgb_finetune` (1, R, R, 3) — the RGB texture of the finetune
  stage (frozen in latent mode).

The mesh, its UV attributes and the dome live on the scene's device from
`create` on. Per-vertex displacement with its Laplacian, SH lights, the
body/head dual cameras, the soft mask and the device-mesh layout belong to
later slices of the port and are refused.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpunerf_torch.core import camera as cam
from tpunerf_torch.core.obj_io import save_obj_with_mtl
from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.guidance.stable_diffusion import (LINEAR_RGB_ESTIMATOR,
                                                     rgb_to_latent_init)
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.kernels.rasterize import MESH_SLICE
from tpunerf_torch.meshrep import render as mrender
from tpunerf_torch.meshrep import shapes, uv_unwrap
from tpunerf_torch.meshrep.mesh import Mesh
from tpunerf_torch.utils import resolve_device



class TexturedMeshScene(nn.Module):
    def __init__(self, mesh: Mesh, env_sphere: Mesh,
                 face_uv_attr: torch.Tensor, latent_mode: bool = True,
                 texture_resolution: int = 128, render_grid_size: int = 64,
                 latent_size: int = 64, interpolation_mode: str = "bilinear",
                 dy: float = 0.25):
        super().__init__()
        self.mesh = mesh                      # normalized target mesh
        self.env_sphere = env_sphere          # background dome
        self.face_uv_attr = face_uv_attr      # (1, F, 3, 2)
        self.latent_mode = latent_mode
        self.texture_resolution = texture_resolution
        self.render_grid_size = render_grid_size
        self.latent_size = latent_size        # SDS latent resolution
        self.interpolation_mode = interpolation_mode
        self.camera = mrender.CameraSpec()
        self.dy = dy                          # look-at height (guide.dy)
        dev, R = mesh.vertices.device, texture_resolution
        self.background_sphere_colors = nn.Parameter(
            torch.zeros((1, env_sphere.num_faces, 3, 4), device=dev))
        self.texture_img = nn.Parameter(torch.zeros((1, R, R, 4), device=dev))
        self.texture_img_rgb_finetune = nn.Parameter(
            torch.zeros((1, R, R, 3), device=dev))

    @property
    def device(self) -> torch.device:
        return self.texture_img.device

    # ------------------------------------------------------------------ #
    @classmethod
    def create(cls, shape_path: Optional[str] = None,
               mesh: Optional[Mesh] = None, shape_scale: float = 0.6,
               dy: float = 0.25, latent_mode: bool = True,
               texture_resolution: int = 128, render_grid_size: int = 64,
               interpolation_mode: str = "bilinear",
               cache_dir: Optional[Path] = None,
               enable_displacement: bool = False, dual_camera: bool = False,
               soft_mask_sigma: Optional[float] = None,
               env_mesh: Optional[Mesh] = None,
               device: Optional[torch.device] = None) -> "TexturedMeshScene":
        """Load and normalize the target mesh, resolve its UV source (mesh
        UVs → disk cache → chart unwrap) and put everything on `device`
        (CUDA unless the caller names another)."""
        for name, asked in (("enable_displacement", enable_displacement),
                            ("dual_camera", dual_camera),
                            ("soft_mask_sigma", soft_mask_sigma is not None)):
            if asked:
                raise NotImplementedError(f"{name} {MESH_SLICE}")
        device = resolve_device(device)
        if mesh is None:
            mesh = shapes.load_shape(shape_path)
        mesh = mesh.normalize(target_scale=shape_scale, dy=dy)

        if mesh.vt is not None and mesh.ft is not None and \
                mesh.vt.shape[0] > 0 and int(mesh.ft.min()) > -1:
            vt, ft = mesh.vt, mesh.ft
        else:
            vt_np, ft_np = uv_unwrap.get_or_build_uvs(
                mesh.vertices.cpu().numpy(), mesh.faces.cpu().numpy(),
                cache_dir)
            vt, ft = torch.from_numpy(vt_np), torch.from_numpy(ft_np)
        face_uv_attr = cam.index_vertices_by_faces(vt, ft)[None]
        env = env_mesh if env_mesh is not None else shapes.env_sphere()
        return cls(mesh=mesh.to(device), env_sphere=env.to(device),
                   face_uv_attr=face_uv_attr.to(device),
                   latent_mode=latent_mode,
                   texture_resolution=texture_resolution,
                   render_grid_size=render_grid_size,
                   interpolation_mode=interpolation_mode, dy=dy)

    # ------------------------------------------------------------------ #
    def init_params(self, generator: Optional[torch.Generator] = None,
                    init_rgb_color=(1.0, 0.0, 0.0),
                    texture_latents: Optional[torch.Tensor] = None,
                    texture_rgb: Optional[torch.Tensor] = None,
                    background_u: Optional[torch.Tensor] = None,
                    texture_noise: Optional[torch.Tensor] = None) -> None:
        """Draw the learnable state: latent texture = 0.3·latent(red) +
        0.4·noise; uniform random dome colours; a zero RGB-finetune texture.
        The draws — `background_u` (1, Fb, 3, 4) in [0, 1) and
        `texture_noise` (1, R, R, 4) standard normal — are taken from
        `generator`, in that order, unless given. `texture_latents` /
        `texture_rgb` seed the textures instead."""
        dev, R = self.device, self.texture_resolution
        with torch.no_grad():
            if background_u is None:
                background_u = torch.rand(
                    self.background_sphere_colors.shape, generator=generator,
                    device=dev)
            self.background_sphere_colors.copy_(background_u)
            if texture_latents is not None:
                self.texture_img.copy_(texture_latents)
            else:
                if texture_noise is None:
                    texture_noise = torch.randn((1, R, R, 4),
                                                generator=generator,
                                                device=dev)
                init_latent = rgb_to_latent_init(torch.tensor(
                    init_rgb_color, dtype=torch.float32)).to(dev)
                self.texture_img.copy_(init_latent[None, None, None, :] * 0.3
                                       + 0.4 * texture_noise.to(dev))
            if texture_rgb is not None:
                self.texture_img_rgb_finetune.copy_(texture_rgb)
            else:
                self.texture_img_rgb_finetune.zero_()

    def trainable_keys(self) -> Tuple[str, ...]:
        """Which parameters the texture optimizer owns: the dome colours
        and the texture of the current mode."""
        tex = "texture_img" if self.latent_mode else "texture_img_rgb_finetune"
        return ("background_sphere_colors", tex)

    # ------------------------------------------------------------------ #
    def _active_texture(self) -> torch.Tensor:
        if self.latent_mode:
            return self.texture_img
        return self.texture_img_rgb_finetune

    def _background_colors(self) -> torch.Tensor:
        bg = self.background_sphere_colors
        if not self.latent_mode:
            bg = bg @ LINEAR_RGB_ESTIMATOR.to(bg.device)
        return bg

    def render_train(self, views: ViewBatch) -> Dict[str, torch.Tensor]:
        """Training render: textured foreground + dome background,
        composited through the detached mask, resized to the SDS latent
        grid."""
        dims = (self.render_grid_size,) * 2
        out = self._render_views(views, self._active_texture(), dims=dims,
                                 white_background=False)
        spec = dataclasses.replace(self.camera, look_at_height=self.dy)
        bg_img, _ = mrender.render_single_view(
            self.env_sphere.vertices, self.env_sphere.faces,
            self._background_colors(), views.theta, views.phi, views.radius,
            spec=spec, dims=dims)

        mask = out.mask.detach()
        image = bg_img * (1.0 - mask) + out.image * mask
        result = {"image": image, "mask": mask, "background": bg_img,
                  "foreground": out.image, "soft_mask": out.mask,
                  "normals": None, "lighting": None, "depth": out.depth}
        if self.latent_mode and self.render_grid_size != self.latent_size:
            # one resize for the five maps, stacked along the channels
            keys = ("image", "mask", "background", "foreground", "depth")
            maps = texk.resize_bicubic(
                torch.cat([result[k] for k in keys], dim=-1),
                self.latent_size, self.latent_size)
            sizes = [result[k].shape[-1] for k in keys]
            result.update(zip(keys, maps.split(sizes, dim=-1)))
        return result

    def _render_views(self, views: ViewBatch, texture: torch.Tensor, dims,
                      white_background: bool) -> mrender.RenderOutput:
        """The single-camera render of a batch of views."""
        spec = dataclasses.replace(self.camera, look_at_height=self.dy)
        tex_b = texture.expand(views.batch_size, *texture.shape[1:])
        return mrender.render_single_view_texture(
            self.mesh.vertices, self.mesh.faces, self.face_uv_attr, tex_b,
            views.theta, views.phi, views.radius, spec=spec, dims=dims,
            interpolation_mode=self.interpolation_mode,
            white_background=white_background, detach_uv=True)

    def _rgb_texture(self, decode_fn: Optional[Callable]) -> torch.Tensor:
        """The texture as RGB (1, H, W, 3): the latent one decoded."""
        if not self.latent_mode:
            return self.texture_img_rgb_finetune
        if decode_fn is None:
            raise ValueError("a decode function is needed to decode the "
                             "latent texture")
        return decode_fn(self.texture_img)

    @torch.no_grad()
    def render_test(self, views: ViewBatch,
                    decode_fn: Optional[Callable] = None,
                    dims: Tuple[int, int] = (512, 512)
                    ) -> Dict[str, torch.Tensor]:
        """Eval render: decode the latent texture to RGB first, white
        background."""
        texture = self._rgb_texture(decode_fn)
        out = self._render_views(views, texture, dims=dims,
                                 white_background=True)
        return {"image": out.image, "texture_map": texture, "mask": out.mask,
                "normals": None, "lighting": None}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def export_mesh(self, path: Path,
                    decode_fn: Optional[Callable] = None) -> None:
        """OBJ + MTL + albedo export."""
        colors = self._rgb_texture(decode_fn)[0]
        # rebuild flat vt/ft from the face attribute tensor
        fuv = self.face_uv_attr[0].cpu().numpy()       # (F, 3, 2)
        n_faces = fuv.shape[0]
        vt = fuv.reshape(-1, 2)
        ft = np.arange(3 * n_faces, dtype=np.int32).reshape(n_faces, 3)
        save_obj_with_mtl(path, self.mesh.vertices.cpu().numpy(),
                          self.mesh.faces.cpu().numpy(), vt, ft,
                          colors.cpu().numpy())

    def migrate_latent_to_rgb(self, decode_fn: Callable) -> None:
        raise NotImplementedError(
            "the latent→RGB finetune stage comes with the checkpoint slice "
            "of the port (see ROADMAP.md)")
