"""TexturedMeshScene — a mesh with a learnable latent UV texture and,
optionally, a learnable per-vertex displacement.

An `nn.Module` holding its parameters NHWC / face-major exactly as the JAX
package's params pytree holds them (no transposition):

* `background_sphere_colors` (1, Fb, 3, 4) — per-face-vertex colours of the
  background dome;
* `texture_img` (1, R, R, 4) — the latent texture;
* `texture_img_rgb_finetune` (1, R, R, 3) — the RGB texture (frozen in
  latent mode);
* with `enable_displacement`: `displacement` (V, 3), regularised by the
  uniform Laplacian, and `lights` (1, 9), the SH lighting coefficients.

With `dual_camera` each view is rendered by the body and the head camera
and picked by `views.is_body`; with `soft_mask_sigma` the mask is the DIB-R
soft silhouette. The mesh, its UV attributes and the dome live on the
scene's device from `create` on. The device-mesh layout belongs to a later
slice of the port.
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
from tpunerf_torch.meshrep import render as mrender
from tpunerf_torch.meshrep import shapes, uv_unwrap
from tpunerf_torch.meshrep.laplacian import UniformLaplacian
from tpunerf_torch.meshrep.mesh import Mesh
from tpunerf_torch.utils import resolve_device



class TexturedMeshScene(nn.Module):
    def __init__(self, mesh: Mesh, env_sphere: Mesh,
                 face_uv_attr: torch.Tensor, latent_mode: bool = True,
                 texture_resolution: int = 128, render_grid_size: int = 64,
                 latent_size: int = 64, interpolation_mode: str = "bilinear",
                 dy: float = 0.25, enable_displacement: bool = False,
                 dual_camera: bool = False,
                 soft_mask_sigma: Optional[float] = None):
        super().__init__()
        self.mesh = mesh                      # normalized target mesh
        self.env_sphere = env_sphere          # background dome
        self.face_uv_attr = face_uv_attr      # (1, F, 3, 2)
        self.latent_mode = latent_mode
        self.texture_resolution = texture_resolution
        self.render_grid_size = render_grid_size
        self.latent_size = latent_size        # SDS latent resolution
        self.interpolation_mode = interpolation_mode
        self.camera = (mrender.BODY_CAMERA if dual_camera
                       else mrender.CameraSpec())
        self.head_camera = mrender.HEAD_CAMERA if dual_camera else None
        self.dy = dy                          # look-at height (guide.dy)
        self.enable_displacement = enable_displacement
        self.soft_mask_sigma = soft_mask_sigma
        dev, R = mesh.vertices.device, texture_resolution
        self.laplacian = self.verts0_lap = None
        if enable_displacement:
            self.laplacian = UniformLaplacian.from_faces(
                mesh.faces.cpu().numpy(), mesh.num_vertices, dev)
            self.verts0_lap = self.laplacian.matvec(mesh.vertices)
            self.displacement = nn.Parameter(torch.zeros_like(mesh.vertices))
            self.lights = nn.Parameter(torch.zeros((1, 9), device=dev))
        self.background_sphere_colors = nn.Parameter(
            torch.zeros((1, env_sphere.num_faces, 3, 4), device=dev))
        self.texture_img = nn.Parameter(torch.zeros((1, R, R, 4), device=dev))
        self.texture_img_rgb_finetune = nn.Parameter(
            torch.zeros((1, R, R, 3), device=dev))
        # on the device once: a copy from the host inside a step would
        # synchronise (and a CUDA graph's capture refuses it)
        self.rgb_estimator = LINEAR_RGB_ESTIMATOR.to(dev)

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
                   interpolation_mode=interpolation_mode, dy=dy,
                   enable_displacement=enable_displacement,
                   dual_camera=dual_camera, soft_mask_sigma=soft_mask_sigma)

    # ------------------------------------------------------------------ #
    def init_params(self, generator: Optional[torch.Generator] = None,
                    init_rgb_color=(1.0, 0.0, 0.0),
                    texture_latents: Optional[torch.Tensor] = None,
                    texture_rgb: Optional[torch.Tensor] = None,
                    background_u: Optional[torch.Tensor] = None,
                    texture_noise: Optional[torch.Tensor] = None) -> None:
        """Draw the learnable state: latent texture = 0.3·latent(red) +
        0.4·noise; uniform random dome colours; a zero RGB-finetune texture;
        with displacement, a zero displacement and lights = (3, 0, …, 0).
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
            if self.enable_displacement:
                self.displacement.zero_()
                self.lights.zero_()
                self.lights[0, 0] = 3.0

    def trainable_keys(self) -> Tuple[str, ...]:
        """Which parameters the texture optimizer owns: the dome colours
        and the texture of the current mode (the displacement and the lights
        have a learning rate of their own)."""
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
            bg = bg @ self.rgb_estimator
        return bg

    def _displacement(self) -> Optional[torch.Tensor]:
        return self.displacement if self.enable_displacement else None

    def render_train(self, views: ViewBatch, with_lighting: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Training render: textured foreground + dome background,
        composited through the detached mask, resized to the SDS latent
        grid. `soft_mask` is the mask with its gradient to the vertices."""
        dims = (self.render_grid_size,) * 2
        disp = self._displacement()
        out = self._render_views(
            views, self._active_texture(), dims=dims, white_background=False,
            displacement=disp,
            compute_normals=with_lighting or self.enable_displacement,
            lights=self.lights if with_lighting else None)
        spec = dataclasses.replace(self.camera, look_at_height=self.dy)
        bg_img, _ = mrender.render_single_view(
            self.env_sphere.vertices, self.env_sphere.faces,
            self._background_colors(), views.theta, views.phi, views.radius,
            spec=spec, dims=dims)

        mask = out.mask.detach()
        image = bg_img * (1.0 - mask) + out.image * mask
        result = {"image": image, "mask": mask, "background": bg_img,
                  "foreground": out.image, "soft_mask": out.mask,
                  "normals": out.normals, "lighting": out.lighting,
                  "depth": out.depth}
        if self.latent_mode and self.render_grid_size != self.latent_size:
            # one resize for the five maps, stacked along the channels
            keys = ("image", "mask", "background", "foreground", "depth")
            maps = texk.resize_bicubic(
                torch.cat([result[k] for k in keys], dim=-1),
                self.latent_size, self.latent_size)
            sizes = [result[k].shape[-1] for k in keys]
            result.update(zip(keys, maps.split(sizes, dim=-1)))
            result["mask"] = result["mask"].detach()
        if disp is not None:
            result["laplacian_loss"] = self.laplacian.loss(
                self.mesh.vertices + disp, self.verts0_lap)
            result["displacement_norm"] = torch.mean(disp ** 2)
        return result

    def _render_views(self, views: ViewBatch, texture: torch.Tensor, dims,
                      white_background: bool,
                      displacement: Optional[torch.Tensor] = None,
                      compute_normals: bool = False,
                      lights: Optional[torch.Tensor] = None
                      ) -> mrender.RenderOutput:
        """The render of a batch of views: by the one camera, or by the
        body and the head camera with each view taking its own."""
        tex_b = texture.expand(views.batch_size, *texture.shape[1:])

        def one(spec):
            return mrender.render_single_view_texture(
                self.mesh.vertices, self.mesh.faces, self.face_uv_attr, tex_b,
                views.theta, views.phi, views.radius, spec=spec, dims=dims,
                interpolation_mode=self.interpolation_mode,
                white_background=white_background,
                detach_uv=not self.enable_displacement,
                displacement=displacement, compute_normals=compute_normals,
                lights=lights, soft_mask_sigma=self.soft_mask_sigma)

        if self.head_camera is None:
            return one(dataclasses.replace(self.camera,
                                           look_at_height=self.dy))
        body, head = one(self.camera), one(self.head_camera)
        sel = views.is_body.float()[:, None, None, None]

        def mix(a, b):
            return None if a is None else a * sel + b * (1 - sel)

        return mrender.RenderOutput(
            image=mix(body.image, head.image), mask=mix(body.mask, head.mask),
            face_idx=torch.where(views.is_body[:, None, None], body.face_idx,
                                 head.face_idx),
            normals=mix(body.normals, head.normals),
            lighting=mix(body.lighting, head.lighting),
            depth=mix(body.depth, head.depth))

    def _rgb_texture(self, decode_fn: Optional[Callable]) -> torch.Tensor:
        """The texture as RGB (1, H, W, 3): the latent one decoded."""
        if not self.latent_mode:
            return self.texture_img_rgb_finetune
        if decode_fn is None:
            raise ValueError("a decode function is needed to decode the "
                             "latent texture")
        return decode_fn(self.texture_img)

    def render_test(self, views: ViewBatch,
                    decode_fn: Optional[Callable] = None,
                    dims: Tuple[int, int] = (512, 512),
                    with_lighting: bool = False) -> Dict[str, torch.Tensor]:
        """Eval render: decode the latent texture to RGB first, white
        background. Autograd is left to the caller (the trainer's eval runs
        under `no_grad`); with a soft mask, `mask` carries its gradient to
        the displacement."""
        texture = self._rgb_texture(decode_fn)
        out = self._render_views(
            views, texture, dims=dims, white_background=True,
            displacement=self._displacement(), compute_normals=with_lighting,
            lights=self.lights if with_lighting else None)
        return {"image": out.image, "texture_map": texture, "mask": out.mask,
                "normals": out.normals, "lighting": out.lighting}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def export_mesh(self, path: Path,
                    decode_fn: Optional[Callable] = None) -> None:
        """OBJ + MTL + albedo export, the vertices displaced."""
        colors = self._rgb_texture(decode_fn)[0]
        # rebuild flat vt/ft from the face attribute tensor
        fuv = self.face_uv_attr[0].cpu().numpy()       # (F, 3, 2)
        n_faces = fuv.shape[0]
        vt = fuv.reshape(-1, 2)
        ft = np.arange(3 * n_faces, dtype=np.int32).reshape(n_faces, 3)
        verts = self.mesh.vertices
        if self.enable_displacement:
            verts = verts + self.displacement
        save_obj_with_mtl(path, verts.cpu().numpy(),
                          self.mesh.faces.cpu().numpy(), vt, ft,
                          colors.cpu().numpy())

    @torch.no_grad()
    def migrate_latent_to_rgb(self, params: Dict[str, torch.Tensor],
                              decode_fn: Callable
                              ) -> Dict[str, torch.Tensor]:
        """The latent→RGB finetune's load: `params` with its latent
        `texture_img` decoded, resized (bilinear, antialiased) to the
        texture resolution and put in `texture_img_rgb_finetune`."""
        rgb = decode_fn(params["texture_img"].to(self.device))
        out = dict(params)
        out["texture_img_rgb_finetune"] = texk.resize_bilinear(
            rgb, self.texture_resolution, self.texture_resolution)
        return out
