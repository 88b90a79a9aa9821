"""LatentNeRFScene — the volumetric scene representation.

The hash-grid NeRF field (trainable parameters), the occupancy grid and its
packed bitfield (buffers, refreshed by `update_occupancy`), train-time
rendering with its regularizers and, with a guide shape, the sketch-shape
loss (the SDF grid is a buffer kept out of `state_dict()`), the eval render
(`render_test`), and NeRF→mesh extraction (`density_grid` on the device,
marching tetrahedra on the host).
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.fields import occupancy as occ_lib
from tpunerf_torch.fields import volume_render as vr
from tpunerf_torch.fields.latent_nerf import LatentNeRFConfig, LatentNeRFField
from tpunerf_torch.fields.marching import marching_tetrahedra
from tpunerf_torch.fields.sketch_shape import SDFGrid, sketch_shape_loss
from tpunerf_torch.kernels.texture import resize_cubic_jax
from tpunerf_torch.utils import resolve_device

if TYPE_CHECKING:
    from tpunerf_torch.training.config import TrainConfig

DENSITY_CHUNK = 65536     # points a density-grid chunk, as the JAX package


class LatentNeRFScene(nn.Module):
    def __init__(self, field: LatentNeRFField, march: vr.MarchConfig,
                 occ_cfg: occ_lib.OccupancyGridConfig, dy: float = 0.0,
                 train_grid_size: int = 64, occ_update_interval: int = 16,
                 sdf: Optional[SDFGrid] = None,
                 proximal_surface: float = 0.3):
        super().__init__()
        self.field = field
        self.sdf = sdf                   # the guide shape's SDF, or None
        self.proximal_surface = proximal_surface
        self.march = march
        self.occ_cfg = occ_cfg
        self.fovy = math.pi / 3
        self.dy = dy
        self.train_grid_size = train_grid_size
        self.occ_update_interval = occ_update_interval
        self.latent_size = 64            # the guidance's latent grid
        # the device mesh (dist.mesh.MeshLayout): where it splits each
        # frame's pixels, a train render marches this rank's band only
        self.layout = None
        dev = field.hash_table.device
        grid = occ_lib.init_occupancy(occ_cfg, dev)
        self.register_buffer("occ_grid", grid)
        self.register_buffer("occ_packed",
                             occ_lib.packed_bitfield(grid, occ_cfg))

    @classmethod
    def create(cls, nerf_type: str = "latent", tiny: bool = False,
               bound: float = 1.0, num_samples: int = 128,
               num_compacted: int = 64, train_grid_size: int = 64,
               shape_path: Optional[str] = None, shape_scale: float = 0.6,
               dy: float = 0.0, proximal_surface: float = 0.3,
               sdf_resolution: int = 48, mlp_dtype: str = "auto",
               device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None
               ) -> "LatentNeRFScene":
        """Build the field and its occupancy grid on `device` (CUDA unless
        the caller names another) and, with `shape_path`, the guide shape's
        SDF grid: the shape normalised to `shape_scale` and lifted by `dy`,
        its `sdf_resolution`³ grid built on the host by the C++ library."""
        device = resolve_device(device)
        fcfg = LatentNeRFConfig.tiny() if tiny else LatentNeRFConfig()
        fcfg = dataclasses.replace(
            fcfg, out_channels=4 if nerf_type == "latent" else 3, bound=bound,
            mlp_dtype=mlp_dtype)
        sdf = None
        if shape_path is not None:
            from tpunerf_torch.meshrep import shapes
            mesh = shapes.load_shape(shape_path).normalize(
                target_scale=shape_scale, dy=dy)
            sdf = SDFGrid.from_mesh(mesh.vertices.numpy(),
                                    mesh.faces.numpy(),
                                    resolution=sdf_resolution, bound=bound,
                                    device=device)
        return cls(
            field=LatentNeRFField(fcfg, device, generator),
            march=vr.MarchConfig(num_samples=num_samples,
                                 num_compacted=num_compacted, bound=bound),
            occ_cfg=occ_lib.OccupancyGridConfig(
                resolution=32 if tiny else 128, bound=bound),
            dy=dy, train_grid_size=train_grid_size, sdf=sdf,
            proximal_surface=proximal_surface)

    @classmethod
    def from_config(cls, cfg: "TrainConfig", with_shape: bool = True,
                    device: Optional[torch.device] = None
                    ) -> "LatentNeRFScene":
        """The scene of a latent-NeRF run's config (`render.*`, `guide.*`),
        as its app builds it; without the guide shape's SDF grid unless
        `with_shape` (the grid is kept out of checkpoints and plays no part
        in the NeRF→mesh bridge's mesh)."""
        render, guide = cfg.render, cfg.guide
        return cls.create(
            nerf_type=render.nerf_type, tiny=guide.tiny_diffusion,
            bound=render.bound, num_samples=render.num_samples_per_ray,
            num_compacted=max(render.num_samples_per_ray // 2, 8),
            train_grid_size=render.train_grid_size,
            shape_path=guide.shape_path if with_shape else None,
            shape_scale=guide.shape_scale, dy=guide.dy,
            proximal_surface=guide.proximal_surface,
            mlp_dtype=render.mlp_dtype, device=device)

    # ------------------------------------------------------------------ #
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> None:
        """Re-draw the field's parameters and reset the occupancy grid."""
        self.field.reset_parameters(generator)
        with torch.no_grad():
            self.occ_grid.copy_(occ_lib.init_occupancy(self.occ_cfg,
                                                       self.occ_grid.device))
            self.occ_packed.copy_(occ_lib.packed_bitfield(self.occ_grid,
                                                          self.occ_cfg))

    def trainable_parameters(self):
        return self.field.parameters()

    # ------------------------------------------------------------------ #
    def render_views(self, views: ViewBatch, dims: Tuple[int, int],
                     perturb: bool, use_occupancy: bool,
                     white_background: bool = False,
                     u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     band: bool = False) -> Dict[str, torch.Tensor]:
        """With `band`, this rank marches only its `layout.row_band` of the
        H·W pixels (`u` holds the whole frames' draws); the image, mask and
        depth are then the whole frames again (`layout.gather_rows`), and
        `weights_sum` and the samples are the band's."""
        H, W = dims
        rays = vr.generate_rays(views.theta, views.phi, views.radius, H, W,
                                fovy=self.fovy, look_at_height=self.dy,
                                bound=self.march.bound)
        if band:
            px = self.layout.row_band(H * W)
            rays = vr.Rays(*(r[:, px] for r in rays))
            u = None if u is None else u[:, px]
        res = vr.render_rays(
            self.field, rays, self.march,
            occ_grid=self.occ_grid if use_occupancy else None,
            occ_cfg=self.occ_cfg, perturb=perturb,
            occ_packed=self.occ_packed, u=u, generator=generator)
        B, P, C = res.image.shape
        if white_background:
            bg = torch.ones((B, P, C), dtype=res.image.dtype,
                            device=res.image.device)
        else:
            bg = self.field.background(rays.dirs.reshape(-1, 3)
                                       ).reshape(B, P, C)
        image = res.image + (1.0 - res.weights_sum)[..., None] * bg
        mask, depth = res.weights_sum, res.depth
        if band:
            frame = self.layout.gather_rows(torch.cat(
                [image, mask[..., None], depth[..., None]], dim=-1))
            image, mask, depth = frame.split([C, 1, 1], dim=-1)
        return {
            "image": image.reshape(B, H, W, C),
            "mask": mask.reshape(B, H, W, 1),
            "depth": depth.reshape(B, H, W, 1),
            "weights_sum": res.weights_sum,
            "sigmas": res.sigmas, "xyzs": res.xyzs, "valid": res.valid,
            "weights": res.weights,
        }

    def render_train(self, views: ViewBatch, u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """Train render at the train grid with stratified jitter (`u` of
        shape (B, H·W, S), or drawn from `generator`), plus regularizers
        and, with a guide shape, `shape_loss`. On a mesh that splits the
        step (`layout`), `views` and `u` are this rank's views and their
        draws; the pixels are split too where the rays axis divides them
        (JAX's condition), and the regularizers are this rank's shares of
        the global means (`dist.mesh`)."""
        split = self.layout is not None and self.layout.splits
        P = self.train_grid_size ** 2
        out = self.render_views(views, (self.train_grid_size,) * 2,
                                perturb=True, use_occupancy=True, u=u,
                                generator=generator,
                                band=split and self.layout.bands(P))
        wsum = out["weights_sum"]
        mean = self.layout.mean_share if split else torch.mean
        out["sparsity_loss"] = mean(torch.sqrt(wsum ** 2 + 0.01))
        out["opacity_loss"] = mean(-wsum * torch.log(wsum + 1e-5))
        if self.sdf is not None:
            valid = out["valid"]
            out["shape_loss"] = sketch_shape_loss(
                self.sdf, out["xyzs"], out["sigmas"], valid,
                self.proximal_surface,
                valid_count=(self.layout.all_reduce_sum(valid.sum())
                             if split else None))
        return out

    @torch.no_grad()
    def render_test(self, views: ViewBatch, decode_fn: Optional[Callable],
                    dims: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """Eval render, no random draw: latent fields render at the latent
        grid (white background, occupancy on, no jitter) and decode through
        `decode_fn` to images, resized to `dims` as `jax.image.resize(
        method='bicubic')` resizes where the decoded size differs, then
        clipped to [0, 1]; RGB fields render at `dims` directly."""
        if self.field.config.out_channels == 4:
            out = self.render_views(views, (self.latent_size,) * 2,
                                    perturb=False, use_occupancy=True,
                                    white_background=True)
            rgb = decode_fn(out["image"])
            if rgb.shape[1] != dims[0]:
                # bicubic overshoots [0, 1]
                rgb = resize_cubic_jax(rgb, *dims).clamp(0.0, 1.0)
            return {"image": rgb, "mask": out["mask"], "texture_map": None,
                    "depth": out["depth"]}
        out = self.render_views(views, dims, perturb=False,
                                use_occupancy=True, white_background=True)
        return {"image": out["image"].clamp(0.0, 1.0), "mask": out["mask"],
                "texture_map": None, "depth": out["depth"]}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def update_occupancy(self, u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> None:
        """EMA occupancy refresh in place: the grid and its packed bitfield
        (`u` (G³, 3) jitter draws, or drawn from `generator`)."""
        new_grid = occ_lib.update(self.occ_grid,
                                  lambda x: self.field.density(x)[0],
                                  self.occ_cfg, u=u, generator=generator)
        self.occ_grid.copy_(new_grid)
        self.occ_packed.copy_(occ_lib.packed_bitfield(new_grid,
                                                      self.occ_cfg))

    @torch.no_grad()
    def density_grid(self, resolution: int = 128) -> np.ndarray:
        """Dense σ grid (G, G, G) float32 at the cell centres ((i + ½)/G·2 −
        1)·bound, evaluated on the field's device in chunks of
        DENSITY_CHUNK points, then moved to the host."""
        G = resolution
        ax = (np.arange(G) + 0.5) / G * 2 - 1
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        pts = torch.from_numpy(
            (np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
             * self.march.bound).astype(np.float32)
        ).to(self.occ_grid.device)
        sigmas = [self.field.density(pts[s:s + DENSITY_CHUNK])[0]
                  for s in range(0, pts.shape[0], DENSITY_CHUNK)]
        return torch.cat(sigmas).float().cpu().numpy().reshape(G, G, G)

    def extract_mesh(self, resolution: int = 128, iso: float = 10.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """The iso-surface of the density grid: (verts (V, 3) float32,
        faces (F, 3) int32), oriented outward."""
        grid = self.density_grid(resolution)
        return marching_tetrahedra(grid, iso, bound=self.march.bound)
