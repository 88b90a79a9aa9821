"""LatentNeRFScene — the volumetric scene representation.

The hash-grid NeRF field (trainable parameters), the occupancy grid and its
packed bitfield (buffers, refreshed by `update_occupancy`), train-time
rendering with its regularizers, and the eval render (`render_test`). The
sketch-shape SDF loss and mesh extraction are not ported yet (ROADMAP.md
item A.7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.fields import occupancy as occ_lib
from tpunerf_torch.fields import volume_render as vr
from tpunerf_torch.fields.latent_nerf import LatentNeRFConfig, LatentNeRFField
from tpunerf_torch.kernels.texture import resize_cubic_jax
from tpunerf_torch.utils import resolve_device

ROADMAP_A7 = ("not ported yet: the sketch-shape SDF and mesh extraction "
              "are ROADMAP.md item A.7")


class LatentNeRFScene(nn.Module):
    def __init__(self, field: LatentNeRFField, march: vr.MarchConfig,
                 occ_cfg: occ_lib.OccupancyGridConfig, dy: float = 0.0,
                 train_grid_size: int = 64, occ_update_interval: int = 16):
        super().__init__()
        self.field = field
        self.march = march
        self.occ_cfg = occ_cfg
        self.fovy = math.pi / 3
        self.dy = dy
        self.train_grid_size = train_grid_size
        self.occ_update_interval = occ_update_interval
        self.latent_size = 64            # the guidance's latent grid
        dev = field.hash_table.device
        grid = occ_lib.init_occupancy(occ_cfg, dev)
        self.register_buffer("occ_grid", grid)
        self.register_buffer("occ_packed",
                             occ_lib.packed_bitfield(grid, occ_cfg))

    @classmethod
    def create(cls, nerf_type: str = "latent", tiny: bool = False,
               bound: float = 1.0, num_samples: int = 128,
               num_compacted: int = 64, train_grid_size: int = 64,
               shape_path: Optional[str] = None, dy: float = 0.0,
               mlp_dtype: str = "auto",
               device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None
               ) -> "LatentNeRFScene":
        """Build the field and its occupancy grid on `device` (CUDA unless
        the caller names another)."""
        if shape_path is not None:
            raise NotImplementedError(f"guide.shape_path: {ROADMAP_A7}")
        device = resolve_device(device)
        fcfg = LatentNeRFConfig.tiny() if tiny else LatentNeRFConfig()
        fcfg = dataclasses.replace(
            fcfg, out_channels=4 if nerf_type == "latent" else 3, bound=bound,
            mlp_dtype=mlp_dtype)
        return cls(
            field=LatentNeRFField(fcfg, device, generator),
            march=vr.MarchConfig(num_samples=num_samples,
                                 num_compacted=num_compacted, bound=bound),
            occ_cfg=occ_lib.OccupancyGridConfig(
                resolution=32 if tiny else 128, bound=bound),
            dy=dy, train_grid_size=train_grid_size)

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
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        H, W = dims
        rays = vr.generate_rays(views.theta, views.phi, views.radius, H, W,
                                fovy=self.fovy, look_at_height=self.dy,
                                bound=self.march.bound)
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
        return {
            "image": image.reshape(B, H, W, C),
            "mask": res.weights_sum.reshape(B, H, W, 1),
            "depth": res.depth.reshape(B, H, W, 1),
            "weights_sum": res.weights_sum,
            "sigmas": res.sigmas, "xyzs": res.xyzs, "valid": res.valid,
            "weights": res.weights,
        }

    def render_train(self, views: ViewBatch, u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """Train render at the train grid with stratified jitter (`u` of
        shape (B, H·W, S), or drawn from `generator`), plus regularizers."""
        out = self.render_views(views, (self.train_grid_size,) * 2,
                                perturb=True, use_occupancy=True, u=u,
                                generator=generator)
        wsum = out["weights_sum"]
        out["sparsity_loss"] = torch.mean(torch.sqrt(wsum ** 2 + 0.01))
        out["opacity_loss"] = torch.mean(-wsum * torch.log(wsum + 1e-5))
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

    def extract_mesh(self, resolution: int = 128, iso: float = 10.0):
        raise NotImplementedError(f"extract_mesh: {ROADMAP_A7}")
