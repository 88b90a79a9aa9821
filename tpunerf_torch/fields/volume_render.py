"""Volumetric renderer: rays → occupancy-pruned marching → compositing.

* pinhole rays from the spherical-camera / NDC conventions of
  core/camera.py (+y up);
* stratified fixed-S sampling inside the ray/AABB span;
* occupancy-grid lookup (the bit-packed CUDA kernel, kernels/occgrid.py)
  and fixed-shape compaction (fields/occupancy.py): the field MLP runs on
  K ≤ S depth-ordered occupied samples per ray;
* exclusive-cumsum transmittance compositing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tpunerf_torch.core import camera as cam
from tpunerf_torch.fields import occupancy as occ_lib


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    num_samples: int = 128      # S stratified candidates per ray
    num_compacted: int = 64     # K field evaluations per ray
    bound: float = 1.0


class Rays(NamedTuple):
    origins: torch.Tensor      # (B, P, 3)
    dirs: torch.Tensor         # (B, P, 3) unit world directions
    near: torch.Tensor         # (B, P)
    far: torch.Tensor          # (B, P)


def pixel_grid_ndc(height: int, width: int,
                   device: torch.device) -> torch.Tensor:
    """(H·W, 2) pixel-center NDC coordinates, row-major, +y up."""
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device)
                + 0.5) / height * 2.0
    xs = (torch.arange(width, dtype=torch.float32, device=device)
          + 0.5) / width * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def generate_rays(theta: torch.Tensor, phi: torch.Tensor,
                  radius: torch.Tensor, height: int, width: int,
                  fovy: float, look_at_height: float = 0.0,
                  bound: float = 1.0, min_near: float = 0.05) -> Rays:
    """Pinhole rays through every pixel center for a batch of spherical
    poses (B,) → Rays of (B, H·W, …)."""
    theta = torch.atleast_1d(theta).float()
    phi = torch.atleast_1d(phi).float()
    radius = torch.broadcast_to(torch.as_tensor(radius).to(theta),
                                theta.shape)
    dev = theta.device

    pos = cam.spherical_camera_position(theta, phi, radius)      # (B, 3)
    # constants filled on the device: a host→device copy would wait for
    # the stream
    look_at = torch.zeros_like(pos)
    look_at[..., 1].fill_(look_at_height)
    up = torch.zeros_like(pos)
    up[..., 1].fill_(1.0)
    M = cam.look_at_transform(pos, look_at, up)                  # (B, 4, 3)
    R = M[..., :3, :]            # rows: world→cam; columns map cam→world

    pix = pixel_grid_ndc(height, width, dev)                     # (P, 2)
    tanfov = math.tan(fovy / 2.0)
    d_cam = torch.stack([pix[:, 0] * tanfov, pix[:, 1] * tanfov,
                         -torch.ones_like(pix[:, 0])], dim=-1)   # (P, 3)
    d_world = torch.einsum("pc,bcw->bpw", d_cam, R.transpose(-1, -2))
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    origins = torch.broadcast_to(pos[:, None, :], d_world.shape)

    near, far = aabb_intersect(origins, d_world, bound, min_near)
    return Rays(origins=origins, dirs=d_world, near=near, far=far)


def aabb_intersect(o: torch.Tensor, d: torch.Tensor, bound: float,
                   min_near: float = 0.05
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against [−bound, bound]³ → (near, far), far ≥ near."""
    inv_d = 1.0 / torch.where(d.abs() > 1e-9, d, torch.full_like(d, 1e-9))
    t0 = (-bound - o) * inv_d
    t1 = (bound - o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    near = torch.clamp(tmin, min=min_near)
    far = torch.maximum(tmax, near + 1e-4)
    return near, far


class RenderResult(NamedTuple):
    image: torch.Tensor        # (B, P, C) composited radiance/latent
    weights_sum: torch.Tensor  # (B, P) accumulated opacity
    depth: torch.Tensor        # (B, P)
    weights: torch.Tensor      # (B, P, K) per-sample weights
    sigmas: torch.Tensor       # (B, P, K)
    xyzs: torch.Tensor         # (B, P, K, 3) evaluated sample positions
    valid: torch.Tensor        # (B, P, K)


def composite(sigma: torch.Tensor, color: torch.Tensor, dt: torch.Tensor,
              valid: torch.Tensor, t: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Transmittance compositing over the sample axis.

    sigma/dt/valid/t: (..., K); color: (..., K, C).
    Returns (image (..., C), weights_sum, depth, weights)."""
    sig_dt = sigma * dt * valid
    tau = torch.cumsum(sig_dt, dim=-1) - sig_dt      # exclusive prefix
    T = torch.exp(-tau)
    alpha = 1.0 - torch.exp(-sig_dt)
    w = T * alpha
    image = torch.einsum("...k,...kc->...c", w, color)
    wsum = torch.sum(w, dim=-1)
    depth = torch.sum(w * t, dim=-1)
    return image, wsum, depth, w


def render_rays(sigma_color_fn: Callable, rays: Rays, cfg: MarchConfig,
                occ_grid: Optional[torch.Tensor] = None,
                occ_cfg: Optional[occ_lib.OccupancyGridConfig] = None,
                perturb: bool = True,
                occ_packed: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> RenderResult:
    """March a batch of rays.

    sigma_color_fn: (x (N, 3), d (N, 3)) → (sigma (N,), color (N, C)).
    `u` (B, P, S) holds the U[0, 1) stratified-jitter draws; drawn from
    `generator` when not given (and only when `perturb`)."""
    B, P, _ = rays.origins.shape
    S, K = cfg.num_samples, cfg.num_compacted
    dev = rays.origins.device

    ts = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    ts = torch.broadcast_to(ts, (B, P, S))
    if perturb:
        if u is None:
            u = torch.rand((B, P, S), generator=generator, device=dev)
        ts = ts + (u.to(ts) - 0.5) / S
    t = rays.near[..., None] + (rays.far - rays.near)[..., None] * ts
    dt_full = (rays.far - rays.near) / S                         # (B, P)

    xyz = rays.origins[..., None, :] + rays.dirs[..., None, :] * \
        t[..., None]                                             # (B,P,S,3)
    xyz = torch.clamp(xyz, -cfg.bound, cfg.bound)

    if occ_grid is not None and occ_cfg is not None:
        occ = occ_lib.occupied(occ_grid, xyz, occ_cfg, packed=occ_packed)
    else:
        occ = torch.ones((B, P, S), dtype=torch.bool, device=dev)
    valid, t_k, xyz_k = occ_lib.compact_gather(occ, K, t, xyz)  # (B,P,K)

    flat_x = xyz_k.reshape(-1, 3)
    flat_d = torch.broadcast_to(rays.dirs[..., None, :],
                                xyz_k.shape).reshape(-1, 3)
    sigma, color = sigma_color_fn(flat_x, flat_d)
    C = color.shape[-1]
    sigma = sigma.reshape(B, P, K)
    color = color.reshape(B, P, K, C)

    image, wsum, depth, w = composite(sigma, color, dt_full[..., None],
                                      valid, t_k)
    return RenderResult(image=image, weights_sum=wsum, depth=depth,
                        weights=w, sigmas=sigma, xyzs=xyz_k, valid=valid)
