"""Sketch-shape guidance: a soft occupancy loss that pulls the density
toward a guide mesh (`guide.shape_path`, `guide.proximal_surface`,
`optim.lambda_shape`; demo_configs/latent_nerf/lego_man.yaml).

The mesh is queried once, on the host: a signed-distance grid (unsigned
point-triangle distance, the sign of the generalized winding number) built
by the C++ library of `tpunerf_torch.native`, or by the numpy version below
where a caller asks for it. Training samples the grid on the device with
gathers and elementwise work only, so a captured step reads nothing back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tpunerf_torch.kernels.texture import _resize_weights, _triangle


def _point_triangle_distance_np(points: np.ndarray, tri: np.ndarray
                                ) -> np.ndarray:
    """Unsigned distance (P,) from points (P,3) to ONE triangle (3,3)."""
    a, b, c = tri
    ab, ac, ap = b - a, c - a, points - a
    d1 = ap @ ab
    d2 = ap @ ac
    # project on plane, clamp barycentrics edge-wise (standard closest-point)
    bp = points - b
    cp = points - c
    d3 = bp @ ab
    d4 = bp @ ac
    d5 = cp @ ab
    d6 = cp @ ac
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    # region tests
    closest = np.empty_like(points)
    done = np.zeros(len(points), bool)

    m = (d1 <= 0) & (d2 <= 0)
    closest[m] = a
    done |= m
    m = (~done) & (d3 >= 0) & (d4 <= d3)
    closest[m] = b
    done |= m
    m = (~done) & (d6 >= 0) & (d5 <= d6)
    closest[m] = c
    done |= m
    m = (~done) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = np.where(np.abs(d1 - d3) > 1e-20, d1 / (d1 - d3 + 1e-20), 0.0)
    closest[m] = a + np.outer(v, ab)[m]
    done |= m
    m = (~done) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = np.where(np.abs(d2 - d6) > 1e-20, d2 / (d2 - d6 + 1e-20), 0.0)
    closest[m] = a + np.outer(v, ac)[m]
    done |= m
    m = (~done) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    v = (d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-20)
    closest[m] = b + np.outer(v, c - b)[m]
    done |= m
    m = ~done
    vsum = np.maximum(va + vb + vc, 1e-20)
    v = vb / vsum
    w = vc / vsum
    closest[m] = (a + np.outer(v, ab) + np.outer(w, ac))[m]
    return np.linalg.norm(points - closest, axis=-1)


def _winding_number_np(points: np.ndarray, verts: np.ndarray,
                       faces: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Generalized winding number (P,): the robust inside test (van
    Oosterom–Strackee solid angles)."""
    out = np.zeros(len(points), np.float64)
    tri = verts[faces]          # (F, 3, 3)
    for s in range(0, len(points), chunk):
        p = points[s:s + chunk]                           # (P, 3)
        ra = tri[None, :, 0] - p[:, None]                 # (P, F, 3)
        rb = tri[None, :, 1] - p[:, None]
        rc = tri[None, :, 2] - p[:, None]
        la = np.linalg.norm(ra, axis=-1)
        lb = np.linalg.norm(rb, axis=-1)
        lc = np.linalg.norm(rc, axis=-1)
        num = np.einsum("pfi,pfi->pf", ra, np.cross(rb, rc))
        den = (la * lb * lc + np.einsum("pfi,pfi->pf", ra, rb) * lc +
               np.einsum("pfi,pfi->pf", rb, rc) * la +
               np.einsum("pfi,pfi->pf", rc, ra) * lb)
        out[s:s + chunk] = np.sum(2.0 * np.arctan2(num, den), axis=-1)
    return out / (4.0 * np.pi)


def sdf_grid_np(vertices: np.ndarray, faces: np.ndarray, resolution: int,
                bound: float, dist_chunk: int = 4096) -> np.ndarray:
    """The plain (numpy) signed-distance grid: (G, G, G) float32 at the
    cell centres ((i + ½)/G·2 − 1)·bound, negative inside."""
    G = resolution
    ax = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()],
                   axis=-1).astype(np.float64) * bound

    tri = vertices[faces]                            # (F, 3, 3)
    dist = np.full(len(pts), np.inf)
    for s in range(0, len(pts), dist_chunk):
        p = pts[s:s + dist_chunk]
        dmin = np.full(len(p), np.inf)
        for f in range(tri.shape[0]):
            d = _point_triangle_distance_np(p, tri[f])
            dmin = np.minimum(dmin, d)
        dist[s:s + dist_chunk] = dmin

    wn = _winding_number_np(pts, vertices.astype(np.float64),
                            faces.astype(np.int64))
    sdf = np.where(wn > 0.5, -dist, dist).astype(np.float32)
    return sdf.reshape(G, G, G)


def prefilter(values: torch.Tensor) -> torch.Tensor:
    """The (2G)³ copy of a (G, G, G) grid that `jax.image.resize(values,
    (2G,)*3, "linear")` gives: the tent with half-pixel centres, each axis'
    weights renormalised at the borders, as three matrix products."""
    G = values.shape[0]
    w = _resize_weights(G, 2 * G, _triangle, values.device
                        ).to(values.dtype)                     # (G, 2G)
    return torch.einsum("ijk,ia,jb,kc->abc", values, w, w, w)


class SDFGrid(nn.Module):
    """A (G, G, G) signed-distance grid over [−bound, bound]³ (negative
    inside) and its 2× prefiltered copy, as buffers that stay out of
    `state_dict()` (a checkpoint holds no guide shape, as the JAX package's
    parameters hold none)."""

    values: torch.Tensor
    pref: torch.Tensor

    def __init__(self, values: torch.Tensor, bound: float):
        super().__init__()
        self.bound = float(bound)
        self.resolution = int(values.shape[0])
        self.register_buffer("values", values, persistent=False)
        # flattened for the one-gather lookup of `sample_fast`
        self.register_buffer("pref", prefilter(values).reshape(-1),
                             persistent=False)

    @classmethod
    def from_mesh(cls, vertices: np.ndarray, faces: np.ndarray,
                  resolution: int = 64, bound: float = 1.0,
                  use_native: bool = True,
                  device: Optional[torch.device] = None) -> "SDFGrid":
        """The grid of a mesh, built on the host (the C++ library, or the
        numpy version with `use_native=False`) and put on `device`."""
        if use_native:
            from tpunerf_torch import native
            sdf = native.sdf_grid(np.asarray(vertices, np.float32),
                                  np.asarray(faces, np.int32), resolution,
                                  bound)
        else:
            sdf = sdf_grid_np(np.asarray(vertices), np.asarray(faces),
                              resolution, bound)
        return cls(torch.from_numpy(sdf).to(device), bound)

    def sample_fast(self, x: torch.Tensor) -> torch.Tensor:
        """One-gather SDF lookup: nearest neighbour on the 2× prefiltered
        grid, in the JAX package's order of float operations (its indices
        exactly; both round half to even). The divisor is a tensor so that
        the card, too, divides."""
        G2 = self.resolution * 2
        u = (x / x.new_full((), self.bound) + 1.0) / 2.0 * G2 - 0.5
        idx = torch.clamp(torch.round(u).to(torch.int32), 0, G2 - 1
                          ).to(torch.int64)
        flat = (idx[..., 0] * G2 + idx[..., 1]) * G2 + idx[..., 2]
        return self.pref[flat]

    def sample(self, x: torch.Tensor) -> torch.Tensor:
        """Trilinear SDF lookup at world points (..., 3)."""
        G = self.resolution
        u = (x / x.new_full((), self.bound) + 1.0) / 2.0 * G - 0.5
        u0 = torch.floor(u)
        w = u - u0
        u0 = torch.clamp(u0.to(torch.int32), 0, G - 1).to(torch.int64)
        u1 = torch.clamp(u0 + 1, 0, G - 1)
        v = self.values
        c = 0.0
        for dx, wx in ((u0[..., 0], 1 - w[..., 0]), (u1[..., 0], w[..., 0])):
            for dy, wy in ((u0[..., 1], 1 - w[..., 1]),
                           (u1[..., 1], w[..., 1])):
                for dz, wz in ((u0[..., 2], 1 - w[..., 2]),
                               (u1[..., 2], w[..., 2])):
                    c = c + wx * wy * wz * v[dx, dy, dz]
        return c


def sketch_shape_loss(sdf: SDFGrid, xyzs: torch.Tensor, sigmas: torch.Tensor,
                      valid: torch.Tensor, proximal_surface: float,
                      delta: float = 0.05,
                      valid_count: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Soft occupancy BCE over the valid samples: target occupancy
    sigmoid(−sdf(x)/proximal_surface) (`sample_fast`), predicted occupancy
    α = 1 − exp(−σ·δ) clipped to [1e-5, 1 − 1e-5]. `valid_count` replaces
    the count of valid samples in the mean (on a mesh, the world's)."""
    target = torch.sigmoid(-sdf.sample_fast(xyzs) / proximal_surface)
    alpha = 1.0 - torch.exp(-sigmas * delta)
    alpha = torch.clamp(alpha, 1e-5, 1.0 - 1e-5)
    bce = -(target * torch.log(alpha) +
            (1.0 - target) * torch.log(1.0 - alpha))
    count = valid.sum() if valid_count is None else valid_count
    denom = torch.clamp(count.to(bce.dtype), min=1.0)
    return torch.sum(bce * valid) / denom
