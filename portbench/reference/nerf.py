"""Plain PyTorch latent-NeRF: poses, pinhole rays, stratified samples, the
occupancy grid and its fixed-K compaction, the multiresolution hash
encoding (Instant-NGP), the density and colour MLPs with trunc_exp and the
Gaussian density blob, the direction-conditioned background, compositing.

A frozen copy of the equations of Latent-NeRF (arXiv 2211.07600) as the
configuration runs them: bias-free ReLU MLPs, 4 latent channels (3 RGB
channels through a sigmoid in the refine stage), SH degree 4 direction
encoding, S stratified samples a ray of which the first K occupied ones
are evaluated. Everything in float32; the MLPs' products go through
`precision.Linear`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from portbench.reference.precision import Linear

PRIMES = (1, 2654435761, 805459861)


# --------------------------------------------------------------------------
# poses and rays
# --------------------------------------------------------------------------

def poses(u: torch.Tensor, view: dict) -> Dict[str, torch.Tensor]:
    """Poses from U[0, 1) draws `u` (4, B): radius, polar angle, azimuth,
    and the body/head coin; with the prompt direction of each view."""
    r0, r1 = view["radius_range"]
    t0, t1 = (math.radians(v) for v in view["theta_range"])
    p0, p1 = (math.radians(v) for v in view["phi_range"])
    theta = u[1] * (t1 - t0) + t0
    phi = u[2] * (p1 - p0) + p0
    return {"radius": u[0] * (r1 - r0) + r0, "theta": theta, "phi": phi,
            "dirs": direction(theta, phi, math.radians(view["angle_overhead"]),
                              math.radians(view["angle_front"])),
            "is_body": u[3] < view["body_prob"]}


def direction(theta, phi, overhead: float, front: float) -> torch.Tensor:
    """0 front, 1 left side, 2 back, 3 right side, 4 overhead, 5 bottom."""
    phi = torch.remainder(phi, 2 * math.pi)
    half = front / 2
    d = torch.full(theta.shape, 3, dtype=torch.int64, device=theta.device)
    d = torch.where((phi >= 2 * math.pi - half) | (phi < half), 0, d)
    d = torch.where((phi >= half) & (phi < math.pi - half), 1, d)
    d = torch.where((phi >= math.pi - half) & (phi < math.pi + half), 2, d)
    d = torch.where(theta <= overhead, 4, d)
    return torch.where(theta >= math.pi - overhead, 5, d)


def camera_position(theta, phi, radius) -> torch.Tensor:
    return torch.stack([radius * torch.sin(theta) * torch.sin(phi),
                        radius * torch.cos(theta),
                        radius * torch.sin(theta) * torch.cos(phi)], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def look_at(pos: torch.Tensor, height: float) -> torch.Tensor:
    """World→camera (B, 4, 3) for a camera at `pos` looking at (0, height,
    0) with +Y up (+Z up where the view is vertical); camera looks down −z,
    applied as [p, 1] @ M."""
    target = torch.zeros_like(pos)
    target[:, 1] = height
    up = torch.zeros_like(pos)
    up[:, 1] = 1.0
    z = _unit(pos - target)
    x = torch.linalg.cross(up, z)
    alt = torch.zeros_like(pos)
    alt[:, 2] = 1.0
    x = torch.where(torch.sum(x * x, -1, keepdim=True) < 1e-8,
                    torch.linalg.cross(alt, z), x)
    x = _unit(x)
    y = torch.linalg.cross(z, x)
    rot = torch.stack([x, y, z], dim=-1)
    trans = -torch.einsum("bi,bij->bj", pos, rot)
    return torch.cat([rot, trans[:, None]], dim=1)


def rays(pose: Dict[str, torch.Tensor], H: int, W: int, fovy: float,
         height: float, bound: float, min_near: float = 0.05):
    """Pinhole rays through the pixel centres (row-major, +y up):
    origins, unit directions, near and far of the AABB [−bound, bound]³,
    each (B, H·W, …)."""
    pos = camera_position(pose["theta"], pose["phi"], pose["radius"])
    R = look_at(pos, height)[:, :3, :]
    dev = pos.device
    ys = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    tan = math.tan(fovy / 2)
    d_cam = torch.stack([gx.reshape(-1) * tan, gy.reshape(-1) * tan,
                         -torch.ones(H * W, device=dev)], dim=-1)
    d = torch.einsum("pc,bcw->bpw", d_cam, R.transpose(-1, -2))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = pos[:, None, :].expand_as(d)
    inv = 1.0 / torch.where(d.abs() > 1e-9, d, torch.full_like(d, 1e-9))
    ta, tb = (-bound - o) * inv, (bound - o) * inv
    near = torch.clamp(torch.amax(torch.minimum(ta, tb), -1), min=min_near)
    far = torch.maximum(torch.amin(torch.maximum(ta, tb), -1), near + 1e-4)
    return o, d, near, far


# --------------------------------------------------------------------------
# occupancy grid
# --------------------------------------------------------------------------

def cell_of(x: torch.Tensor, G: int, bound: float) -> torch.Tensor:
    """Flat z-minor index of the cell that holds each x (..., 3)."""
    bnd = torch.tensor(bound, dtype=x.dtype, device=x.device)
    i = torch.clamp(((x / bnd + 1.0) / 2.0 * G).to(torch.int32), 0,
                    G - 1).to(torch.int64)
    return (i[..., 0] * G + i[..., 1]) * G + i[..., 2]


def cell_centres(G: int, bound: float, device) -> torch.Tensor:
    ax = (torch.arange(G, dtype=torch.float32, device=device)
          + 0.5) / G * 2 - 1
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                       -1) * bound


def refresh(grid: torch.Tensor, density, u: torch.Tensor, G: int,
            bound: float, decay: float) -> torch.Tensor:
    """grid ← max(decay·grid, σ at the jittered cell centres)."""
    c = cell_centres(G, bound, grid.device)
    pts = torch.clamp(c + (u - 0.5) * (2 * bound / G), -bound, bound)
    with torch.no_grad():
        sigma = torch.cat([density(p)[0] for p in pts.split(1 << 20)])
    return torch.maximum(grid * decay, sigma)


def compact(occ: torch.Tensor, K: int, *arrays: torch.Tensor):
    """The first K occupied samples of each ray in depth order: (valid
    (..., K), each array's (..., K[, C])), zero past the last."""
    n = occ.long()
    rank = torch.cumsum(n, -1) - n
    keep = occ & (rank < K)
    slot = torch.where(keep, rank, torch.full_like(rank, K))
    valid = torch.arange(K, device=occ.device) < n.sum(-1, keepdim=True)
    outs = []
    for a in arrays:
        if a.ndim == occ.ndim:
            buf = a.new_zeros((*a.shape[:-1], K + 1))
            outs.append(buf.scatter(-1, slot, a)[..., :K])
        else:
            C = a.shape[-1]
            buf = a.new_zeros((*a.shape[:-2], K + 1, C))
            outs.append(buf.scatter(-2, slot[..., None].expand(
                *slot.shape, C), a)[..., :K, :])
    return (valid, *outs)


# --------------------------------------------------------------------------
# the field
# --------------------------------------------------------------------------

def hash_levels(g: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Each level's resolution and whether its (res+1)³ grid is indexed
    directly (it fits the table) instead of hashed."""
    L, base, top = g["n_levels"], g["base_resolution"], g["desired_resolution"]
    s = 1.0 if L == 1 else math.exp(math.log(top / base) / (L - 1))
    res = np.array([int(np.floor(base * s ** l)) for l in range(L)],
                   np.int64)
    return res, (res + 1) ** 3 <= (1 << g["log2_hashmap_size"])


def hash_encode(x01: torch.Tensor, table: torch.Tensor, g: dict
                ) -> torch.Tensor:
    """x (N, 3) in [0, 1]³ → trilinear features (N, L·F) of the (L, T, F)
    table: each corner's slot is its dense index where the level fits the
    table, else (x ^ y·π₂ ^ z·π₃) mod T."""
    res_np, dense_np = hash_levels(g)
    L, T, F = table.shape
    res = torch.as_tensor(res_np, device=x01.device)
    dense = torch.as_tensor(dense_np, device=x01.device)
    xl = x01[None] * res[:, None, None].to(x01.dtype)
    x0f = torch.floor(xl)
    w = xl - x0f
    r = res[:, None]
    x0 = torch.minimum(torch.clamp(x0f.long(), min=0), res[:, None, None])
    out = 0.0
    for corner in range(8):
        dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        ix = torch.minimum(x0[..., 0] + dx, r)
        iy = torch.minimum(x0[..., 1] + dy, r)
        iz = torch.minimum(x0[..., 2] + dz, r)
        idx = torch.where(dense[:, None], (ix * (r + 1) + iy) * (r + 1) + iz,
                          (ix ^ (iy * PRIMES[1]) ^ (iz * PRIMES[2])) & (T - 1))
        wt = ((w[..., 0] if dx else 1 - w[..., 0])
              * (w[..., 1] if dy else 1 - w[..., 1])
              * (w[..., 2] if dz else 1 - w[..., 2]))
        feats = torch.gather(table, 1, idx[..., None].expand(L, -1, F))
        out = out + wt[..., None] * feats
    return out.permute(1, 0, 2).reshape(x01.shape[0], L * F)


def sh(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis of degree 4 (16 values) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], dim=-1)


class MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(Linear(a, b, bias=False)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class TruncExp(torch.autograd.Function):
    """exp of the input clamped to [−15, 15], with the same clamp in its
    derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -15.0, 15.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


class Field(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        g = cfg["grid"]
        self.cfg = cfg
        self.hash_table = nn.Parameter(torch.zeros(
            g["n_levels"], 1 << g["log2_hashmap_size"],
            g["n_features_per_level"]))
        enc = g["n_levels"] * g["n_features_per_level"]
        geo, n_sh = cfg["geo_feat_dim"], cfg["sh_degree"] ** 2
        self.sigma_mlp = MLP([enc] + [cfg["hidden_dim"]]
                             * (cfg["num_layers"] - 1) + [1 + geo])
        self.color_mlp = MLP([n_sh + geo] + [cfg["hidden_dim_color"]]
                             * (cfg["num_layers_color"] - 1)
                             + [cfg["out_channels"]])
        self.bg_mlp = MLP([n_sh, cfg["bg_hidden_dim"], cfg["out_channels"]])

    def density(self, x):
        c, b = self.cfg, self.cfg["bound"]
        x01 = torch.clamp((x + b) / (2 * b), 0.0, 1.0)
        h = self.sigma_mlp(hash_encode(x01, self.hash_table, c["grid"]))
        blob = c["density_blob_scale"] * torch.exp(
            -torch.sum(x * x, -1) / (2 * c["density_blob_std"] ** 2))
        return TruncExp.apply(h[..., 0] + torch.log(blob + 1e-6)), h[..., 1:]

    def forward(self, x, d):
        sigma, geo = self.density(x)
        c = self.color_mlp(torch.cat([sh(d), geo], -1))
        return sigma, self._act(c)

    def background(self, d):
        return self._act(self.bg_mlp(sh(d)))

    def _act(self, c):
        return torch.sigmoid(c) if self.cfg["out_channels"] == 3 else c


def render(field: Field, pose, u: torch.Tensor, grid: torch.Tensor,
           scene: dict) -> Dict[str, torch.Tensor]:
    """The train render at the train grid: stratified jitter `u` (B, P, S),
    occupancy-gated compaction to K, compositing over the background;
    with the sparsity regulariser."""
    H, S, K = scene["train_grid_size"], scene["num_samples"], \
        scene["num_compacted"]
    bound, G = scene["bound"], scene["occupancy_resolution"]
    o, d, near, far = rays(pose, H, H, math.pi / 3, scene["dy"], bound)
    B, P, _ = o.shape
    ts = (torch.arange(S, dtype=torch.float32, device=o.device) + 0.5) / S
    ts = ts + (u - 0.5) / S
    t = near[..., None] + (far - near)[..., None] * ts
    xyz = torch.clamp(o[..., None, :] + d[..., None, :] * t[..., None],
                      -bound, bound)
    occ = grid[cell_of(xyz, G, bound)] > scene["density_threshold"]
    valid, t_k, xyz_k = compact(occ, K, t, xyz)
    sigma, color = field(xyz_k.reshape(-1, 3),
                         d[..., None, :].expand_as(xyz_k).reshape(-1, 3))
    sigma = sigma.reshape(B, P, K)
    color = color.reshape(B, P, K, -1)
    sd = sigma * ((far - near) / S)[..., None] * valid
    w = torch.exp(-(torch.cumsum(sd, -1) - sd)) * (1.0 - torch.exp(-sd))
    image = torch.einsum("bpk,bpkc->bpc", w, color)
    wsum = w.sum(-1)
    bg = field.background(d.reshape(-1, 3)).reshape(B, P, -1)
    image = image + (1.0 - wsum)[..., None] * bg
    return {"image": image.reshape(B, H, H, -1),
            "sparsity": torch.mean(torch.sqrt(wsum ** 2 + 0.01))}
