"""Multiresolution hash-grid encoding (Instant-NGP) + SH direction encoding.

Coordinates are in [0, 1]³. Per-level resolution grows geometrically from
`base_resolution` to `desired_resolution`; levels whose dense grid fits the
table are indexed directly, larger ones through the Instant-NGP spatial hash
(π₁, π₂, π₃ prime XORs). `hash_encode` here is the plain PyTorch version;
the CUDA kernels live in kernels/hashgrid.py.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 12
    n_features_per_level: int = 2
    log2_hashmap_size: int = 11
    base_resolution: int = 16
    desired_resolution: int = 256

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return math.exp(math.log(self.desired_resolution /
                                 self.base_resolution) /
                        (self.n_levels - 1))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_resolutions(self) -> np.ndarray:
        s = self.per_level_scale
        return np.array([int(np.floor(self.base_resolution * s ** l))
                         for l in range(self.n_levels)], np.int32)

    def dense_levels(self) -> np.ndarray:
        """(L,) bool: the level's (res+1)³ grid fits the table. Computed in
        int64 on the host: (res+1)³ overflows int32 at fine levels."""
        res = self.level_resolutions().astype(np.int64)
        return (res + 1) ** 3 <= self.table_size


def init_hash_table(cfg: HashGridConfig, device: torch.device,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """(L, T, F) feature table, U(−1e-4, 1e-4) like Instant-NGP."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features_per_level),
                   generator=generator, device=device)
    return u * 2e-4 - 1e-4


@functools.lru_cache(maxsize=16)
def _level_tables(cfg: HashGridConfig, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each level's resolution (int64) and dense flag, on `device`, made
    once: an upload inside a step is what a CUDA graph's capture refuses."""
    res = torch.as_tensor(cfg.level_resolutions().astype(np.int64),
                          device=device)
    return res, torch.as_tensor(cfg.dense_levels(), device=device)


def corner_indices_and_weights(x: torch.Tensor, cfg: HashGridConfig
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, 3) in [0,1]³ → (idx8 (L, N, 8) int64 table slots,
    w8 (L, N, 8) trilinear weights). The hash is computed in int64 and
    masked with T−1, whose low bits equal the uint32 arithmetic."""
    res, dense = _level_tables(cfg, x.device)                          # (L,)
    xl = x[None, :, :] * res[:, None, None].to(x.dtype)               # (L,N,3)
    x0f = torch.floor(xl)
    w = xl - x0f
    rmax = res[:, None, None]
    x0 = torch.minimum(torch.clamp(x0f.to(torch.int64), min=0), rmax)
    mask = cfg.table_size - 1
    r = res[:, None]
    idxs, wgts = [], []
    for corner in range(8):
        dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        ix = torch.minimum(x0[..., 0] + dx, r)
        iy = torch.minimum(x0[..., 1] + dy, r)
        iz = torch.minimum(x0[..., 2] + dz, r)
        dense_idx = (ix * (r + 1) + iy) * (r + 1) + iz
        hashed = (ix ^ (iy * PRIMES[1]) ^ (iz * PRIMES[2])) & mask
        idxs.append(torch.where(dense[:, None], dense_idx, hashed))
        wx = w[..., 0] if dx else 1.0 - w[..., 0]
        wy = w[..., 1] if dy else 1.0 - w[..., 1]
        wz = w[..., 2] if dz else 1.0 - w[..., 2]
        wgts.append(wx * wy * wz)
    return torch.stack(idxs, dim=-1), torch.stack(wgts, dim=-1)


def hash_encode(x: torch.Tensor, table: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """x (N, 3) in [0,1]³, table (L, T, F) → features (N, L·F). Plain
    gather + weighted sum; its autograd backward is a scatter-add."""
    L, F = cfg.n_levels, cfg.n_features_per_level
    N = x.shape[0]
    idx8, w8 = corner_indices_and_weights(x, cfg)                # (L, N, 8)
    f8 = torch.gather(table, 1,
                      idx8.reshape(L, N * 8, 1).expand(L, N * 8, F))
    f8 = f8.reshape(L, N, 8, F).to(x.dtype)
    out = torch.einsum("lnc,lncf->lnf", w8, f8)
    return out.permute(1, 0, 2).reshape(N, cfg.out_dim)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions (N, 3) → real SH basis values (N, degree²)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    result = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        result += [-0.48860251190291987 * y,
                   0.48860251190291987 * z,
                   -0.48860251190291987 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result += [1.0925484305920792 * xy,
                   -1.0925484305920792 * yz,
                   0.94617469575755997 * zz - 0.31539156525251999,
                   -1.0925484305920792 * xz,
                   0.54627421529603959 * (xx - yy)]
    if degree > 3:
        result += [0.59004358992664352 * y * (-3.0 * xx + yy),
                   2.8906114426405538 * xy * z,
                   0.45704579946446572 * y * (1.0 - 5.0 * zz),
                   0.3731763325901154 * z * (5.0 * zz - 3.0),
                   0.45704579946446572 * x * (1.0 - 5.0 * zz),
                   1.4453057213202769 * z * (xx - yy),
                   0.59004358992664352 * x * (-xx + 3.0 * yy)]
    return torch.stack(result, dim=-1)
