"""Occupancy grid: EMA density cache for empty-space skipping.

A dense (G³,) density cache updated by EMA, thresholded into a bit-packed
field (rebuilt only at refresh), and a fixed-shape compaction: each ray's S
stratified candidates are stably partitioned so occupied samples come
first, and only the first K < S slots are evaluated by the field MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from tpunerf_torch.kernels import occgrid as occ_kernel


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    resolution: int = 128
    bound: float = 1.0
    ema_decay: float = 0.95
    density_threshold: float = 0.01


def init_occupancy(cfg: OccupancyGridConfig,
                   device: torch.device) -> torch.Tensor:
    """Dense density cache (G³,), optimistic init (everything occupied)."""
    return torch.full((cfg.resolution ** 3,), 1.0, dtype=torch.float32,
                      device=device)


def cell_centers(cfg: OccupancyGridConfig,
                 device: torch.device) -> torch.Tensor:
    """(G³, 3) world coordinates of cell centers, z-minor."""
    G = cfg.resolution
    ax = (torch.arange(G, dtype=torch.float32, device=device) + 0.5) / G \
        * 2.0 - 1.0
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                       dim=-1) * cfg.bound


def lookup(grid: torch.Tensor, x: torch.Tensor,
           cfg: OccupancyGridConfig) -> torch.Tensor:
    """Density cache value at world positions x (..., 3)."""
    return grid[occ_kernel.cell_index(x, cfg.resolution, cfg.bound)]


def packed_bitfield(grid: torch.Tensor,
                    cfg: OccupancyGridConfig) -> torch.Tensor:
    """Thresholded grid → (G³/32,) int32 words, z-minor bit order."""
    return occ_kernel.pack_bits(grid > cfg.density_threshold)


def occupied(grid: torch.Tensor, x: torch.Tensor, cfg: OccupancyGridConfig,
             packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool (...,): the cell of each x (..., 3) is above the threshold.
    `packed` (a cached `packed_bitfield`) skips the re-pack."""
    if packed is None:
        packed = packed_bitfield(grid, cfg)
    return occ_kernel.occupancy_lookup(x, packed, cfg.resolution, cfg.bound)


def update(grid: torch.Tensor,
           density_fn: Callable[[torch.Tensor], torch.Tensor],
           cfg: OccupancyGridConfig,
           u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """EMA refresh: evaluate the field at jittered cell centers,
    grid ← max(decay·grid, σ). `u` (G³, 3) holds the U[0, 1) jitter draws;
    drawn from `generator` when not given."""
    centers = cell_centers(cfg, grid.device)
    if u is None:
        u = torch.rand(centers.shape, generator=generator,
                       device=grid.device)
    jitter = (u.to(centers) - 0.5) * (2.0 * cfg.bound / cfg.resolution)
    pts = torch.clamp(centers + jitter, -cfg.bound, cfg.bound)
    with torch.no_grad():
        sigma = density_fn(pts)
    return torch.maximum(grid * cfg.ema_decay, sigma.float())


def mean_density(grid: torch.Tensor) -> torch.Tensor:
    return torch.mean(grid)


def _slots(occ_mask: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (..., S) int64, valid (..., K) bool): each occupied sample's
    exclusive prefix count is its slot; unoccupied samples and those past
    slot K−1 get the spare slot K."""
    occ_i = occ_mask.to(torch.int64)
    rank = torch.cumsum(occ_i, dim=-1) - occ_i
    n_occ = occ_i.sum(dim=-1, keepdim=True)
    valid = torch.arange(k, device=occ_mask.device) < n_occ
    slot = torch.where(occ_mask & (rank < k), rank, torch.full_like(rank, k))
    return slot, valid


def compact_samples(occ_mask: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape stream compaction: occ_mask (..., S) bool →
    (gather_idx (..., K) int32, valid (..., K) bool), the indices of the
    first K occupied samples of each ray in depth order; invalid slots hold
    index 0. A scatter of each sample's index to its slot (`_slots`)."""
    S = occ_mask.shape[-1]
    slot, valid = _slots(occ_mask, k)
    src = torch.arange(S, dtype=torch.int32, device=occ_mask.device)
    buf = torch.zeros((*occ_mask.shape[:-1], k + 1), dtype=torch.int32,
                      device=occ_mask.device)
    gather_idx = buf.scatter_(-1, slot, src.expand(occ_mask.shape))[..., :k]
    return gather_idx, valid


def compact_gather(occ_mask: torch.Tensor, k: int, *arrays: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Compact + gather: returns (valid (..., K) bool, *compacted arrays).

    Each array is (..., S) or (..., S, C) and comes back as (..., K[, C]):
    slot j holds the j-th occupied sample in depth order, and invalid slots
    hold 0. A scatter puts each occupied sample in its slot (`_slots`; the
    spare slot is dropped)."""
    S = occ_mask.shape[-1]
    slot, valid = _slots(occ_mask, k)
    outs = []
    for a in arrays:
        if a.ndim == occ_mask.ndim and a.shape[-1] == S:
            buf = a.new_zeros((*a.shape[:-1], k + 1))
            outs.append(buf.scatter_(-1, slot, a)[..., :k])
        else:
            if a.shape[-2] != S:
                raise ValueError(f"array {tuple(a.shape)} has no sample "
                                 f"axis of {S}")
            C = a.shape[-1]
            buf = a.new_zeros((*a.shape[:-2], k + 1, C))
            idx = slot[..., None].expand(*slot.shape, C)
            outs.append(buf.scatter_(-2, idx, a)[..., :k, :])
    return (valid, *outs)
