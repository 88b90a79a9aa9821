"""Uniform mesh Laplacian as precomputed COO edges and a scatter-add matvec.

    L v = (Σ_{j∈N(i)} v_j) / deg(i) − v_i     (uniform weights)

The edge list is built once on the host with numpy; the matvec is a gather
and an `index_add_`, which on the card adds in an order that varies from
run to run (the results agree to f32 rounding). Used for the Laplacian
regulariser ‖L(v + d) − L(v₀)‖² of the per-vertex displacement.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class UniformLaplacian:
    src: torch.Tensor         # (E,) int64 — edge source (row of L)
    dst: torch.Tensor         # (E,) int64 — edge destination (neighbour)
    inv_degree: torch.Tensor  # (V,) float32
    num_vertices: int

    @classmethod
    def from_faces(cls, faces: np.ndarray, num_vertices: int,
                   device: torch.device) -> "UniformLaplacian":
        faces = np.asarray(faces)
        pairs = np.concatenate([faces[:, [0, 1]], faces[:, [1, 0]],
                                faces[:, [1, 2]], faces[:, [2, 1]],
                                faces[:, [2, 0]], faces[:, [0, 2]]], axis=0)
        pairs = np.unique(pairs, axis=0)         # shared edges once
        deg = np.bincount(pairs[:, 0], minlength=num_vertices).astype(
            np.float32)
        inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
        return cls(
            src=torch.from_numpy(pairs[:, 0].astype(np.int64)).to(device),
            dst=torch.from_numpy(pairs[:, 1].astype(np.int64)).to(device),
            inv_degree=torch.from_numpy(inv_deg.astype(np.float32)).to(device),
            num_vertices=num_vertices)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """(V, C) → (V, C): neighbour mean minus self."""
        nbr_sum = torch.zeros((self.num_vertices, v.shape[1]), dtype=v.dtype,
                              device=v.device).index_add(0, self.src,
                                                         v[self.dst])
        return nbr_sum * self.inv_degree[:, None] - v

    def loss(self, verts: torch.Tensor, verts0_lap: torch.Tensor
             ) -> torch.Tensor:
        """Mean squared deviation of the Laplacian coordinates from the
        cached initial ones."""
        return torch.mean(torch.sum((self.matvec(verts) - verts0_lap) ** 2,
                                    dim=-1))
