"""Residual displacement MLP: 5 layers, 128 wide, GroupNorm, predicting a
per-vertex displacement from the vertex position — the neural alternative
to the free per-vertex `displacement` parameter of `TexturedMeshScene`."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpunerf_torch.utils import init_like_flax_


class DisplacementMLP(nn.Module):
    def __init__(self, width: int = 128, depth: int = 5, out_dim: int = 3,
                 norm_groups: int = 8, scale: float = 1e-2,
                 generator: Optional[torch.Generator] = None):
        """Initialised as flax does (lecun-normal kernels drawn from
        `generator`, zero biases), the output layer all zero."""
        super().__init__()
        self.scale = scale           # keeps the first displacements tiny
        self.in_proj = nn.Linear(3, width)
        # the statistics are per vertex and group (the input is (V, width));
        # eps 1e-6 is the JAX package's (flax's default), not torch's 1e-5
        self.norms = nn.ModuleList(
            nn.GroupNorm(norm_groups, width, eps=1e-6) for _ in range(depth))
        self.denses = nn.ModuleList(
            nn.Linear(width, width) for _ in range(depth))
        self.out_proj = nn.Linear(width, out_dim)
        init_like_flax_(self, generator)
        nn.init.zeros_(self.out_proj.weight)

    def forward(self, verts: torch.Tensor) -> torch.Tensor:
        """(V, 3) → (V, 3) displacement."""
        h = self.in_proj(verts)
        for norm, dense in zip(self.norms, self.denses):
            h = dense(torch.relu(norm(h))) + h
        return self.out_proj(h) * self.scale
