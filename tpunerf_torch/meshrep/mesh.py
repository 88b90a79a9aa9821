"""Mesh asset: load, normalize, standardize.

The mesh is loaded on the host with numpy and converted once to tensors on
the device it will be rendered on.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import torch

from tpunerf_torch.core import obj_io


@dataclasses.dataclass
class Mesh:
    vertices: torch.Tensor                 # (V, 3) float32
    faces: torch.Tensor                    # (F, 3) int32
    vt: Optional[torch.Tensor] = None      # (T, 2) float32 UVs
    ft: Optional[torch.Tensor] = None      # (F, 3) int32 face-UV indices

    @classmethod
    def load(cls, path: Union[str, Path]) -> "Mesh":
        data = obj_io.load_mesh(path)
        return cls(
            vertices=torch.from_numpy(data.vertices),
            faces=torch.from_numpy(data.faces),
            vt=None if data.uvs is None else torch.from_numpy(data.uvs),
            ft=(None if data.face_uvs_idx is None
                else torch.from_numpy(data.face_uvs_idx)))

    def to(self, device: torch.device) -> "Mesh":
        return Mesh(*(None if t is None else t.to(device)
                      for t in (self.vertices, self.faces, self.vt, self.ft)))

    def normalize(self, target_scale: float = 1.0, dy: float = 0.0) -> "Mesh":
        """Center at the vertex mean, scale so max |v| = target_scale, lift
        +Y by `dy`."""
        verts = self.vertices - self.vertices.mean(dim=0)
        scale = torch.linalg.norm(verts, dim=1).max()
        verts = verts / scale * target_scale
        verts[:, 1] += dy
        return dataclasses.replace(self, vertices=verts)

    def standardize(self) -> "Mesh":
        """Center and scale by the (population) std of the vertex norms."""
        verts = self.vertices - self.vertices.mean(dim=0)
        scale = torch.std(torch.linalg.norm(verts, dim=1), unbiased=False)
        return dataclasses.replace(self, vertices=verts / scale)

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])
