"""Procedural mesh assets (unit sphere, env dome, icosphere) + shape
resolution.

The geometry is generated procedurally so the package is self-contained;
external OBJ assets load through meshrep.mesh.Mesh the same way.

`load_shape` resolves a shape path as: procedural name → path as given →
repo `shapes/` → the directories in $TPUNERF_SHAPE_DIRS (the JAX package's
variable and default, so both packages find the same assets).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import numpy as np

import torch

from tpunerf_torch.meshrep.mesh import Mesh

_REPO_ROOT = Path(__file__).resolve().parents[2]
# the JAX package's default asset directory
_DEFAULT_SHAPE_DIRS = os.path.join(os.sep, "root", "reference", "shapes")


def resolve_shape_path(path: Union[str, Path]) -> Path:
    """Resolve a shape path to an existing file: as given → relative to the
    repo root → repo `shapes/<basename>` → each dir in $TPUNERF_SHAPE_DIRS
    (colon-separated). Raises FileNotFoundError listing every location
    searched."""
    path = Path(path)
    candidates = [path, _REPO_ROOT / path, _REPO_ROOT / "shapes" / path.name]
    extra = os.environ.get("TPUNERF_SHAPE_DIRS", _DEFAULT_SHAPE_DIRS)
    for d in filter(None, extra.split(":")):
        candidates.append(Path(d) / path.name)
    for c in candidates:
        if c.is_file():
            return c
    raise FileNotFoundError(
        f"shape '{path}' not found; searched: "
        + ", ".join(str(c) for c in candidates)
        + ". Use a procedural name (sphere, icosphere, env_sphere), place "
        "the OBJ under shapes/, or point TPUNERF_SHAPE_DIRS at an asset "
        "directory.")


def load_shape(shape_path: Optional[Union[str, Path]]) -> Mesh:
    """Shape loader used by every app: procedural names first, then the
    file resolution chain. `None` → unit UV sphere."""
    name = None if shape_path is None else str(shape_path)
    if name in (None, "sphere"):
        return uv_sphere()
    if name == "icosphere":
        return icosphere()
    if name in ("env_sphere", "env_dome"):
        return env_sphere()
    return Mesh.load(resolve_shape_path(shape_path))


def uv_sphere(n_lat: int = 32, n_lon: int = 64, radius: float = 1.0
              ) -> Mesh:
    """Latitude-longitude sphere with seam-correct UVs."""
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.linspace(0, 2 * np.pi, n_lon + 1)
    verts, uvs = [], []
    for i, th in enumerate(lats):
        for j, ph in enumerate(lons):
            verts.append([radius * np.sin(th) * np.sin(ph),
                          radius * np.cos(th),
                          radius * np.sin(th) * np.cos(ph)])
            uvs.append([j / n_lon, 1.0 - i / n_lat])
    verts = np.asarray(verts, np.float32)
    uvs = np.asarray(uvs, np.float32)

    def vid(i, j):
        return i * (n_lon + 1) + j

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append([a, c, b])
            if i < n_lat - 1:
                faces.append([b, c, d])
    faces = np.asarray(faces, np.int32)
    return Mesh(vertices=torch.from_numpy(verts),
                faces=torch.from_numpy(faces), vt=torch.from_numpy(uvs),
                ft=torch.from_numpy(faces.copy()))


def env_sphere(radius: float = 5.0, n_lat: int = 16, n_lon: int = 32) -> Mesh:
    """Background dome, rendered from inside."""
    return uv_sphere(n_lat=n_lat, n_lon=n_lon, radius=radius)


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> Mesh:
    """Icosphere without UVs (exercises the unwrap path)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                verts.append((np.asarray(verts[a]) + np.asarray(verts[b])) / 2)
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, np.int64)

    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return Mesh(vertices=torch.from_numpy(verts.astype(np.float32)),
                faces=torch.from_numpy(faces.astype(np.int32)))
