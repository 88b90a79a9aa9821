"""Iso-surface extraction (marching tetrahedra): the NeRF→mesh bridge's
extractor (`tpunerf_torch.train_latent_nerf_mesh`, `LatentNeRFScene.
extract_mesh`).

Marching tetrahedra instead of marching cubes: a 6-tetrahedron split of each
cube and a 16-case table instead of the 256-case cube tables. The surface is
extracted on the host, from the density grid the card evaluates.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# Six tetrahedra per cube (indices into the 8 cube corners).
_CUBE_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32)

# Corner offsets (z fastest), corner id bit order (x, y, z).
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# For each of the 16 tet sign cases: triangles as edge pairs (a, b) of tet
# vertex ids; −1 padded. Edges interpolate between tet verts a and b.
_TET_TRIS = {
    0x0: [], 0xF: [],
    0x1: [[(0, 1), (0, 2), (0, 3)]],
    0xE: [[(0, 1), (0, 3), (0, 2)]],
    0x2: [[(1, 0), (1, 3), (1, 2)]],
    0xD: [[(1, 0), (1, 2), (1, 3)]],
    0x4: [[(2, 0), (2, 1), (2, 3)]],
    0xB: [[(2, 0), (2, 3), (2, 1)]],
    0x8: [[(3, 0), (3, 2), (3, 1)]],
    0x7: [[(3, 0), (3, 1), (3, 2)]],
    0x3: [[(0, 2), (1, 3), (1, 2)], [(0, 2), (0, 3), (1, 3)]],
    0xC: [[(0, 2), (1, 2), (1, 3)], [(0, 2), (1, 3), (0, 3)]],
    0x5: [[(0, 1), (2, 1), (2, 3)], [(0, 1), (2, 3), (0, 3)]],
    0xA: [[(0, 1), (2, 3), (2, 1)], [(0, 1), (0, 3), (2, 3)]],
    0x6: [[(1, 0), (2, 3), (2, 0)], [(1, 0), (1, 3), (2, 3)]],
    0x9: [[(1, 0), (2, 0), (2, 3)], [(1, 0), (2, 3), (1, 3)]],
}


def marching_tetrahedra(values: np.ndarray, iso: float,
                        bound: float = 1.0, use_native: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """values (G, G, G) scalar field → (vertices (V, 3) in
    [−bound, bound]³, faces (F, 3)). Surface oriented toward lower values.

    `use_native` runs the C++/OpenMP extractor of `tpunerf_torch.native`
    (exact edge-identity welding, watertight, triangles in cell order; it
    raises where it cannot be built); `use_native=False` runs this numpy
    version, the plain one, which welds by rounded position."""
    if use_native:
        from tpunerf_torch import native
        return native.marching_tets(np.asarray(values, np.float32), iso,
                                    bound)
    G = values.shape[0]
    spacing = 2.0 * bound / (G - 1)
    origin = -bound

    # cube corner values for all cells, vectorized
    v = values
    corner_vals = np.stack([
        v[c[0]:G - 1 + c[0], c[1]:G - 1 + c[1], c[2]:G - 1 + c[2]]
        for c in _CORNERS], axis=-1)                       # (g, g, g, 8)
    base = np.stack(np.meshgrid(np.arange(G - 1), np.arange(G - 1),
                                np.arange(G - 1), indexing="ij"),
                    axis=-1)                               # (g, g, g, 3)

    cells = corner_vals.reshape(-1, 8)
    bases = base.reshape(-1, 3)
    # only cells crossing the isolevel
    crossing = (cells.min(axis=1) <= iso) & (cells.max(axis=1) >= iso)
    cells = cells[crossing]
    bases = bases[crossing]

    verts_out = []
    for tet in _CUBE_TETS:
        tv = cells[:, tet]                                 # (M, 4)
        tpos = (bases[:, None, :] + _CORNERS[tet][None]) * spacing + origin
        case = ((tv[:, 0] > iso).astype(int) |
                ((tv[:, 1] > iso).astype(int) << 1) |
                ((tv[:, 2] > iso).astype(int) << 2) |
                ((tv[:, 3] > iso).astype(int) << 3))
        for code, tris in _TET_TRIS.items():
            if not tris:
                continue
            m = case == code
            if not m.any():
                continue
            for tri in tris:
                pts = []
                for (a, b) in tri:
                    va, vb = tv[m, a], tv[m, b]
                    t = (iso - va) / np.where(np.abs(vb - va) > 1e-12,
                                              vb - va, 1e-12)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pts.append(tpos[m, a] * (1 - t) + tpos[m, b] * t)
                verts_out.append(np.stack(pts, axis=1))    # (m, 3, 3)

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(verts_out, axis=0)               # (T, 3, 3)
    flat = tris.reshape(-1, 3)
    # weld duplicate vertices
    key = np.round(flat / (spacing * 1e-4)).astype(np.int64)
    _, first_idx, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    verts = flat[first_idx].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & \
         (faces[:, 0] != faces[:, 2])
    return verts, faces[ok]
