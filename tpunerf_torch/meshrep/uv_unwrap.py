"""Host-side UV atlas generation for meshes without UVs (numpy; the port's
own copy of the JAX package's `meshrep/uv_unwrap.py`).

A chart-based unwrap in the xatlas mold:

1. charts grow by BFS over face adjacency, admitting a neighbor while its
   normal stays within `cos_threshold` of the chart's running average
   normal, which bounds the planar-projection distortion;
2. each chart is parameterized by orthogonal projection onto its average
   normal's plane;
3. chart rectangles are shelf-packed (sorted by height, first-fit rows)
   with a uniform scale, preserving relative texel density across charts.

A per-triangle grid atlas (`grid_atlas`) is the fallback for charts whose
projection self-overlaps. The atlas is cached on disk (vt.npy / ft.npy
under the experiment dir) so re-runs skip the unwrap.
"""
from __future__ import annotations

import collections
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def _triangle_local_2d(tri: np.ndarray) -> np.ndarray:
    """(3, 3) world triangle → (3, 2) 2-D coords in its own plane."""
    e1 = tri[1] - tri[0]
    e2 = tri[2] - tri[0]
    n = np.cross(e1, e2)
    nn = np.linalg.norm(n)
    if nn < 1e-12:
        return np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    u = e1 / (np.linalg.norm(e1) + 1e-12)
    w = n / nn
    v = np.cross(w, u)
    p = np.stack([np.zeros(3), e1, e2])  # rel to v0
    return np.stack([p @ u, p @ v], axis=-1).astype(np.float32)


def grid_atlas(vertices: np.ndarray, faces: np.ndarray, margin: float = 0.1
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face grid atlas → (vt (3F, 2), ft (F, 3))."""
    F = faces.shape[0]
    K = int(np.ceil(np.sqrt(F)))
    cell = 1.0 / K
    vt = np.zeros((3 * F, 2), np.float32)
    ft = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    for f in range(F):
        tri = vertices[faces[f]]
        local = _triangle_local_2d(tri)
        lo = local.min(axis=0)
        span = max(float((local - lo).max()), 1e-12)
        local = (local - lo) / span                     # in [0,1]²
        local = margin / 2 + local * (1.0 - margin)     # inset
        cy, cx = divmod(f, K)
        vt[3 * f:3 * f + 3] = (np.array([cx, cy]) + local) * cell
    return vt, ft


def _face_normals_np(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(nn, 1e-12)


def _face_adjacency(faces: np.ndarray) -> List[List[int]]:
    edge_map: dict = collections.defaultdict(list)
    for f, (a, b, c) in enumerate(faces):
        for e in ((a, b), (b, c), (c, a)):
            edge_map[(min(e), max(e))].append(f)
    adj: List[List[int]] = [[] for _ in range(len(faces))]
    for fs in edge_map.values():
        for i in range(len(fs)):
            for j in range(i + 1, len(fs)):
                adj[fs[i]].append(fs[j])
                adj[fs[j]].append(fs[i])
    return adj


def grow_charts(vertices: np.ndarray, faces: np.ndarray,
                cos_threshold: float = 0.75) -> List[List[int]]:
    """Deterministic BFS chart growth: lowest-unvisited-face seeds; a
    neighbor joins while its normal · (chart average normal) ≥ threshold."""
    normals = _face_normals_np(vertices, faces)
    adj = _face_adjacency(faces)
    F = len(faces)
    visited = np.zeros(F, bool)
    charts: List[List[int]] = []
    for seed in range(F):
        if visited[seed]:
            continue
        visited[seed] = True
        chart = [seed]
        n_sum = normals[seed].copy()
        queue = collections.deque([seed])
        while queue:
            f = queue.popleft()
            n_avg = n_sum / max(np.linalg.norm(n_sum), 1e-12)
            for g in sorted(adj[f]):
                if visited[g]:
                    continue
                if float(normals[g] @ n_avg) >= cos_threshold:
                    visited[g] = True
                    chart.append(g)
                    n_sum += normals[g]
                    queue.append(g)
        charts.append(chart)
    return charts


def _project_chart(vertices: np.ndarray, faces: np.ndarray,
                   chart: List[int], normals: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chart → (local_uv (Vc, 2), vids (Vc,), ft_local (len(chart), 3)).
    Orthogonal projection onto the average-normal plane."""
    n = normals[chart].sum(axis=0)
    n = n / max(np.linalg.norm(n), 1e-12)
    # stable basis ⊥ n
    ref = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 \
        else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, ref)
    u = u / max(np.linalg.norm(u), 1e-12)
    v = np.cross(n, u)
    vids = np.unique(faces[chart].ravel())
    remap = {int(vid): i for i, vid in enumerate(vids)}
    p = vertices[vids]
    local = np.stack([p @ u, p @ v], axis=-1)
    ft_local = np.array([[remap[int(vid)] for vid in faces[f]]
                         for f in chart], np.int32)
    return local.astype(np.float32), vids, ft_local


def _edges_properly_intersect(tris: np.ndarray,
                              row_chunk: int = 512) -> bool:
    """Any two triangle edges of the chart crossing in their interiors?
    Catches overlaps the point-sample test misses (thin slivers, overlaps
    confined to edge neighborhoods). Strict sign tests exclude shared
    endpoints and collinear shared edges of adjacent faces.

    The pairwise test is O(E²) but evaluated in `row_chunk`-row strips so
    peak memory is O(row_chunk·E), not O(E²)."""
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]],
                       axis=0).astype(np.float64)         # (E, 2, 2)
    a1, a2 = e[:, 0], e[:, 1]
    E = len(e)

    def cr(o, p, q):          # cross(p−o, q−o), broadcast
        return ((p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1])
                - (p[..., 1] - o[..., 1]) * (q[..., 0] - o[..., 0]))

    eps = 1e-12
    B1, B2 = a1[None], a2[None]                           # (1, E, 2)
    for s in range(0, E, row_chunk):
        sl = slice(s, min(s + row_chunk, E))
        A1, A2 = a1[sl, None], a2[sl, None]               # (r, 1, 2)
        hit = ((cr(A1, A2, B1) * cr(A1, A2, B2) < -eps)
               & (cr(B1, B2, A1) * cr(B1, B2, A2) < -eps))  # (r, E)
        # only pairs j > i (upper triangle of the full E×E matrix)
        hit &= np.arange(E)[None, :] > np.arange(s, s + hit.shape[0])[:, None]
        if hit.any():
            return True
    return False


def _chart_overlaps(local: np.ndarray, ft_local: np.ndarray,
                    samples: int = 2) -> bool:
    """Conservative self-overlap check: interior sample-point containment
    between triangle pairs, plus a proper edge-edge intersection test."""
    tris = local[ft_local]                                # (Fc, 3, 2)
    Fc = len(tris)
    if Fc <= 1:
        return False
    if _edges_properly_intersect(tris):
        return True
    # interior points (centroid + midpoint-ish blends)
    wts = np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2]])[:samples]
    pts = np.einsum("sw,fwd->fsd", wts, tris).reshape(-1, 2)  # (Fc·s, 2)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]

    def cross(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    denom_sign = np.sign(cross(v1 - v0, v2 - v0))[None]
    eps = 1e-9
    own = np.repeat(np.arange(Fc), samples)
    # chunked over sample points — same bounded-memory strategy as the
    # edge test above
    for s in range(0, len(pts), 1024):
        sl = slice(s, min(s + 1024, len(pts)))
        p = pts[sl, None, :]                              # (r, 1, 2)
        inside = ((cross(v2 - v1, p - v1[None]) * denom_sign > eps)
                  & (cross(v0 - v2, p - v2[None]) * denom_sign > eps)
                  & (cross(v1 - v0, p - v0[None]) * denom_sign > eps))
        inside[np.arange(inside.shape[0]), own[sl]] = False
        if inside.any():
            return True
    return False


def _best_rotation(local: np.ndarray, n_angles: int = 16) -> np.ndarray:
    """Rotate a chart's 2-D coords to (approximately) minimize its bbox
    area — recovers packing headroom for elongated charts."""
    best, best_area = local, np.inf
    for a in np.linspace(0.0, np.pi, n_angles, endpoint=False):
        c, s = np.cos(a), np.sin(a)
        rot = local @ np.array([[c, s], [-s, c]], local.dtype)
        ext = rot.max(axis=0) - rot.min(axis=0)
        area = float(ext[0] * ext[1])
        if area < best_area:
            best, best_area = rot, area
    return best


def chart_atlas(vertices: np.ndarray, faces: np.ndarray,
                cos_threshold: float = 0.75, pad_frac: float = 0.005
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Chart-based unwrap (see module docstring) →
    (vt (ΣVc, 2), ft (F, 3)). Charts whose planar projection self-overlaps
    are split back to per-face cells (projection is exact per face)."""
    F = faces.shape[0]
    normals = _face_normals_np(vertices, faces)
    charts = grow_charts(vertices, faces, cos_threshold)

    pieces = []          # (local_uv, ft_local, chart_faces)
    for chart in charts:
        local, _, ft_local = _project_chart(vertices, faces, chart, normals)
        if _chart_overlaps(local, ft_local):
            for f in chart:                       # per-face fallback cells
                tri_local = _triangle_local_2d(vertices[faces[f]])
                pieces.append((tri_local, np.array([[0, 1, 2]], np.int32),
                               [f]))
        else:
            pieces.append((local, ft_local, chart))

    # normalize pieces to origin, gather sizes
    sized = []
    for local, ft_local, cfaces in pieces:
        local = _best_rotation(local)
        lo = local.min(axis=0)
        ext = local.max(axis=0) - lo
        sized.append((local - lo, ft_local, cfaces, ext))
    total_area = sum(float(e[0] * e[1]) for *_, e in sized) + 1e-12
    pad = pad_frac * float(np.sqrt(total_area))

    # shelf packing: sort by height desc, first-fit into rows of width W
    order = sorted(range(len(sized)),
                   key=lambda i: (-sized[i][3][1], -sized[i][3][0], i))
    W = max(max(float(e[0]) for *_, e in sized) + 2 * pad,
            float(np.sqrt(total_area)) * 1.15)
    x = y = row_h = 0.0
    offsets = [None] * len(sized)
    for i in order:
        ext = sized[i][3]
        w, h = float(ext[0]) + 2 * pad, float(ext[1]) + 2 * pad
        if x + w > W and x > 0.0:
            y += row_h
            x = row_h = 0.0
        offsets[i] = (x + pad, y + pad)
        x += w
        row_h = max(row_h, h)
    H = y + row_h
    scale = 1.0 / max(W, H)

    vt_parts = []
    ft = np.zeros((F, 3), np.int32)
    base = 0
    for i, (local, ft_local, cfaces, _) in enumerate(sized):
        ox, oy = offsets[i]
        vt_parts.append((local + np.array([ox, oy])) * scale)
        ft[np.asarray(cfaces, np.int64)] = ft_local + base
        base += len(local)
    return np.concatenate(vt_parts).astype(np.float32), ft


def atlas_utilization(vt: np.ndarray, ft: np.ndarray) -> float:
    """Fraction of the unit texture square covered by UV triangles."""
    tri = vt[ft]
    area = 0.5 * np.abs(
        (tri[:, 1, 0] - tri[:, 0, 0]) * (tri[:, 2, 1] - tri[:, 0, 1])
        - (tri[:, 2, 0] - tri[:, 0, 0]) * (tri[:, 1, 1] - tri[:, 0, 1]))
    return float(area.sum())


def get_or_build_uvs(vertices: np.ndarray, faces: np.ndarray,
                     cache_dir: Optional[Path] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """UV source priority: disk cache → fresh chart unwrap (cached)."""
    if cache_dir is not None:
        cache_dir = Path(cache_dir)
        vt_p, ft_p = cache_dir / "vt.npy", cache_dir / "ft.npy"
        if vt_p.exists() and ft_p.exists():
            return np.load(vt_p), np.load(ft_p)
    vt, ft = chart_atlas(vertices, faces)
    if cache_dir is not None:
        cache_dir.mkdir(parents=True, exist_ok=True)
        np.save(cache_dir / "vt.npy", vt)
        np.save(cache_dir / "ft.npy", ft)
    return vt, ft
