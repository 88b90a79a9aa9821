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

The result is the JAX package's, bit for bit; the work is organised for
extracted meshes of some 10⁵ faces, whose charts reach 10⁴ faces and whose
folded charts split into 10⁵ single-face pieces: the self-overlap tests
take only the pairs whose boxes share a grid cell (`_shared_cells`), and
the face adjacency, the single-face pieces, the rotations of three-vertex
pieces and the packing's sizes are array operations, each with the
per-item arithmetic of the JAX code.
"""
from __future__ import annotations

import collections
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _triangles_local_2d(tri: np.ndarray) -> np.ndarray:
    """(N, 3, 3) world triangles → (N, 3, 2) 2-D coords, each in its own
    plane; a degenerate triangle gets the unit right triangle. Each norm
    is a dot product as `np.linalg.norm` takes it, and each projection a
    (3, 3) @ (3,) product, here one a triangle by stacked matmuls."""
    def norm(x):
        return np.sqrt(np.matmul(x[:, None, :], x[:, :, None])[:, 0, 0])

    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    nn = norm(n)
    u = e1 / (norm(e1) + 1e-12)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.cross(n / nn[:, None], u)
    p = np.stack([np.zeros(e1.shape), e1, e2], axis=1)   # rel to v0
    local = np.stack([np.matmul(p, u[:, :, None])[..., 0],
                      np.matmul(p, v[:, :, None])[..., 0]], -1)
    flat = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    return np.where((nn < 1e-12)[:, None, None], flat,
                    local.astype(np.float32))


def grid_atlas(vertices: np.ndarray, faces: np.ndarray, margin: float = 0.1
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face grid atlas → (vt (3F, 2), ft (F, 3))."""
    F = faces.shape[0]
    K = int(np.ceil(np.sqrt(F)))
    cell = 1.0 / K
    ft = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    local = _triangles_local_2d(vertices[faces])
    local = local - local.min(axis=1, keepdims=True)
    span = np.maximum(local.max(axis=(1, 2)).astype(np.float64), 1e-12)
    local = local / span.astype(local.dtype)[:, None, None]   # in [0,1]²
    local = margin / 2 + local * (1.0 - margin)                # inset
    cy, cx = np.divmod(np.arange(F), K)
    vt = (np.stack([cx, cy], -1)[:, None, :] + local) * cell
    return vt.reshape(-1, 2).astype(np.float32), ft


def _face_normals_np(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(nn, 1e-12)


def _face_adjacency(faces: np.ndarray) -> List[List[int]]:
    """Per face, the faces that share an edge with it (once per shared
    edge): the pairs within each run of equal edge keys, sorted."""
    F = len(faces)
    f = faces.astype(np.int64)
    e = np.sort(np.stack([f, np.roll(f, -1, axis=1)], -1).reshape(-1, 2),
                axis=1)                                  # (a,b) (b,c) (c,a)
    key = e[:, 0] * (int(f.max(initial=0)) + 1) + e[:, 1]
    order = np.argsort(key, kind="stable")
    key, owner = key[order], order // 3
    src, dst = [], []
    for k in range(1, len(key)):
        same = key[k:] == key[:-k]
        if not same.any():
            break
        src += [owner[:-k][same], owner[k:][same]]
        dst += [owner[k:][same], owner[:-k][same]]
    src = np.concatenate(src) if src else np.zeros(0, np.int64)
    dst = np.concatenate(dst) if dst else np.zeros(0, np.int64)
    order = np.argsort(src, kind="stable")
    bounds = np.cumsum(np.bincount(src, minlength=F))[:-1]
    return [a.tolist() for a in np.split(dst[order], bounds)][:F]


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
            n_avg = None      # the chart's mean normal as f is dequeued
            for g in sorted(adj[f]):
                if visited[g]:
                    continue
                if n_avg is None:
                    n_avg = n_sum / max(np.linalg.norm(n_sum), 1e-12)
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


def _shared_cells(lo_a: np.ndarray, hi_a: np.ndarray, lo_b: np.ndarray,
                  hi_b: np.ndarray, chunk: int = 1 << 20
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Index pairs (a, b) of 2-D boxes [lo, hi] of two sets that share a
    cell of a uniform grid, some more than once, in chunks of about
    `chunk` pairs: among them every pair whose closed boxes overlap (the
    cell index, a rounded quotient, is monotone in the coordinate). The
    cell is twice the larger set's median box side, coarsened to at most
    1024 cells an axis. Small sets pair all at once."""
    na, nb = len(lo_a), len(lo_b)
    if na * nb <= 1 << 16:
        yield np.divmod(np.arange(na * nb), nb)
        return
    lo = np.minimum(lo_a.min(axis=0), lo_b.min(axis=0))
    span = float((np.maximum(hi_a.max(axis=0), hi_b.max(axis=0)) - lo).max())
    side = max(float(np.median((hi_a - lo_a).max(axis=1))),
               float(np.median((hi_b - lo_b).max(axis=1))))
    cell = max(2.0 * side, span / 1024, 1e-30)

    def covered(b_lo, b_hi):                      # (cell id, box) pairs
        i0 = np.floor((b_lo - lo) / cell).astype(np.int64)
        i1 = np.floor((b_hi - lo) / cell).astype(np.int64)
        nx, ny = i1[:, 0] - i0[:, 0] + 1, i1[:, 1] - i0[:, 1] + 1
        box = np.repeat(np.arange(len(b_lo)), nx * ny)
        k = np.arange(len(box)) - np.repeat(np.cumsum(nx * ny) - nx * ny,
                                            nx * ny)
        cx = i0[box, 0] + k % nx[box]
        cy = i0[box, 1] + k // nx[box]
        return cx * (1 << 31) + cy, box

    ca, a = covered(lo_a, hi_a)
    cb, b = covered(lo_b, hi_b)
    order = np.argsort(cb, kind="stable")
    cb, b = cb[order], b[order]
    start = np.searchsorted(cb, ca, "left")
    count = np.searchsorted(cb, ca, "right") - start
    total = np.cumsum(count)
    s = 0
    while s < len(ca):
        e = max(int(np.searchsorted(total, total[s] - count[s] + chunk,
                                    "right")), s + 1)
        c = count[s:e]
        yield (np.repeat(a[s:e], c),
               b[np.repeat(start[s:e] - np.cumsum(c) + c, c)
                 + np.arange(int(c.sum()))])
        s = e


def _edges_properly_intersect(tris: np.ndarray) -> bool:
    """Any two triangle edges of the chart crossing in their interiors?
    Catches overlaps the point-sample test misses (thin slivers, overlaps
    confined to edge neighborhoods). Strict sign tests exclude shared
    endpoints and collinear shared edges of adjacent faces.

    Only pairs whose boxes share a grid cell are tested (`_shared_cells`,
    chunk by chunk: memory linear in the chart): two edges that cross
    share a point, so their boxes overlap. The test of a pair is the
    all-pairs test's arithmetic, so the answer is its."""
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]],
                       axis=0).astype(np.float64)         # (E, 2, 2)
    a1, a2 = e[:, 0], e[:, 1]
    lo, hi = np.minimum(a1, a2), np.maximum(a1, a2)

    def cr(o, p, q):          # cross(p−o, q−o), broadcast
        return ((p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1])
                - (p[..., 1] - o[..., 1]) * (q[..., 0] - o[..., 0]))

    eps = 1e-12
    for i, j in _shared_cells(lo, hi, lo, hi):
        keep = i < j
        A1, A2 = a1[i[keep]], a2[i[keep]]
        B1, B2 = a1[j[keep]], a2[j[keep]]
        if ((cr(A1, A2, B1) * cr(A1, A2, B2) < -eps)
                & (cr(B1, B2, A1) * cr(B1, B2, A2) < -eps)).any():
            return True
    return False


def _chart_overlaps(local: np.ndarray, ft_local: np.ndarray,
                    samples: int = 2) -> bool:
    """Conservative self-overlap check: interior sample-point containment
    between triangle pairs, plus a proper edge-edge intersection test.
    Points are tested only against the triangles whose boxes share a grid
    cell with them (a point strictly inside lies in the box), with the
    all-pairs test's arithmetic."""
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

    denom_sign = np.sign(cross(v1 - v0, v2 - v0))
    eps = 1e-9
    own = np.repeat(np.arange(Fc), samples)
    e21, e02, e10 = v2 - v1, v0 - v2, v1 - v0
    for k, f in _shared_cells(pts, pts, tris.min(axis=1).astype(np.float64),
                              tris.max(axis=1).astype(np.float64)):
        keep = f != own[k]
        p, f = pts[k[keep]], f[keep]
        sg = denom_sign[f]
        if ((cross(e21[f], p - v1[f]) * sg > eps)
                & (cross(e02[f], p - v2[f]) * sg > eps)
                & (cross(e10[f], p - v0[f]) * sg > eps)).any():
            return True
    return False


def _best_rotations(local: np.ndarray, n_angles: int = 16) -> np.ndarray:
    """Rotate each piece's 2-D coords (N, V, 2) to (approximately) minimize
    its bbox area — recovers packing headroom for elongated charts. The
    first angle of least finite area wins; a piece with none keeps its
    coords."""
    rots = np.stack([np.array([[np.cos(a), np.sin(a)],
                               [-np.sin(a), np.cos(a)]], local.dtype)
                     for a in np.linspace(0.0, np.pi, n_angles,
                                          endpoint=False)])
    rot = np.matmul(local[:, None], rots[None])           # (N, A, V, 2)
    ext = rot.max(axis=2) - rot.min(axis=2)
    area = ext[..., 0] * ext[..., 1]
    area = np.where(np.isnan(area), np.inf, area)
    k = area.argmin(axis=1)
    rows = np.arange(len(local))
    return np.where((area[rows, k] < np.inf)[:, None, None], rot[rows, k],
                    local)


def chart_atlas(vertices: np.ndarray, faces: np.ndarray,
                cos_threshold: float = 0.75, pad_frac: float = 0.005
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Chart-based unwrap (see module docstring) →
    (vt (ΣVc, 2), ft (F, 3)). Charts whose planar projection self-overlaps
    are split back to per-face cells (projection is exact per face)."""
    F = faces.shape[0]
    normals = _face_normals_np(vertices, faces)
    charts = grow_charts(vertices, faces, cos_threshold)

    pieces = []          # (local_uv, ft_local, chart_faces); None: a face
    split = []           # the faces of the split charts, in piece order
    for chart in charts:
        local, _, ft_local = _project_chart(vertices, faces, chart, normals)
        if _chart_overlaps(local, ft_local):
            pieces += [None] * len(chart)         # per-face fallback cells
            split += chart
        else:
            pieces.append((local, ft_local, chart))
    cells = iter(_triangles_local_2d(vertices[faces[np.asarray(
        split, np.int64).reshape(-1)]]))
    one = np.array([[0, 1, 2]], np.int32)
    faces_of = iter(split)
    pieces = [p if p is not None else (next(cells), one, [next(faces_of)])
              for p in pieces]

    # normalize pieces to origin, gather sizes (pieces of three vertices
    # rotated together)
    tri = [i for i, p in enumerate(pieces) if len(p[0]) == 3]
    rotated = [None] * len(pieces)
    if tri:
        for i, r in zip(tri, _best_rotations(
                np.stack([pieces[i][0] for i in tri]))):
            rotated[i] = r
    for i, p in enumerate(pieces):
        if rotated[i] is None:
            rotated[i] = _best_rotations(p[0][None])[0]
    sized = [r - r.min(axis=0) for r in rotated]
    ext = np.stack([r.max(axis=0) for r in sized])       # (P, 2)
    total_area = float(np.add.accumulate(
        (ext[:, 0] * ext[:, 1]).astype(np.float64))[-1]) + 1e-12
    pad = pad_frac * float(np.sqrt(total_area))

    # shelf packing: sort by height desc, first-fit into rows of width W
    order = np.lexsort((np.arange(len(sized)), -ext[:, 0], -ext[:, 1]))
    W = max(float(ext[:, 0].max()) + 2 * pad,
            float(np.sqrt(total_area)) * 1.15)
    ws = (ext[:, 0].astype(np.float64) + 2 * pad).tolist()
    hs = (ext[:, 1].astype(np.float64) + 2 * pad).tolist()
    x = y = row_h = 0.0
    offsets = np.zeros((len(sized), 2))
    for i in order.tolist():
        w, h = ws[i], hs[i]
        if x + w > W and x > 0.0:
            y += row_h
            x = row_h = 0.0
        offsets[i] = (x + pad, y + pad)
        x += w
        row_h = max(row_h, h)
    H = y + row_h
    scale = 1.0 / max(W, H)

    counts = [len(r) for r in sized]
    vt = (np.concatenate(sized) + np.repeat(offsets, counts, axis=0)) * scale
    ft = np.zeros((F, 3), np.int32)
    base = np.cumsum([0] + counts[:-1])
    for (_, ft_local, cfaces), b in zip(pieces, base.tolist()):
        ft[np.asarray(cfaces, np.int64)] = ft_local + b
    return vt.astype(np.float32), ft


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
