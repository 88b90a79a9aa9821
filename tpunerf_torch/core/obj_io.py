"""Host-side OBJ / OFF mesh IO in pure numpy (the port's own copy of the
JAX package's `core/obj_io.py`; mesh IO is host preprocessing).

Parses: v / vt / f (with v, v/vt, v//vn, v/vt/vn forms, negative indices,
polygon fan-triangulation). Writes OBJ + MTL + albedo texture.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from tpunerf_torch.utils import write_png


@dataclasses.dataclass
class MeshData:
    vertices: np.ndarray            # (V, 3) float32
    faces: np.ndarray               # (F, 3) int32
    uvs: Optional[np.ndarray]       # (T, 2) float32 or None
    face_uvs_idx: Optional[np.ndarray]  # (F, 3) int32 or None


def _resolve_index(idx: int, count: int) -> int:
    return idx - 1 if idx > 0 else count + idx


def load_obj(path: Union[str, Path]) -> MeshData:
    vertices, uvs, faces, face_uvs = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _resolve_index(int(comps[0]), len(vertices))
                    ti = None
                    if len(comps) > 1 and comps[1]:
                        ti = _resolve_index(int(comps[1]), len(uvs))
                    corners.append((vi, ti))
                # fan-triangulate polygons
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    faces.append([c[0] for c in tri])
                    face_uvs.append([c[1] if c[1] is not None else -1 for c in tri])

    v = np.asarray(vertices, np.float32)
    fcs = np.asarray(faces, np.int32)
    vt = np.asarray(uvs, np.float32) if uvs else None
    ft = np.asarray(face_uvs, np.int32) if face_uvs else None
    if ft is not None and (vt is None or ft.max() < 0):
        ft = None
    return MeshData(vertices=v, faces=fcs, uvs=vt, face_uvs_idx=ft)


def load_off(path: Union[str, Path]) -> MeshData:
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    if tokens[i].upper().startswith("OFF"):
        i += 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    verts = np.array(tokens[i:i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        poly = [int(x) for x in tokens[i + 1:i + 1 + k]]
        i += 1 + k
        for j in range(1, k - 1):
            faces.append([poly[0], poly[j], poly[j + 1]])
    return MeshData(vertices=verts, faces=np.asarray(faces, np.int32),
                    uvs=None, face_uvs_idx=None)


def load_mesh(path: Union[str, Path]) -> MeshData:
    path = Path(path)
    if path.suffix.lower() == ".obj":
        return load_obj(path)
    if path.suffix.lower() == ".off":
        return load_off(path)
    raise ValueError(f"{path}: extension not implemented in mesh reader.")


def save_obj_with_mtl(out_dir: Union[str, Path], vertices: np.ndarray,
                      faces: np.ndarray, uvs: np.ndarray,
                      face_uvs_idx: np.ndarray, albedo: np.ndarray,
                      name: str = "") -> Tuple[Path, Path, Path]:
    """Write `{name}mesh.obj` + `{name}mesh.mtl` + `{name}albedo.png`.

    v/vt lines, faces as `f v/vt ...`, material mat0 with map_Kd albedo.
    `albedo` is (H, W, 3) float in [0, 1] or uint8.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    obj_path = out_dir / f"{name}mesh.obj"
    mtl_path = out_dir / f"{name}mesh.mtl"
    png_path = out_dir / f"{name}albedo.png"

    img = albedo
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    write_png(png_path, img)

    lines = [f"mtllib {name}mesh.mtl"]
    lines += [f"v {v[0]} {v[1]} {v[2]}" for v in vertices]
    lines += [f"vt {t[0]} {t[1]}" for t in uvs]
    lines.append("usemtl mat0")
    for fv, ft in zip(faces, face_uvs_idx):
        lines.append(
            f"f {fv[0] + 1}/{ft[0] + 1} {fv[1] + 1}/{ft[1] + 1} "
            f"{fv[2] + 1}/{ft[2] + 1}")
    obj_path.write_text("\n".join(lines) + "\n")

    mtl_path.write_text(
        "newmtl mat0\n"
        "Ka 1.000000 1.000000 1.000000\n"
        "Kd 1.000000 1.000000 1.000000\n"
        "Ks 0.000000 0.000000 0.000000\n"
        "Tr 1.000000\n"
        "illum 1\n"
        "Ns 0.000000\n"
        f"map_Kd {name}albedo.png\n")
    return obj_path, mtl_path, png_path
