"""ctypes bindings of the host C++ components: the signed-distance grid of a
mesh (`sdf_grid.cpp`, for the sketch shape) and marching tetrahedra
(`marching.cpp`, for the NeRF→mesh bridge).

Both sources are compiled by one `g++ -O3 -fPIC -fopenmp -shared
-std=c++17` call into `build/tpunerf_torch/native-<hash>.so` (git-ignored;
the hash covers the sources and the flags) at first use, never at import;
the library is written under a temporary name and renamed, so processes
that build at once do not read each other's half-written file. A failed
build raises with the compiler's output. Nothing falls back to the numpy
versions of `fields/sketch_shape.py` and `fields/marching.py`: they run only
where a caller asks for them (`use_native=False`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpunerf_torch.kernels._build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
SOURCES = ("sdf_grid.cpp", "marching.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    """The library's path, named by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raise with g++'s output when
    the compile fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host C++ components of "
                           "tpunerf_torch (SDF grid, marching tetrahedra) "
                           "are compiled with it at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(_DIR / name) for name in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.tpunerf_sdf_grid.restype = ctypes.c_int
        lib.tpunerf_sdf_grid.argtypes = [
            _F32P, ctypes.c_int64, _I32P, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float, _F32P]
        lib.tpunerf_marching_tets.restype = ctypes.c_int
        lib.tpunerf_marching_tets.argtypes = [
            _F32P, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(_I32P), ctypes.POINTER(ctypes.c_int64)]
        lib.tpunerf_free.restype = None
        lib.tpunerf_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def sdf_grid(vertices: np.ndarray, faces: np.ndarray, resolution: int,
             bound: float) -> np.ndarray:
    """(G, G, G) float32 signed distances (negative inside) at the cell
    centres ((i + ½)/G·2 − 1)·bound, x-major."""
    lib = load()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    out = np.empty(resolution ** 3, np.float32)
    rc = lib.tpunerf_sdf_grid(v.ctypes.data_as(_F32P), v.shape[0],
                              f.ctypes.data_as(_I32P), f.shape[0],
                              resolution, float(bound),
                              out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"tpunerf_sdf_grid refused {v.shape[0]} vertices, "
                         f"{f.shape[0]} faces at resolution {resolution}")
    return out.reshape(resolution, resolution, resolution)


def marching_tets(values: np.ndarray, iso: float, bound: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a (G, G, G) field → (verts (V, 3) float32, faces
    (F, 3) int32), vertices welded by grid-edge identity, triangles in cell
    order (the same arrays for any number of OpenMP threads)."""
    lib = load()
    v = np.ascontiguousarray(values, np.float32)
    pv, pf = _F32P(), _I32P()
    nv, nf = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.tpunerf_marching_tets(
        v.ctypes.data_as(_F32P), v.shape[0], float(iso), float(bound),
        ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pf),
        ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError(f"tpunerf_marching_tets failed ({rc}) on a "
                           f"{v.shape} grid")
    try:
        verts = (np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(pf, shape=(nf.value, 3)).copy()
                 if nf.value else np.zeros((0, 3), np.int32))
    finally:
        lib.tpunerf_free(ctypes.cast(pv, ctypes.c_void_p))
        lib.tpunerf_free(ctypes.cast(pf, ctypes.c_void_p))
    return verts.astype(np.float32), faces.astype(np.int32)
