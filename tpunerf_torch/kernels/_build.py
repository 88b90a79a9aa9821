"""Build and load the CUDA kernels of `tpunerf_torch/csrc/`.

Each `csrc/<name>.cu` (with the shared headers `csrc/*.cuh`) has a plain
C interface and is compiled by its own
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` call into
`build/tpunerf_torch/<name>-<hash>.so` (git-ignored), at first use; all
sources are compiled in parallel. The library is loaded with `ctypes`.
Nothing here runs at import time, so the package imports on machines
without `nvcc` or a card.

Every kernel wrapper counts its launches in `LAUNCHES`, so that a run can
show which kernels its path went through. A launch enqueued while a CUDA
graph is captured runs nothing then: it goes to `CAPTURED`, and whoever
replays the graph counts it at each replay (`count_launch(name, times)`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpunerf_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {}
CAPTURED: Dict[str, int] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str, times: int = 1) -> None:
    capturing = (torch.cuda.is_available()
                 and torch.cuda.is_current_stream_capturing())
    counts = CAPTURED if capturing else LAUNCHES
    counts[name] = counts.get(name, 0) + times


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of tpunerf_torch "
                           "are built on the machine with the card")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path(src: Path) -> Path:
    """The library of `src`, named by a hash of the source, the shared
    headers (`csrc/*.cuh`) and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: compiler log} for the sources it compiled; raises with
    the compiler's output when one fails."""
    todo = [(s, _library_path(s)) for s in sources()
            if not _library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _library_path(CSRC / f"{name}.cu")
        if not path.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the current CUDA device: the
    kernels launch there and take raw pointers."""
    dev = tensors[0].device
    if (dev.type != "cuda" or any(t.device != dev for t in tensors)
            or dev.index != torch.cuda.current_device()):
        raise ValueError("kernel inputs must all lie on the current CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError_t "
                           f"{err}")


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float
