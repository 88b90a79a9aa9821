"""Host-side utilities: device and dtype policy, seeding, images, metric
rows."""
from __future__ import annotations

import json
import logging
import math
import os
import random
import struct
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when no card is visible and none was named, so a run
    never falls back to the CPU without being asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(spec: str, device: torch.device) -> torch.dtype:
    """Dtype-policy string → torch dtype: "auto" = bfloat16 on CUDA and
    float32 on the CPU (the JAX package's bf16-on-TPU policy); else an
    explicit name ("float32" / "bfloat16")."""
    if spec == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[spec]
    except KeyError:
        raise ValueError(f"unknown dtype policy {spec!r}") from None


def seed_everything(seed: int) -> None:
    """Seed the host RNGs. Device draws in this package come from explicit
    `torch.Generator`s (or are passed in), not from global state."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill `t` in place with N(0, std²) truncated to ±2 std, drawn as flax
    draws it: a uniform sample pushed through the inverse error function."""
    hi = math.erf(math.sqrt(2.0))
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, device=t.device)
        t.copy_(torch.erfinv(u * (2 * hi) - hi) * (math.sqrt(2.0) * std))
    return t


def lecun_normal_(w: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax's default kernel init: truncated normal, variance 1/fan_in.
    `w` is a torch Linear (out, in) or Conv (out, in, kh, kw) weight."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    return trunc_normal_(w, std, generator)


def init_like_flax_(module: torch.nn.Module,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.nn.Module:
    """Initialise every Linear, Conv2d, norm and Embedding under `module`
    with flax's defaults: lecun-normal kernels, zero biases, unit norm
    scales, N(0, 1/dim) embedding rows."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            lecun_normal_(m.weight, generator)
        elif isinstance(m, torch.nn.Embedding):
            with torch.no_grad():
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
        elif isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
        bias = getattr(m, "bias", None)
        if isinstance(bias, torch.Tensor):
            with torch.no_grad():
                bias.zero_()
    return module


def make_path(path: Path) -> Path:
    path = Path(path)
    path.mkdir(exist_ok=True, parents=True)
    return path


def tensor2numpy(array: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """An image → uint8: rescaled from [−1, 1] to [0, 1] where it has a
    negative value, clipped to [0, 1], times 255, truncated."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    array = np.asarray(array)
    if array.min() < 0:
        array = array * 0.5 + 0.5
    return (np.clip(array, 0.0, 1.0) * 255).astype(np.uint8)


def write_png(path: Union[str, Path], img: np.ndarray) -> None:
    """Write a uint8 image — (H, W) grey, (H, W, 1), (H, W, 3) RGB or
    (H, W, 4) RGBA — as a PNG, with the standard library only."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    try:
        color_type = {1: 0, 3: 2, 4: 6}[img.shape[2]]
    except (KeyError, IndexError):
        raise ValueError(f"write_png: bad image shape {img.shape}") from None
    height, width = img.shape[:2]
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate(
        [np.zeros((height, 1), np.uint8), img.reshape(height, -1)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body)))

    header = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))


def init_logger(exp_dir: Optional[Path] = None,
                name: str = "tpunerf_torch") -> logging.Logger:
    """Console + `<exp_dir>/log.txt` logger, `time | level | message`."""
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:      # a previous run's log.txt
        h.close()
    logger.handlers.clear()
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if exp_dir is not None:
        Path(exp_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(exp_dir) / "log.txt")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Append scalar metrics as JSONL, one row per call."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, step: int, **scalars: Any) -> None:
        rec: Dict[str, Any] = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
