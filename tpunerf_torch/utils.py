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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
        PNG_SIGNATURE + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))


# colour type → channels: grey, RGB, grey+alpha, RGBA (3, a palette, is
# refused)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_unfilter(raw: bytes, height: int, stride: int, bpp: int
                  ) -> np.ndarray:
    """Undo the five PNG row filters: none, sub, up, average, Paeth."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:       # sub: a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:       # up
            cur = (line + prev) & 255
        elif kind in (3, 4):  # average, Paeth: each byte reads the last
            cur_l = line.tolist()
            up = prev.tolist()
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur_l[x] = (cur_l[x] + pred) & 255
            cur = np.asarray(cur_l, np.int32)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not one "
                             "of the five (0-4)")
        out[y] = cur
        prev = cur
    return out


def read_png(path: Union[str, Path]) -> np.ndarray:
    """A PNG → (H, W, 3) uint8 RGB, with the standard library only. Reads
    8-bit greyscale, grey+alpha, RGB and RGBA, non-interlaced, with any of
    the five row filters; alpha is dropped and grey repeated, as PIL's
    `convert("RGB")` does. Any other PNG (a palette, another bit depth,
    Adam7 interlacing) is refused by name."""
    data = Path(path).read_bytes()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (read_png reads PNG only)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} (palette) is not "
                         "read: read_png reads grey, grey+alpha, RGB, RGBA")
    if depth != 8:
        raise ValueError(f"{path}: PNG bit depth {depth} is not read: "
                         "read_png reads 8-bit channels")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not read")
    ch = _PNG_CHANNELS[color]
    img = _png_unfilter(zlib.decompress(b"".join(idat)), height, width * ch,
                        ch).reshape(height, width, ch)
    if ch <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


# PIL's fixed-point resampling of 8-bit images (libImaging/Resample.c)
_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter, a = −0.5, support 2."""
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(n_in: int, n_out: int):
    """PIL's `precompute_coeffs` + `normalize_coeffs_8bpc` for one axis:
    each output's first tap and (n_out, taps) int64 fixed-point weights
    (0 past the taps it uses)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = _pil_bicubic((np.arange(xmax) + xmin - center + 0.5)
                         * (1.0 / filterscale))
        total = w.sum()
        kk[xx, :xmax] = w / total if total != 0.0 else w
        first[xx] = xmin
    one = float(1 << _PIL_PRECISION_BITS)
    fixed = np.where(kk < 0, -0.5 + kk * one, 0.5 + kk * one)
    return first, np.trunc(fixed).astype(np.int64)


def _pil_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One of PIL's two passes along `axis`, rounded back to uint8."""
    n_in = img.shape[axis]
    first, kk = _pil_coeffs(n_in, n_out)
    taps = np.minimum(first[:, None] + np.arange(kk.shape[1]), n_in - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # (n_in, …)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int64)
    for k in range(kk.shape[1]):
        w = kk[:, k].reshape((n_out,) + (1,) * (src.ndim - 1))
        acc += src[taps[:, k]] * w
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_pil_bicubic(img: np.ndarray, height: int, width: int
                       ) -> np.ndarray:
    """(H, W, C) uint8 → (height, width, C) uint8 as PIL's default
    `Image.resize((width, height))` gives it for an RGB or greyscale image
    (PIL premultiplies alpha, this does not): bicubic (a = −0.5), the filter
    widened by the scale when shrinking, weights in 22-bit fixed point, a
    horizontal pass and then a vertical one, each rounded to uint8."""
    out = img
    if out.shape[1] != width:
        out = _pil_pass(out, width, 1)
    if out.shape[0] != height:
        out = _pil_pass(out, height, 0)
    return out


def load_image(path: Union[str, Path], size: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.Tensor:
    """A PNG → (1, size, size, 3) f32 in [0, 1] on `device` (CUDA unless
    the caller names another): read as RGB, resized as PIL's default
    resize where it is not size², divided by 255."""
    img = read_png(path)
    if img.shape[:2] != (size, size):
        img = resize_pil_bicubic(img, size, size)
    out = torch.from_numpy(img.astype(np.float32) / 255.0)[None]
    return out.to(resolve_device(device))


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
