"""The port's PNG reader and image loader (`utils.read_png`,
`utils.load_image`, which the card's machine runs without Pillow) against
PIL: `read_png` on `write_png`'s output and on PNGs written by PIL (L, LA,
RGB, RGBA) and by a row encoder of this file that applies each of the five
filters, exactly; `load_image`'s resize against PIL's default
`Image.resize` (bicubic), enlarging and shrinking, within one uint8 level
(it is exact), and exact where the file is already at the size; and the
refusals of what the reader does not read."""
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tpunerf_torch.utils import (load_image, read_png, resize_pil_bicubic,
                                 write_png)

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(h, w, ch, seed):
    """Smooth rows with noise, so that every filter has work to do."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(rng.integers(0, 9, size=(h, w, ch)), axis=1) + \
        rng.integers(0, 255, size=(h, 1, ch))
    return (img % 256).astype(np.uint8)


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(img, filters):
    """A PNG of `img` (H, W, ch) whose row y uses filter filters[y % 5]."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        kind = filters[y % len(filters)]
        pred = [np.zeros_like(x), left, up, (left + up) // 2,
                _paeth(left, up, ul)][kind]
        out.append(bytes([kind]) + ((x - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_reads_what_pil_writes(tmp_path, mode):
    img = _image(37, 53, MODES[mode], seed=len(mode))
    path = tmp_path / f"{mode}.png"
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("mode", ["LA", "RGB", "RGBA"])
def test_read_png_undoes_each_filter(tmp_path, kind, mode):
    """Every row of filter `kind`, then all five in turn (a row's filter
    reads the row above, whatever that one used)."""
    img = _image(21, 19, MODES[mode], seed=kind)
    for filters in ([kind], [kind, 4, 3, 2, 1, 0]):
        path = tmp_path / f"{mode}_{kind}_{len(filters)}.png"
        path.write_bytes(_encode(img, filters))
        np.testing.assert_array_equal(read_png(path), _pil_rgb(path))


def test_read_png_reads_write_png(tmp_path):
    for ch in (1, 3, 4):
        img = _image(16, 24, ch, seed=ch)
        write_png(tmp_path / "w.png", img)
        want = np.repeat(img, 3, axis=2) if ch == 1 else img[..., :3]
        np.testing.assert_array_equal(read_png(tmp_path / "w.png"), want)


@pytest.mark.parametrize("src,size", [(80, 64), (512, 224), (100, 128),
                                      (37, 512), (64, 64)])
def test_load_image_resizes_as_pil(tmp_path, src, size):
    img = np.random.default_rng(src).integers(
        0, 256, size=(src, src + 7 * (src != size), 3)).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(path, img)
    got = load_image(path, size, device="cpu")
    assert got.shape == (1, size, size, 3) and got.dtype == torch.float32
    want = np.asarray(Image.open(path).convert("RGB").resize((size, size)),
                      np.float32) / 255.0
    levels = np.abs(got[0].numpy() - want).max() * 255
    assert levels <= 1.0 + 1e-3, levels
    np.testing.assert_array_equal(got[0].numpy(), want)
    if src == size:
        np.testing.assert_array_equal(got[0].numpy(), img / np.float32(255))


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_resize_of_other_aspects_matches_pil(mode):
    """Each axis its own scale: shrink one, enlarge the other."""
    img = _image(30, 40, MODES[mode], seed=9)
    out = resize_pil_bicubic(img, 12, 50)
    assert out.dtype == np.uint8 and out.shape == (12, 50, MODES[mode])
    pil = Image.fromarray(img[..., 0] if mode == "L" else img, mode)
    want = np.asarray(pil.resize((50, 12))).reshape(out.shape)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("what", ["palette", "16-bit", "interlaced",
                                  "not a png"])
def test_what_read_png_does_not_read_is_refused_by_name(tmp_path, what):
    path = tmp_path / "x.png"
    img = _image(8, 8, 3, seed=1)
    if what == "palette":
        Image.fromarray(img).convert("P").save(path)
        word = "palette"
    elif what == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 257,
                        "I;16").save(path)
        word = "bit depth 16"
    elif what == "interlaced":
        data = bytearray(_encode(img, [0]))
        data[28] = 1           # IHDR's interlace byte
        body = bytes(data[12:29])
        data[29:33] = struct.pack(">I", zlib.crc32(body))
        path.write_bytes(bytes(data))
        word = "interlaced"
    else:
        path.write_bytes(b"GIF89a" + bytes(32))
        word = "not a PNG"
    with pytest.raises(ValueError, match=word):
        read_png(path)
