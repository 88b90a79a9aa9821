"""Work of the hard rasterizer's face selection with its interpolation and
of the soft silhouette, on a render's face rows: the rows (the faces'
camera z (B, F, 3), image xy (B, F, 3, 2) and features (B, F, 3, C)) read
once, the pixels' features (B, P, C), face ids (B, P) and silhouette
(B, P) written once, float32 and int32. The arithmetic needed is counted
on the inputs: each (pixel, face) pair whose pixel lies inside the face
takes an inside test and a depth (25 operations) and, for the silhouette,
its distance terms (80)."""
from __future__ import annotations

import torch

SELECT_OPS = 25
SOFT_OPS = 80


def nbytes(B: int, F: int, C: int, P: int) -> float:
    return 4.0 * (B * F * 3 * (1 + 2 + C) + B * P * (C + 2))


def inside_pairs(fv_img: torch.Tensor, H: int, W: int) -> int:
    """(pixel, face) pairs of a (B, F, 3, 2) batch whose pixel centre lies
    inside the face (either winding), pixels row-major with +y up."""
    dev = fv_img.device
    ys = 1.0 - (torch.arange(H, device=dev) + 0.5) / H * 2
    xs = (torch.arange(W, device=dev) + 0.5) / W * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px, py = gx.reshape(1, -1, 1), gy.reshape(1, -1, 1)
    total = 0
    for b in range(fv_img.shape[0]):
        v = fv_img[b]
        sides = []
        for i in range(3):
            a, c = v[:, i], v[:, (i + 1) % 3]
            sides.append((c[:, 0] - a[:, 0]) * (py - a[:, 1])
                         - (c[:, 1] - a[:, 1]) * (px - a[:, 0]))
        pos = (sides[0] >= 0) & (sides[1] >= 0) & (sides[2] >= 0)
        neg = (sides[0] <= 0) & (sides[1] <= 0) & (sides[2] <= 0)
        total += int((pos | neg).sum())
    return total


def flops(pairs: int) -> float:
    return float(pairs * (SELECT_OPS + SOFT_OPS))
