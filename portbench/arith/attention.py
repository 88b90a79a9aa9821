"""Work of one softmax attention over (B, H, N, D), counted from its shape:
the two products q·kᵀ and p·v at 2·N²·D operations each a head; q, k, v
read once and the output written once."""
from __future__ import annotations

import math
from typing import Sequence


def flops(shape: Sequence[int]) -> float:
    B, H, N, D = shape
    return 4.0 * B * H * N * N * D


def nbytes(shape: Sequence[int], itemsize: int) -> float:
    return 4.0 * math.prod(shape) * itemsize
