"""Work of the multiresolution hash encode of N points and the gradient of
its table, counted from the shapes: the points (N, 3), the table (L, T, F)
and the incoming gradient (N, L·F) read once; the features (N, L·F) and
the table's gradient written once, all float32. The arithmetic: at each
level and point, eight corner weights (three products each) and the
trilinear sum of F features, forward and backward."""
from __future__ import annotations


def nbytes(n: int, levels: int, table: int, features: int) -> float:
    return 4.0 * (3 * n + 2 * levels * table * features
                  + 2 * n * levels * features)


def flops(n: int, levels: int, features: int) -> float:
    return 2.0 * n * levels * 8 * (3 + 2 * features)
