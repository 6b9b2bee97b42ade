"""Exact dynamic time warping.

A copy of seq2seq_vc_tpu/evaluate/dtw.py (host numpy there too), so
that the PyTorch port needs nothing of the JAX package.

Replaces the reference's ``fastdtw`` (approximate, not a dependency) with
the exact O(T1*T2) DP. The within-row "left" dependency is solved in closed
form as a min-plus prefix scan (``row[j+1] = C[j] + min_{k<=j}(m[k] -
C[k-1])`` with C = cumsum of the row distances), so each row is one
vectorized ``np.minimum.accumulate`` — no per-cell Python loop. Exact
alignment is strictly tighter than fastdtw's approximation.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dtw_path(x: np.ndarray, y: np.ndarray) -> Tuple[float, List[Tuple[int, int]]]:
    """Euclidean-distance DTW between (T1, D) and (T2, D).

    Returns (total distance, alignment path [(i, j), ...]).
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    t1, t2 = len(x), len(y)
    dist = np.sqrt(
        np.maximum(
            (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2.0 * x @ y.T, 0.0
        )
    )

    cost = np.full((t1 + 1, t2 + 1), np.inf)
    cost[0, 0] = 0.0
    for i in range(1, t1 + 1):
        d = dist[i - 1]
        diag = cost[i - 1, :-1]
        up = cost[i - 1, 1:]
        m = np.minimum(diag, up)  # best predecessor from the previous row
        c = np.cumsum(d)
        shifted = np.concatenate(([0.0], c[:-1]))
        a = m - shifted
        cost[i, 1:] = c + np.minimum.accumulate(a)

    # backtrack over the stored cost matrix
    path = []
    i, j = t1 - 1, t2 - 1
    while True:
        path.append((i, j))
        if i == 0 and j == 0:
            break
        candidates = (
            (cost[i, j], i - 1, j - 1),  # diag
            (cost[i, j + 1], i - 1, j),  # up
            (cost[i + 1, j], i, j - 1),  # left
        )
        _, i, j = min(
            (c for c in candidates if c[1] >= 0 and c[2] >= 0),
            key=lambda c: c[0],
        )
    path.reverse()
    return float(cost[t1, t2]), path
