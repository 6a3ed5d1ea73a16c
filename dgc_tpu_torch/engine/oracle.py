"""Sequential greedy oracle (NumPy, host-side) — the port's copy of
``dgc_tpu.engine.oracle``.

The few-dozen-line ground-truth engine every other engine is tested against
(SURVEY.md §7.2 step 3). Sequential first-fit in (degree desc, id asc) order —
the optimized reference's conflict-priority order
(``coloring_optimized.py:170-172``) applied globally. Guaranteed to use at
most ``max_degree + 1`` colors, so ``attempt(k)`` fails exactly when the
greedy order needs more than ``k``.
"""

from __future__ import annotations

import numpy as np

from dgc_tpu_torch.engine.base import AttemptResult, AttemptStatus
from dgc_tpu_torch.models.arrays import GraphArrays


def greedy_color(arrays: GraphArrays, order: np.ndarray | None = None) -> np.ndarray:
    """First-fit greedy coloring in the given vertex order (default:
    degree desc, id asc). Returns int32[V] colors, all >= 0."""
    v = arrays.num_vertices
    indptr, indices = arrays.indptr, arrays.indices
    degrees = arrays.degrees
    if order is None:
        order = np.lexsort((np.arange(v), -degrees))
    colors = np.full(v, -1, dtype=np.int32)
    for u in order:
        nbr = indices[indptr[u]: indptr[u + 1]]
        used = set(int(c) for c in colors[nbr] if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[u] = c
    return colors


class OracleEngine:
    def __init__(self, arrays: GraphArrays):
        self.arrays = arrays
        self._colors = None  # greedy coloring is k-independent; compute once

    def attempt(self, k: int) -> AttemptResult:
        if self._colors is None:
            self._colors = greedy_color(self.arrays)
        used = int(self._colors.max()) + 1 if len(self._colors) else 0
        if used <= k:
            return AttemptResult(AttemptStatus.SUCCESS, self._colors.copy(), supersteps=1, k=k)
        failed = np.where(self._colors < k, self._colors, -1).astype(np.int32)
        return AttemptResult(AttemptStatus.FAILURE, failed, supersteps=1, k=k)
