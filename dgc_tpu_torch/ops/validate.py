"""Ground-truth coloring validation (the port's copy of
``dgc_tpu.ops.validate``; host NumPy).

The reference validates from cached neighbor copies
(reference ``coloring.py:149-162``), which in the optimized engine are
stale at validation time, so its conflict check passes vacuously
(SURVEY.md §2.4.3). Here validation is computed from the CSR arrays and the
color vector — the actual state — so it can't be fooled:

- ``uncolored``: count of −1 entries (reference ``coloring.py:151``).
- ``conflicts``: directed count of edges whose endpoints share a color.
  The reference counts each conflict twice (both edge directions,
  ``coloring.py:157-160``); CSR holds both directions, so this count matches
  the reference's doubled number. ``conflict_edges`` halves it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ValidationResult:
    uncolored: int
    conflicts: int  # directed (reference-parity, doubled) count

    @property
    def conflict_edges(self) -> int:
        return self.conflicts // 2

    @property
    def valid(self) -> bool:
        return self.uncolored == 0 and self.conflicts == 0

    def __bool__(self) -> bool:
        return self.valid


def validate_coloring(indptr, indices, colors) -> ValidationResult:
    """Vectorized host-side validation on CSR + color vector."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    colors = np.asarray(colors)
    v = len(indptr) - 1
    uncolored = int((colors < 0).sum())
    degrees = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(v, dtype=np.int64), degrees)
    row_colors = colors[rows]
    nbr_colors = colors[indices]
    conflicts = int(((row_colors == nbr_colors) & (row_colors >= 0)).sum())
    return ValidationResult(uncolored=uncolored, conflicts=conflicts)


def num_colors_used(colors) -> int:
    colors = np.asarray(colors)
    colored = colors[colors >= 0]
    return int(colored.max()) + 1 if len(colored) else 0
