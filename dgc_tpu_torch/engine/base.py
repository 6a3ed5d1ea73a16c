"""Result types shared by the port's coloring engines (the port's copy of
``dgc_tpu.engine.base``).

An *engine* answers one question (the reference's ``graph_coloring``
contract, reference ``coloring.py:73``): can this graph be colored with
``k`` colors — and if so, with what color vector? One call = one
k-attempt; the minimal-k outer loop drives it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class AttemptStatus(enum.IntEnum):
    """Superstep-loop exit status (held in the device control block)."""

    RUNNING = 0
    SUCCESS = 1      # every vertex colored (reference: uncolored count == 0)
    FAILURE = 2      # some vertex's forbidden set filled all k colors
                     # (reference sentinel −3, coloring.py:53,104-108)
    STALLED = 3      # safety bound hit — must not happen (the priority rule
                     # guarantees ≥1 vertex colored per superstep)


@dataclass
class AttemptResult:
    status: AttemptStatus
    colors: np.ndarray       # int32[V]; valid coloring iff status == SUCCESS
    supersteps: int          # BSP rounds executed
    k: int                   # the color budget attempted

    @property
    def success(self) -> bool:
        return self.status == AttemptStatus.SUCCESS

    @property
    def colors_used(self) -> int:
        colored = self.colors[self.colors >= 0]
        return int(colored.max()) + 1 if len(colored) else 0


def clamp_budget(k: int, capacity: int) -> int:
    """Clamp an oversized color budget to the engine's static capacity.

    Exactness argument (shared by every fixed-capacity engine): capacity is
    sized ≥ Δ+1, first-fit candidates don't depend on k, and by pigeonhole a
    vertex with ≤ Δ forbidden colors can never fail once k > Δ — so any
    k ≥ capacity behaves identically to k = capacity.
    """
    return min(int(k), capacity)


def empty_budget_failure(num_vertices: int, k: int) -> AttemptResult:
    """The k < 1 attempt: nothing can be colored — immediate FAILURE with an
    all-uncolored vector, without launching anything. Engines whose reset
    pass pre-confirms isolated vertices to color 0 must take this path, or
    an all-isolated graph would claim SUCCESS against an empty budget."""
    return AttemptResult(
        AttemptStatus.FAILURE, np.full(num_vertices, -1, np.int32), 0, int(k)
    )
