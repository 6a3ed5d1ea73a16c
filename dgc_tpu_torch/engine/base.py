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
from typing import Callable

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


def finish_sweep_pair(
    first: AttemptResult,
    used: int,
    status2,
    finish_second: Callable[[int], AttemptResult],
    num_vertices: int,
    attempt: Callable[[int], AttemptResult],
) -> tuple[AttemptResult, AttemptResult | None]:
    """Host epilogue of a fused ``sweep()`` (port of
    ``dgc_tpu.engine.fused.finish_sweep_pair``): no confirm after a
    non-success first attempt; ``k2 < 1`` is the empty-budget FAILURE; a
    STALLED confirm falls back to ``attempt(k2)``, which owns the
    widen-and-retry loop; otherwise ``finish_second(k2)`` materializes the
    confirm attempt's result."""
    if first.status != AttemptStatus.SUCCESS:
        return first, None
    k2 = int(used) - 1
    if k2 < 1:
        return first, empty_budget_failure(num_vertices, k2)
    if AttemptStatus(int(status2)) == AttemptStatus.STALLED:
        return first, attempt(k2)
    return first, finish_second(k2)
