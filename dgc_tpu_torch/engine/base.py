"""Result types shared by the port's coloring engines (the port's copy of
``dgc_tpu.engine.base``).

An *engine* answers one question (the reference's ``graph_coloring``
contract, reference ``coloring.py:73``): can this graph be colored with
``k`` colors — and if so, with what color vector? One call = one
k-attempt; the minimal-k outer loop drives it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
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
    # the per-superstep trajectory (obs.kernel.SuperstepTrajectory), set
    # only when the engine ran with record_trajectory on
    trajectory: object | None = None

    @property
    def success(self) -> bool:
        return self.status == AttemptStatus.SUCCESS

    @property
    def colors_used(self) -> int:
        colored = self.colors[self.colors >= 0]
        return int(colored.max()) + 1 if len(colored) else 0


@dataclass
class BlockAttemptResult(AttemptResult):
    """One attempt of an attempt block
    (``CompactFrontierEngine.attempt_block``): the block returns a scalar
    record for every chained attempt but only the final and best color
    rows, so ``colors`` may be None until the driver fills it in at a
    block boundary (``engine.minimal_k``). ``used`` is the count the card
    took (max color + 1), so ``colors_used`` is exact without the row."""

    used: int = 0

    @property
    def colors_used(self) -> int:
        if self.colors is None:
            return int(self.used)
        return AttemptResult.colors_used.fget(self)


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


@dataclass
class SuperstepTrace:
    """Per-superstep uncolored counts (the reference prints them per
    superstep, ``coloring.py:89``); the host engines record into it."""

    uncolored: list[int] = field(default_factory=list)

    def record(self, uncolored: int) -> None:
        self.uncolored.append(uncolored)


@dataclass
class BlockOutcome:
    """One attempt block (port of ``dgc_tpu.engine.fused.BlockOutcome``).

    ``results``: the chained attempts in order (``BlockAttemptResult``;
    ``colors`` is set on the final attempt and on a STALLED budget's
    re-run, intermediate successes stay scalar-only).
    ``k_next``: the next budget; after a failure the *failed* budget (the
    checkpoint convention).
    ``done``: the stopping rule fired inside (or at the edge of) the block.
    ``carry``: the card-resident carry for the next block, or None to start
    fresh; consumed by the next ``attempt_block`` call, never reused.
    ``best_colors``: the best row, copied home only at a boundary sync
    (checkpointing, the sweep's end, the STALLED fallback); else None.
    """

    results: list
    k_next: int
    done: bool
    carry: tuple | None
    best_colors: object | None = None


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
