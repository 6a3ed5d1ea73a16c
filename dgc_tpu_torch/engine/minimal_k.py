"""Host-side minimal-k outer loop (port of ``dgc_tpu.engine.minimal_k``,
its sequential loop).

The reference decrements k from ``max_degree + 1`` until an attempt fails
and reports the last successful k (reference ``coloring.py:215-235``). This
loop keeps that contract, keeps the last *valid* coloring, validates every
success from ground truth, and by default jumps: a success that used ``u``
colors proves every ``k ≥ u`` succeeds identically, so the next attempt is
at ``u − 1``. ``strict_decrement=True`` restores the one-by-one schedule.

Engines with a fused ``sweep()`` (``engine.compact``) run the jump-mode
pair through it when not strict; results equal two ``attempt`` calls, and
a confirm attempt below ``k_min`` is dropped, as the per-attempt loop never
makes it. Checkpointing and the blocked loop (``attempt_block``) belong to
slices still to be ported (ROADMAP).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from dgc_tpu_torch.engine.base import AttemptResult
from dgc_tpu_torch.ops.validate import ValidationResult, validate_coloring


@dataclass
class MinimalColoringResult:
    minimal_colors: int | None        # None if even k0 failed
    colors: np.ndarray | None         # last valid coloring
    attempts: list[AttemptResult] = field(default_factory=list)
    wall_time_s: float = 0.0
    validation: ValidationResult | None = None
    swept_colors: int | None = None   # count before the post_reduce pass
    post_reduce_s: float = 0.0        # wall-clock of the post_reduce pass

    @property
    def total_supersteps(self) -> int:
        return sum(a.supersteps for a in self.attempts)


def find_minimal_coloring(
    engine,
    initial_k: int,
    strict_decrement: bool = False,
    k_min: int = 1,
    validate: Callable | None = None,
    on_attempt: Callable[[AttemptResult, ValidationResult | None], None] | None = None,
    post_reduce: Callable | None = None,
) -> MinimalColoringResult:
    """Run k-attempts until failure; return minimal count + last valid
    coloring. ``validate(colors)`` runs after each success;
    ``post_reduce(colors) -> colors`` (``ops.reduce_colors``) is applied to
    the final coloring and may only preserve validity and lower the count."""
    t0 = time.perf_counter()
    result = MinimalColoringResult(minimal_colors=None, colors=None)
    k = initial_k
    best: AttemptResult | None = None
    done = False
    fused = not strict_decrement and hasattr(engine, "sweep")

    while not done and k >= k_min:
        pair = engine.sweep(k) if fused else (engine.attempt(k),)
        for res in pair:
            if res is None:
                continue
            if fused and res.k < k_min:
                # the pair's confirm below the floor: an attempt the
                # per-attempt loop never makes
                continue
            result.attempts.append(res)
            val = None
            if res.success:
                if validate is not None:
                    val = validate(res.colors)
                    if not val.valid:
                        raise AssertionError(
                            f"engine produced invalid coloring at k={res.k}: {val}"
                        )
                best = res
            if on_attempt is not None:
                on_attempt(res, val)
            if not res.success:
                done = True
                break
            k = (res.colors_used - 1) if not strict_decrement else (res.k - 1)

    return _finalize_result(result, best, validate, post_reduce, t0)


def _finalize_result(result, best, validate, post_reduce, t0):
    """Sweep epilogue: post-reduce + final validation + timing."""
    if best is not None and best.success:
        result.minimal_colors = best.colors_used
        result.swept_colors = best.colors_used
        result.colors = best.colors
        if post_reduce is not None:
            t_reduce = time.perf_counter()
            reduced = post_reduce(best.colors)
            result.post_reduce_s = time.perf_counter() - t_reduce
            reduced_used = int(reduced.max()) + 1
            if reduced_used < result.minimal_colors:
                result.minimal_colors = reduced_used
                result.colors = reduced
        if validate is not None:
            result.validation = validate(result.colors)
            if not result.validation.valid:
                raise AssertionError(
                    f"post-reduce produced invalid coloring: {result.validation}"
                )
    result.wall_time_s = time.perf_counter() - t0
    return result


def make_validator(arrays) -> Callable[[np.ndarray], ValidationResult]:
    return lambda colors: validate_coloring(arrays.indptr, arrays.indices, colors)


def make_reducer(arrays) -> Callable[[np.ndarray], np.ndarray]:
    from dgc_tpu_torch.ops.reduce_colors import reduce_color_count

    return lambda colors: reduce_color_count(arrays.indptr, arrays.indices, colors)
