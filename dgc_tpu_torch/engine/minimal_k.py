"""Host-side minimal-k outer loop (port of ``dgc_tpu.engine.minimal_k``).

The reference decrements k from ``max_degree + 1`` until an attempt fails
and reports the last successful k (reference ``coloring.py:215-235``). This
loop keeps that contract, keeps the last *valid* coloring, validates every
success from ground truth, and by default jumps: a success that used ``u``
colors proves every ``k ≥ u`` succeeds identically, so the next attempt is
at ``u − 1``. ``strict_decrement=True`` restores the one-by-one schedule.

Engines with a fused ``sweep()`` (``engine.compact``) run the jump-mode
pair through it when not strict; results equal two ``attempt`` calls, and
a confirm attempt below ``k_min`` is dropped, as the per-attempt loop never
makes it. ``attempts_per_dispatch > 1`` sends engines with an
``attempt_block`` (``ell-compact``) through the blocked driver: up to that
many budgets chain on the card per block, with the same attempt sequence
and coloring. ``checkpoint`` (``utils.checkpoint``) saves the sweep after
every attempt (every block when blocked) and resumes it.
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
    checkpoint=None,
    post_reduce: Callable | None = None,
    attempts_per_dispatch: int = 1,
    on_block: Callable[[int, int], None] | None = None,
) -> MinimalColoringResult:
    """Run k-attempts until failure; return minimal count + last valid
    coloring. ``validate(colors)`` runs after each success; ``checkpoint``
    (a ``utils.checkpoint.CheckpointManager``) is restored first and saved
    after each attempt, so a resumed sweep skips what is done;
    ``post_reduce(colors) -> colors`` (``ops.reduce_colors``) is applied to
    the final coloring and may only preserve validity and lower the count.
    ``attempts_per_dispatch > 1`` takes the blocked driver
    (``_find_minimal_blocked``) on engines with ``attempt_block``;
    ``on_block(k, attempts)`` fires before each block."""
    if (int(attempts_per_dispatch) > 1
            and hasattr(engine, "attempt_block")):
        return _find_minimal_blocked(
            engine, initial_k, strict_decrement=strict_decrement,
            k_min=k_min, validate=validate, on_attempt=on_attempt,
            checkpoint=checkpoint, post_reduce=post_reduce,
            attempts=int(attempts_per_dispatch), on_block=on_block)
    t0 = time.perf_counter()
    result = MinimalColoringResult(minimal_colors=None, colors=None)
    k, best, done = _restore(checkpoint, initial_k, result)
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
                next_k = (res.colors_used - 1) if not strict_decrement \
                    else (res.k - 1)
            else:
                next_k = None
            if on_attempt is not None:
                on_attempt(res, val)
            if checkpoint is not None:
                checkpoint.save(k=(next_k if next_k is not None else k),
                                best=best, failed=not res.success)
            if not res.success:
                done = True
                break
            k = next_k

    return _finalize_result(result, best, validate, post_reduce, t0)


def _restore(checkpoint, initial_k: int, result: MinimalColoringResult):
    """``(k, best, done)`` to start from: the checkpoint's, its best attempt
    appended to ``result``, or a fresh sweep's."""
    restored = None if checkpoint is None else checkpoint.restore()
    if restored is None:
        return initial_k, None, False
    k, best, done = restored
    if best is not None:
        result.attempts.append(best)
    return k, best, done


def _find_minimal_blocked(
    engine,
    initial_k: int,
    *,
    strict_decrement: bool,
    k_min: int,
    validate: Callable | None,
    on_attempt,
    checkpoint,
    post_reduce: Callable | None,
    attempts: int,
    on_block,
) -> MinimalColoringResult:
    """Blocked minimal-k driver: the budgets chain inside
    ``engine.attempt_block`` calls, with host work only at block
    boundaries. Against the sequential loop:

    - the attempt sequence (budgets, statuses, supersteps, colors_used),
      the final coloring and ``minimal_colors`` are equal — the card runs
      the drivers' budget rules, and the stop below the floor drops the
      attempts the floor drops;
    - intermediate successes come back scalar-only
      (``base.BlockAttemptResult``, ``colors=None``); the best row comes
      home at boundary syncs, so ``validate`` runs once per row brought
      home instead of once per success — the same ``AssertionError``;
    - ``checkpoint.save`` fires once per block with the final attempt's
      (next_k, failed): a crash mid-block re-runs one block, a kill at a
      block boundary resumes exactly;
    - ``on_attempt`` still fires once per attempt, in order.
    """
    t0 = time.perf_counter()
    result = MinimalColoringResult(minimal_colors=None, colors=None)
    k, best, done = _restore(checkpoint, initial_k, result)

    carry = None
    while not done and k >= k_min:
        if on_block is not None:
            on_block(int(k), int(attempts))
        out = engine.attempt_block(
            k, attempts, strict_decrement=strict_decrement, carry=carry,
            k_min=k_min, want_best=checkpoint is not None)
        carry = out.carry
        last = None
        for res in out.results:
            result.attempts.append(res)
            last = res
            val = None
            if res.success:
                best = res
                if res.colors is not None and validate is not None:
                    val = validate(res.colors)
                    if not val.valid:
                        raise AssertionError(
                            f"engine produced invalid coloring at k={res.k}: {val}"
                        )
            if on_attempt is not None:
                on_attempt(res, val)
        if (best is not None and best.colors is None
                and out.best_colors is not None):
            # boundary sync: the card's best row lands in the tracked best
            best.colors = out.best_colors
            if validate is not None:
                bval = validate(best.colors)
                if not bval.valid:
                    raise AssertionError(
                        f"engine produced invalid coloring at k={best.k}: {bval}"
                    )
        if checkpoint is not None:
            checkpoint.save(k=out.k_next, best=best,
                            failed=last is not None and not last.success)
        if last is not None and not last.success:
            done = True
        k = out.k_next

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
