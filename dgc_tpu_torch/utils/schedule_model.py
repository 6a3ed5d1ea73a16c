"""The attempt block's sizing and the speculative window's depth (port of
``dgc_tpu.utils.schedule_model``'s ``auto_attempts_per_dispatch``,
``strict_survival_curve`` and ``speculation_auto_cap``; the rest of that
pricing model is ROADMAP A5).

Predictions from a uniform stopping-bracket model, not measurements: they
steer ``--attempts-per-dispatch auto`` and ``--speculate-k auto``, never a
reported number.
"""

from __future__ import annotations

import math


def auto_attempts_per_dispatch(k0: int, *, overhead_s: float,
                               k_floor: int = 2, compile_s: float = 0.0,
                               cap: int = 8) -> int:
    """Price ``--attempts-per-dispatch auto``: chaining A attempts per block
    turns the sweep's ~E block boundaries into ~E/A, saving
    ``(E − E/A) · overhead_s`` of host work per boundary against
    ``compile_s`` paid once (0 here: the block's kernels are built with the
    rest). E is the expected attempt count under a uniform stopping
    bracket over ``[k_floor, k0]``: E ≈ (span + 1) / 2.

    Returns the smallest A capturing ≥ 90% of the saturating saving,
    clamped to ``cap`` and to the expected sweep length (a block longer
    than the sweep never fills), or 1 when no A prices positive. The
    saving is priced in units of ``overhead_s``, so with ``compile_s = 0``
    every positive ``overhead_s`` gives the same A, ties included (the JAX
    original multiplies by its constant first, and its rounding breaks the
    one exact tie, k0 = 12, towards 5)."""
    span = max(1, int(k0) - int(k_floor) + 1)
    e = (span + 1) / 2.0

    def saved(a: int) -> float:
        return (e - e / a) - (float(compile_s) / float(overhead_s)
                              if a > 1 else 0.0)

    hi = max(1, min(int(cap), max(2, int(math.ceil(e)))))
    best = max(saved(a) for a in range(1, hi + 1))
    if best <= 0:
        return 1
    for a in range(1, hi + 1):
        if saved(a) >= 0.9 * best:
            return a
    return hi


def strict_survival_curve(k0: int, k_floor: int = 2,
                          cap: int = 16) -> tuple:
    """Modeled survival of the strict-decrement sweep: entry ``d`` (for
    d = 1..cap) is the probability the sweep, currently at budget ``k0``,
    still *executes* the attempt at ``k0 − d``. Before any attempt runs,
    the stopping budget is only bracketed — it lies in [k_floor, k0]
    (first-fit at k0 = Δ+1 always succeeds; nothing nontrivial colors
    below 2) — so the curve prices it uniform over the bracket:
    ``S(d) = max(0, span − d) / span`` with span = k0 − k_floor + 1.
    Coarse by construction (a prediction, not a measurement), but it is
    exactly the shape the speculative window and the attempt-block sizing
    need: linear decay to zero at the bracket edge, instead of a fixed
    depth pretending every budget survives equally."""
    span = max(1, int(k0) - int(k_floor) + 1)
    return tuple(max(0.0, (span - d) / span) for d in range(1, int(cap) + 1))


def speculation_auto_cap(k0: int, *, k_floor: int = 2,
                         value_floor: float = 0.35,
                         hard_cap: int = 8) -> int:
    """Priced ``--speculate-k auto`` depth: the deepest speculative budget
    whose modeled survival (:func:`strict_survival_curve`) clears
    ``value_floor`` — a speculative lane costs a full attempt's compute,
    so seating one that survives with lower probability wastes more slice
    time than the dispatch it hides. Clamped to ``hard_cap`` (the old
    fixed ``serve.speculate.AUTO_DEPTH_CAP`` bound — lane memory) and
    floored at 1 (the sequential lane always runs). Deterministic in
    ``k0``, hence unit-testable."""
    depth = 0
    for d, s in enumerate(strict_survival_curve(k0, k_floor, cap=hard_cap),
                          start=1):
        if s >= value_floor:
            depth = d
    return max(1, min(int(hard_cap), depth))
