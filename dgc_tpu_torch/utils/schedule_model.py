"""The attempt block's sizing (port of
``dgc_tpu.utils.schedule_model.auto_attempts_per_dispatch``; the rest of
that pricing model is ROADMAP A11).

A prediction from a uniform stopping-bracket model, not a measurement: it
steers ``--attempts-per-dispatch auto``, never a reported number.
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
