"""Speculative minimal-k: the outer k-loop in parallel sibling lanes.

The reference's driver-side outer loop (decrement ``k`` until an
attempt fails, answer is the last success — PAPER.md §0) is the last
sequential piece of the design: every engine runs one attempt at a
time even though attempts at different budgets are completely
independent. :class:`SpeculativeMinimalKEngine` removes it for the
serve tier: while the driver consumes the attempt at ``k``, the
attempts at ``k-1 … k-D`` already run speculatively in free lanes of
the batch scheduler's :class:`~dgc_tpu_torch.serve.engine._LanePool`, so a
strict-decrement sweep costs ~max(attempt depth) supersteps instead of
Σ(attempt depths) — on TPU the sibling lanes are parallel hardware,
and even on CPU the vectorized while_loop amortizes them.

**Byte-identity argument.** The strict-decrement schedule is perfectly
predictable: ``find_minimal_coloring(strict_decrement=True)`` attempts
``k0, k0-1, k0-2, …`` and stops at the first failure — so the window
``{k-1 … k-D}`` maintained below is always a prefix of the sequential
driver's remaining attempt set. Each attempt is deterministic in
``(member, k)`` (first-fit candidates don't depend on the budget
except through failure), and the driver CLAIMS the speculative result
exactly when the sequential schedule would have run that attempt — so
the attempt sequence, every color vector, and the stopping decision
are the sequential driver's bit for bit. A speculative attempt that
was cancelled or preempted before its claim is simply re-run for real
(:meth:`BatchScheduler.single_attempt`) — same determinism, same
bytes. Jump mode needs none of this (``sweep`` runs the fused
find-u*/confirm pair whose second attempt DEPENDS on the first's
output — nothing to speculate), so :meth:`sweep` just delegates to the
plain :class:`~dgc_tpu_torch.serve.engine.BatchMemberEngine` path.

NOT the rejected cascade-speculation rule family (PERF.md "Measured
dead end — cascade speculation"): the candidate rule is untouched —
only the driver's scheduling of whole attempts changes.
"""

from __future__ import annotations

from dgc_tpu_torch.engine.base import AttemptResult, empty_budget_failure
from dgc_tpu_torch.serve.batched import finish_attempt
from dgc_tpu_torch.serve.engine import BatchMemberEngine

# auto-depth ceiling: the marginal value of the d-th speculative budget
# is the probability the sweep survives d more decrements, which decays
# fast (the measured strict chains spend most wall time in the first
# few budgets below k0 — utils.schedule_model's attempt pricing: the
# per-attempt edge-tail savings shrink with the budget, so deep windows
# mostly burn lanes on attempts that are cheap anyway)
AUTO_DEPTH_CAP = 4


def auto_depth(batch_max: int, live: int = 0,
               cap: int | None = None, k0: int | None = None) -> int:
    """The ``--speculate-k auto`` window depth: the free-lane count the
    scheduler could seat speculation into (``batch_max`` minus the lane
    the driver's own claims occupy and the ``live`` real lanes),
    clamped to ``[1, cap]`` — speculation only helps while free lanes
    are otherwise idle, and the marginal attempt's priced savings decay
    with depth (see module constant).

    The cap defaults to the *priced* survival cap when the sweep's
    starting budget ``k0`` is known
    (``utils.schedule_model.speculation_auto_cap`` — the depth where the
    modeled survival of the d-th decrement stops clearing the value
    floor), and to the fixed ``AUTO_DEPTH_CAP`` otherwise (the
    pre-pricing behavior, byte-identical for legacy callers)."""
    if cap is None:
        if k0 is not None:
            from dgc_tpu_torch.utils.schedule_model import speculation_auto_cap

            cap = speculation_auto_cap(int(k0))
        else:
            cap = AUTO_DEPTH_CAP
    free = int(batch_max) - 1 - max(0, int(live))
    return max(1, min(int(cap), free if free > 0 else 1))


class ServeSequentialMinimalKEngine(BatchMemberEngine):
    """The speculation A/B's sequential arm: a strict-decrement sweep
    that runs every attempt THROUGH the batch scheduler, one blocking
    :meth:`BatchScheduler.single_attempt` round-trip per budget — the
    serve-tier outer loop exactly as the speculative engine runs it,
    minus the speculative window. This is the apples-to-apples baseline
    for the speculation plane (same pool, same compiled slice kernels,
    identical per-attempt bytes). The plain :class:`BatchMemberEngine`
    deliberately is NOT that baseline: its strict attempts delegate to
    the local CompactFrontierEngine, whose frontier compaction the
    dense hand-batched kernel doesn't have — on CPU that local engine
    stays the faster standalone choice, which PERF.md's measured A/B
    reports alongside the scheduling win."""

    def attempt(self, k: int) -> AttemptResult:
        if k < 1:
            return empty_budget_failure(self.member.num_vertices, k)
        out = self.scheduler.single_attempt(self.member, k,
                                            priority=self.priority)
        res = finish_attempt(self.member, out[0], out[1], out[2], k)
        if res.status.name == "STALLED":
            # same stalled-confirm contract as the speculative path: a
            # genuine stall falls back to the single-graph engine
            return self._fallback_engine().attempt(k)
        return res


class SpeculativeMinimalKEngine(BatchMemberEngine):
    """Per-request engine proxy with a speculative strict-decrement
    attempt path: ``attempt(k)`` keeps a window of ``depth`` budgets
    below ``k`` seated speculatively, claims the speculative result
    when the sequential schedule reaches that budget, and falls back to
    a real attempt on a claim miss. Drive it with the unmodified
    :func:`~dgc_tpu_torch.engine.minimal_k.find_minimal_coloring` —
    ``strict_decrement=True`` exercises the speculative path;
    jump mode (the default) delegates to the fused pair, where
    speculation is inert by construction.

    Call :meth:`close` (try/finally) when the sweep ends — it cancels
    whatever the window still holds so the lanes free immediately."""

    def __init__(self, member, scheduler, depth: int = 2,
                 priority: int = 0):
        super().__init__(member, scheduler, priority=priority)
        if depth < 1:
            raise ValueError(f"speculation depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._window: dict = {}   # k -> speculative _SweepCall handle
        # local accounting the CLI/serve summaries read after the sweep
        self.spec_stats = {"claims": 0, "claim_ready": 0, "misses": 0,
                           "speculated": 0}

    def _cancel_below(self, k_cap: int, reason: str) -> None:
        for kk in [kk for kk in self._window if kk < k_cap]:
            self.scheduler.cancel_speculative(self._window.pop(kk), reason)

    def close(self) -> None:
        """Cancel every outstanding speculative attempt (the sweep is
        over — the sequential schedule will never reach them)."""
        self._cancel_below(max(self._window, default=0) + 1, "sweep done")

    def attempt(self, k: int) -> AttemptResult:
        if k < 1:
            return empty_budget_failure(self.member.num_vertices, k)
        # stale window entries at or above k can only exist if the
        # caller deviated from strict descent — drop them (their claim
        # slot will never come)
        for kk in [kk for kk in self._window if kk >= k]:
            if kk != k:
                self.scheduler.cancel_speculative(self._window.pop(kk),
                                                  "superseded")
        # refill the window BEFORE claiming k, so the budgets below run
        # concurrently with the attempt the driver is about to consume
        # — this overlap is the entire win. One atomic submit for the
        # whole refill: per-k submits trickle into the scheduler one at
        # a time and a zero-window dispatcher slices the first solo
        missing = [kk for kk in range(k - 1,
                                      max(k - 1 - self.depth, 0), -1)
                   if kk not in self._window]
        if missing:
            calls = self.scheduler.speculate_many(self.member, missing,
                                                  priority=self.priority)
            for kk, call in zip(missing, calls):
                if call is not None:
                    self._window[kk] = call
                    self.spec_stats["speculated"] += 1
        out = None
        call = self._window.pop(k, None)
        if call is not None:
            self.spec_stats["claims"] += 1
            if call.done.is_set():
                self.spec_stats["claim_ready"] += 1
            out = self.scheduler.claim_speculative(call)
        if out is None:
            # no speculation for this budget (window edge, sync mode)
            # or the speculative lane was cancelled/preempted: run the
            # attempt for real — identical bytes either way
            if call is not None:
                self.spec_stats["misses"] += 1
            out = self.scheduler.single_attempt(self.member, k,
                                                priority=self.priority)
        res = finish_attempt(self.member, out[0], out[1], out[2], k)
        if res.status.name == "STALLED":
            # the serve tier's stalled-confirm contract: a genuine stall
            # falls back to the single-graph engine (BatchMemberEngine
            # .attempt) — and caps the window (the sweep is over either
            # way once the fallback resolves this budget)
            self._cancel_below(k, "stalled fallback")
            return self._fallback_engine().attempt(k)
        if not res.success:
            # the sequential stopping rule: the first failure ends the
            # sweep, so everything still speculating below k is dead
            self._cancel_below(k, "sweep failed")
        return res
