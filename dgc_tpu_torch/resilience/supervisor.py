"""Supervised execution of the minimal-k sweep.

The reflexes layered around ``find_minimal_coloring`` (the ROADMAP's
production north star; PR 1's obs subsystem is the eyes, this is the
reflex arc):

- :class:`RetryingEngine` — an engine proxy that dispatches every
  attempt/sweep call through the fault-injection points, bounds it with a
  soft per-attempt watchdog, and retries ``TRANSIENT`` errors with
  seeded-jitter backoff under a per-rung :class:`~.retry.RetryBudget`.
  Retrying re-dispatches the *identical* attempt on a deterministic
  engine, so recovery is bit-identical to a fault-free run.
- :func:`supervise_sweep` — walks a configurable **engine ladder**
  (e.g. sharded → fused ELL → compact → CPU ``reference_sim``): each rung
  runs a full ``find_minimal_coloring`` sweep; a rung that fails past its
  retry budget (or with a ``RESOURCE``/``FATAL`` error) falls to the next
  rung, restarting the sweep there — never mixing engines inside one
  sweep, so the final coloring is always exactly one engine's
  deterministic output. Checkpoints are per-rung (the fingerprint embeds
  the backend), so a killed-and-restarted process resumes the rung it
  died in.
- :class:`SweepAbort` — the structured terminal failure: ladder
  exhausted. Carries exit code ``STRUCTURED_ABORT_RC`` (114) so shell
  drivers can tell "resilience gave up cleanly" (114) from the
  backend-unreachable process watchdog (113, ``utils.watchdog``), an
  injected kill (137), and ordinary bugs (1).

Every fault, retry, fallback, and resume is emitted into the PR 1 obs
event stream (``RunLogger``) and counted in the ``MetricsRegistry``.

Timeout caveat: a genuinely wedged XLA call cannot be interrupted from
Python. The soft watchdog abandons the worker thread (daemon) and retries
or falls back; the abandoned call is flagged so it never runs the engine
after cancellation. If the *process* must die instead, that remains the
rc-113 watchdog's job.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field

from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring
from dgc_tpu_torch.resilience import faults
from dgc_tpu_torch.resilience.faults import SimulatedKill
from dgc_tpu_torch.resilience.retry import (ErrorClass, RetryBudget, RetryPolicy,
                                      classify_error)

STRUCTURED_ABORT_RC = 114  # documented beside watchdog.ABORT_RC (113)

#: the canonical degradation order (ISSUE 2): capacity-hungry first,
#: always-works CPU oracle last
DEFAULT_LADDER = ("sharded", "ell", "ell-compact", "reference-sim")


class AttemptTimeout(RuntimeError):
    """Soft per-attempt watchdog expiry (classified TRANSIENT: blips are
    retried; a wedged engine exhausts the budget and falls down the ladder)."""


class RungFailure(Exception):
    """One ladder rung gave up: retries exhausted or non-retryable error."""

    def __init__(self, backend: str, error_class: ErrorClass,
                 cause: BaseException):
        super().__init__(f"{backend}: {error_class.value}: {cause}")
        self.backend = backend
        self.error_class = error_class
        self.cause = cause


class SweepAbort(Exception):
    """Structured terminal failure — every rung of the ladder failed."""

    def __init__(self, reason: str, *, ladder: list[str] | None = None,
                 last_error: BaseException | None = None):
        super().__init__(reason)
        self.reason = reason
        self.ladder = list(ladder or [])
        self.last_error = last_error
        self.rc = STRUCTURED_ABORT_RC

    def to_record(self) -> dict:
        return {"reason": self.reason, "rc": self.rc, "ladder": self.ladder,
                "error": None if self.last_error is None else str(self.last_error)}


@dataclass
class ResilienceStats:
    """What the supervisor did — published in bench/manifest output."""

    retries: int = 0
    attempt_timeouts: int = 0
    fallbacks: int = 0
    engine_used: str | None = None
    rungs_tried: list = field(default_factory=list)

    @property
    def faults_injected(self) -> int:
        plane = faults.active()
        return len(plane.fired) if plane is not None else 0

    def to_dict(self) -> dict:
        return {"retries": self.retries,
                "attempt_timeouts": self.attempt_timeouts,
                "fallbacks": self.fallbacks,
                "faults_injected": self.faults_injected,
                "engine_used": self.engine_used,
                "rungs_tried": list(self.rungs_tried)}


class RungState:
    """Thread-safe live view of the supervisor's position on the engine
    ladder — the serving path's health/readiness feed (ROADMAP
    "Serving-path hooks"): ``serve.queue.ServeFrontEnd`` exposes this
    through its ``health()`` endpoint, so a pod probe sees "degraded to
    rung 2 (ell-compact), 3 retries burned" instead of a silent slowdown.

    ``degraded`` is True once any fallback happened; ``retry_pressure``
    counts transient retries on the current rung; ``ready`` goes False
    only when the ladder is exhausted (a degraded-but-serving process
    stays ready)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.backend: str | None = None
        self.rung_index: int = 0
        self.retry_pressure: int = 0
        self.degraded: bool = False
        self.exhausted: bool = False

    def on_rung(self, backend: str, index: int) -> None:
        with self._lock:
            self.backend = backend
            self.rung_index = index
            self.retry_pressure = 0
            if index > 0:
                self.degraded = True

    def on_retry(self) -> None:
        with self._lock:
            self.retry_pressure += 1

    def on_exhausted(self) -> None:
        with self._lock:
            self.exhausted = True

    def snapshot(self) -> dict:
        with self._lock:
            return {"backend": self.backend, "rung": self.rung_index,
                    "retry_pressure": self.retry_pressure,
                    "degraded": self.degraded,
                    "ready": not self.exhausted}


class RetryingEngine:
    """Engine proxy: fault points + soft timeout + transient retry.

    Exposes ``sweep`` only when the wrapped engine has one, so
    ``find_minimal_coloring``'s fused-path detection is unchanged."""

    def __init__(self, engine, *, backend: str = "?",
                 policy: RetryPolicy | None = None,
                 budget: RetryBudget | None = None,
                 attempt_timeout_s: float = 0.0,
                 logger=None, registry=None,
                 stats: ResilienceStats | None = None,
                 rung_state: RungState | None = None):
        self._engine = engine
        self._backend = backend
        self._policy = policy or RetryPolicy()
        self._delays = self._policy.delays()
        self._budget = budget if budget is not None else RetryBudget(3)
        self._timeout_s = float(attempt_timeout_s)
        self._logger = logger
        self._registry = registry
        self.stats = stats if stats is not None else ResilienceStats()
        self._rung_state = rung_state
        self._cold = True
        if hasattr(engine, "sweep"):
            self.sweep = self._sweep
        if hasattr(engine, "attempt_block"):
            self.attempt_block = self._attempt_block

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def attempt(self, k: int):
        return self._call("attempt", k, lambda: self._engine.attempt(k))

    def _sweep(self, k0: int):
        return self._call("sweep", k0, lambda: self._engine.sweep(k0))

    def _attempt_block(self, k: int, attempts: int, **kw):
        # a block dispatch chains up to ``attempts`` budgets, so the soft
        # watchdog budget scales with it — the per-attempt deadline the
        # flag promises, applied to the fat dispatch as a whole
        return self._call(
            "attempt_block", k,
            lambda: self._engine.attempt_block(k, attempts, **kw),
            timeout_s=self._timeout_s * max(1, int(attempts)))

    # -- dispatch -------------------------------------------------------

    def _dispatch(self, fn, timeout_s: float | None = None):
        t_s = self._timeout_s if timeout_s is None else timeout_s
        if self._cold:
            faults.fault_point("compile", backend=self._backend)
        if t_s <= 0:
            faults.fault_point("attempt", backend=self._backend)
            res = fn()
            faults.fault_point("transfer", backend=self._backend)
            self._cold = False
            return res

        out: dict = {}
        cancelled = threading.Event()
        done = threading.Event()

        def worker():
            try:
                faults.fault_point("attempt", backend=self._backend)
                if cancelled.is_set():
                    return  # timed out during the injected hang: stand down
                out["res"] = fn()
                faults.fault_point("transfer", backend=self._backend)
            except BaseException as e:  # rethrown in the caller
                out["exc"] = e
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        if not done.wait(t_s):
            cancelled.set()
            raise AttemptTimeout(
                f"attempt on {self._backend} exceeded {t_s:g}s")
        if "exc" in out:
            raise out["exc"]
        self._cold = False
        return out.get("res")

    def _call(self, kind: str, k: int, fn, timeout_s: float | None = None):
        while True:
            try:
                return self._dispatch(fn, timeout_s=timeout_s)
            except SimulatedKill:
                raise
            except Exception as e:
                if isinstance(e, AttemptTimeout):
                    ecls = ErrorClass.TRANSIENT
                    self.stats.attempt_timeouts += 1
                    if self._registry is not None:
                        self._registry.counter(
                            "dgc_attempt_timeouts_total",
                            "soft per-attempt watchdog expiries").inc()
                else:
                    ecls = classify_error(e)
                if ecls is not ErrorClass.TRANSIENT or not self._budget.take():
                    raise RungFailure(self._backend, ecls, e) from e
                delay = next(self._delays)
                self.stats.retries += 1
                if self._rung_state is not None:
                    self._rung_state.on_retry()
                if self._registry is not None:
                    self._registry.counter(
                        "dgc_retries_total", "transient-error retries",
                        error_class=ecls.value).inc()
                if self._logger is not None:
                    self._logger.event(
                        "retry", backend=self._backend, k=int(k),
                        error_class=ecls.value, error=str(e),
                        delay_s=round(delay, 4), budget_left=self._budget.left)
                time.sleep(delay)


def supervise_sweep(
    ladder,
    initial_k: int,
    *,
    strict_decrement: bool = False,
    k_min: int = 1,
    validate=None,
    on_attempt=None,
    make_checkpoint=None,
    make_post_reduce=None,
    policy: RetryPolicy | None = None,
    retry_budget: int = 3,
    attempt_timeout_s: float = 0.0,
    logger=None,
    registry=None,
    rung_state: RungState | None = None,
    flight_recorder=None,
    flightrec_dir: str = ".",
    attempts_per_dispatch: int = 1,
    on_block=None,
):
    """Run the minimal-k sweep down an engine ladder.

    ``ladder`` is a list of ``(backend_name, factory)`` pairs; ``factory``
    builds the rung's engine (device init included — a factory that raises
    falls through like any other rung failure). ``make_checkpoint(name)``
    and ``make_post_reduce(name)`` (both optional) supply the per-rung
    checkpoint manager and recolor post-pass.

    Returns ``(MinimalColoringResult, ResilienceStats)``; raises
    :class:`SweepAbort` when every rung failed. The terminal abort is
    emitted into the event stream HERE (when ``logger`` is given) and —
    when a ``flight_recorder`` (``obs.flightrec``) is attached — the
    recorder's event tail is dumped to ``flightrec_dir`` with the
    ``structured_abort`` record included, so an rc-114 exit always
    leaves its final pre-abort events on disk even when JSONL logging
    was off.
    """
    stats = ResilienceStats()
    last_error: BaseException | None = None
    names = [name for name, _ in ladder]
    for idx, (name, factory) in enumerate(ladder):
        stats.rungs_tried.append(name)
        if rung_state is not None:
            rung_state.on_rung(name, idx)
        try:
            engine = factory()
            ckpt = make_checkpoint(name) if make_checkpoint is not None else None
            if ckpt is not None and logger is not None:
                restored = ckpt.restore()
                if restored is not None:
                    logger.event("checkpoint_resume", backend=name,
                                 next_k=int(restored[0]), done=bool(restored[2]))
            wrapped = RetryingEngine(
                engine, backend=name, policy=policy,
                budget=RetryBudget(retry_budget),
                attempt_timeout_s=attempt_timeout_s,
                logger=logger, registry=registry, stats=stats,
                rung_state=rung_state)
            result = find_minimal_coloring(
                wrapped, initial_k,
                strict_decrement=strict_decrement, k_min=k_min,
                validate=validate, on_attempt=on_attempt, checkpoint=ckpt,
                post_reduce=(make_post_reduce(name)
                             if make_post_reduce is not None else None),
                attempts_per_dispatch=attempts_per_dispatch,
                on_block=on_block)
            stats.engine_used = name
            return result, stats
        except SimulatedKill:
            raise
        except Exception as e:
            if isinstance(e, RungFailure):
                ecls, cause = e.error_class, e.cause
            else:
                # failures outside the engine call (validation assertion,
                # engine build/device init) degrade like any rung failure
                ecls, cause = classify_error(e), e
            last_error = cause
            if idx + 1 < len(ladder):
                stats.fallbacks += 1
                nxt = ladder[idx + 1][0]
                if registry is not None:
                    registry.counter("dgc_fallbacks_total",
                                     "engine-ladder fallbacks",
                                     to_backend=nxt).inc()
                if logger is not None:
                    logger.event("fallback", from_backend=name, to_backend=nxt,
                                 error_class=ecls.value, error=str(cause))
    if rung_state is not None:
        rung_state.on_exhausted()
    ab = SweepAbort(
        f"engine ladder exhausted after {len(names)} rung(s): "
        f"{' -> '.join(names)}",
        ladder=names, last_error=last_error)
    if logger is not None:
        logger.event("structured_abort", **ab.to_record())
    if flight_recorder is not None:
        try:
            flight_recorder.dump(flightrec_dir, reason="structured_abort",
                                 logger=logger)
        except OSError as e:   # diagnostics must not mask the abort
            print(f"# flight recorder dump failed: {e}", file=sys.stderr)
    raise ab


def default_ladder(backend: str) -> list[str]:
    """Degradation order starting at ``backend``: the canonical ladder's
    suffix when the backend is on it, else the backend plus the CPU
    oracle rung."""
    if backend in DEFAULT_LADDER:
        return list(DEFAULT_LADDER[DEFAULT_LADDER.index(backend):])
    if backend == "reference-sim":
        return [backend]
    return [backend, "reference-sim"]
