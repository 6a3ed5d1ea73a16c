"""``ObservedEngine`` — telemetry proxy around any coloring engine.

Wires the obs subsystem into the minimal-k driver without changing it:
``find_minimal_coloring`` sees the same ``attempt``/``sweep`` surface
(``sweep`` is only exposed when the wrapped engine has one, so the
driver's fused-path detection is unchanged), while every call is timed
into the ``PhaseCollector`` (first call = compile phase, warm calls =
device phase) and counted in the ``MetricsRegistry``. When the wrapped
engine supports in-kernel trajectories (``record_trajectory`` attribute —
the obs-threaded engines), the proxy switches them on so every
``AttemptResult`` carries its per-superstep trajectory.
"""

from __future__ import annotations

import time


class ObservedEngine:
    def __init__(self, engine, phases=None, registry=None,
                 record_trajectory: bool = True):
        self._engine = engine
        self._phases = phases
        self._registry = registry
        self._cold = True
        if record_trajectory and hasattr(engine, "record_trajectory"):
            engine.record_trajectory = True
        # the driver feature-detects the fused path via hasattr(e, "sweep")
        if hasattr(engine, "sweep"):
            self.sweep = self._sweep
        # likewise for the blocked path (attempts_per_dispatch > 1)
        if hasattr(engine, "attempt_block"):
            self.attempt_block = self._attempt_block

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _observe(self, kind: str, k: int, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        warm = not self._cold
        self._cold = False
        if self._phases is not None:
            self._phases.attempt_sample(k, dt, warm=warm)
        if self._registry is not None:
            self._registry.counter(
                "dgc_engine_calls_total", "attempt/sweep engine calls",
                kind=kind).inc()
            # the dispatch-amortization observable: one device call per
            # engine call regardless of how many attempts it chains —
            # the bench A/B's dispatch-count numerator/denominator
            self._registry.counter(
                "dgc_device_dispatches_total",
                "device dispatches (an attempt-block counts once)",
            ).inc()
            if kind == "sweep":
                results = out
            elif kind == "attempt_block":
                results = out.results
            else:
                results = (out,)
            for res in results:
                if res is None:
                    continue
                self._registry.counter(
                    "dgc_attempts_total", "k-attempts by exit status",
                    status=res.status.name).inc()
                self._registry.counter(
                    "dgc_supersteps_total",
                    "BSP supersteps executed across all attempts",
                ).inc(res.supersteps)
                self._registry.gauge(
                    "dgc_last_attempt_k", "color budget of the last attempt",
                ).set(res.k)
        return out

    def attempt(self, k: int):
        return self._observe("attempt", k, lambda: self._engine.attempt(k))

    def _sweep(self, k0: int):
        return self._observe("sweep", k0, lambda: self._engine.sweep(k0))

    def _attempt_block(self, k: int, attempts: int, **kw):
        return self._observe(
            "attempt_block", k,
            lambda: self._engine.attempt_block(k, attempts, **kw))
