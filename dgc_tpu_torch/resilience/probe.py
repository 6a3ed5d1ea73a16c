"""Automatic mesh-restore probe (port of ``dgc_tpu.resilience.probe``).

After a device loss the serve scheduler keeps serving on the survivor
sub-mesh (``serve.engine``'s failure-domain plane); restore is armed by
``device_health.mark_healthy()`` and ``request_restore()``.
:class:`HealthProbe` makes both calls itself: a daemon thread periodically
runs a tiny canary computation on each benched shard slot; a canary that
completes marks the slot healthy and, once no benched slot remains, arms
``request_restore()``, so the scheduler brings the full mesh back with no
operator call. A failing canary backs off exponentially per slot
(``backoff_base``×, capped at ``backoff_max_s``). Every attempt and every
restore arm lands in the obs stream as a ``mesh_probe`` event and on the
``dgc_mesh_probe_total`` counter.

``HealthProbe`` is ``dgc_tpu``'s class but for its default probe
(``tests/test_torch_import.py`` pins it): ``slot_canary(scheduler)``, which
runs ``canary_probe`` in PyTorch on the device the scheduler built the
benched slot over (a lane mesh may put several slots on one card). It is
reachable through the API: the serve CLI's ``--probe-interval`` waits for
the network front end (ROADMAP).
"""

from __future__ import annotations

import threading
import time


def canary_probe(device) -> bool:
    """A tiny computation on ``device`` (a ``torch.device`` or its name):
    place a 16-wide ``arange``, add one and sum it; True when the sum is
    136. Any exception (the device absent, a refused placement) is a
    failed probe, never a crashed probe thread."""
    try:
        import torch

        x = torch.arange(16, dtype=torch.int32, device=torch.device(device))
        return int((x + 1).sum()) == 136
    except Exception:
        return False


def slot_canary(scheduler):
    """The default probe of ``HealthProbe(scheduler)``: shard slot ``i``'s
    canary runs on ``scheduler.slot_device(i)``, the device the configured
    mesh put that slot on; a slot the scheduler does not know fails."""
    def probe(slot) -> bool:
        device = scheduler.slot_device(int(slot))
        return device is not None and canary_probe(device)
    return probe


class HealthProbe:   # dgc-lint: threaded
    """``HealthProbe(scheduler, interval_s=5.0).start()`` — the
    closed-loop restore driver over a ``BatchScheduler`` (anything with
    ``device_health`` / ``request_restore()``). ``probe_fn(device) ->
    bool`` is injectable for tests and non-JAX canaries; ``clock`` is
    injectable so backoff walks are testable without sleeping."""

    def __init__(self, scheduler, *, interval_s: float = 5.0,
                 probe_fn=None, backoff_base: float = 2.0,
                 backoff_max_s: float = 60.0, logger=None, registry=None,
                 clock=time.monotonic):
        if interval_s <= 0:
            raise ValueError("probe interval must be > 0 (omit the "
                             "probe entirely to disable it)")
        self.scheduler = scheduler                    # guarded-by: init
        self.interval_s = float(interval_s)           # guarded-by: init
        self.probe_fn = (probe_fn if probe_fn is not None
                         else slot_canary(scheduler))  # guarded-by: init
        self.backoff_base = float(backoff_base)       # guarded-by: init
        self.backoff_max_s = float(backoff_max_s)     # guarded-by: init
        self.logger = logger                          # guarded-by: init
        self.registry = registry                      # guarded-by: init
        self.clock = clock                            # guarded-by: init
        self._lock = threading.Lock()
        self._due: dict = {}        # device -> next probe t; guarded-by: _lock
        self._backoff: dict = {}    # device -> current s; guarded-by: _lock
        self._attempts: dict = {}   # device -> count; guarded-by: _lock
        self._probes = 0            # total canaries run; guarded-by: _lock
        self._restores_armed = 0    # request_restore calls; guarded-by: _lock
        self._stop = threading.Event()
        self._thread = None         # guarded-by: owner

    # -- obs plumbing ---------------------------------------------------
    def _event(self, **fields) -> None:
        if self.logger is not None:
            self.logger.event("mesh_probe", **fields)

    def _count(self, ok: bool) -> None:
        if self.registry is not None:
            self.registry.counter(
                "dgc_mesh_probe_total", "mesh canary probes by outcome",
                ok=str(bool(ok)).lower()).inc()

    # -- one probe pass (also the test entry point) ---------------------
    def tick(self) -> int:
        """Probe every benched device that is due; returns how many
        canaries ran. Safe on an unsharded scheduler (no health plane —
        nothing to probe)."""
        health = getattr(self.scheduler, "device_health", None)
        if health is None:
            return 0
        now = self.clock()
        ran = 0
        for dev in health.lost():
            with self._lock:
                if now < self._due.get(dev, 0.0):
                    continue
                self._attempts[dev] = self._attempts.get(dev, 0) + 1
                attempt = self._attempts[dev]
                self._probes += 1
            ok = False
            try:
                ok = bool(self.probe_fn(dev))
            except Exception:
                ok = False   # a probe bug is a failed probe, not a crash
            ran += 1
            self._count(ok)
            if ok:
                # the device answers again: un-bench it and, once the
                # bench is empty, arm the scheduler's restore path —
                # the same two calls the operator would have made
                health.mark_healthy(dev)
                with self._lock:
                    self._due.pop(dev, None)
                    self._backoff.pop(dev, None)
                    self._attempts.pop(dev, None)
                self._event(device=int(dev), ok=True, attempt=attempt,
                            action="probed")
                if not health.lost():
                    self.scheduler.request_restore()
                    with self._lock:
                        self._restores_armed += 1
                    self._event(device=int(dev), ok=True,
                                action="restore_requested")
            else:
                with self._lock:
                    prev = self._backoff.get(dev, 0.0)
                    backoff = min(self.backoff_max_s,
                                  (prev * self.backoff_base)
                                  if prev > 0 else self.interval_s)
                    self._backoff[dev] = backoff
                    self._due[dev] = now + backoff
                self._event(device=int(dev), ok=False, attempt=attempt,
                            backoff_s=round(backoff, 4), action="probed")
        return ran

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "HealthProbe":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dgc-mesh-probe")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.tick()
            except Exception:
                pass   # the probe loop must outlive any scheduler hiccup

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def snapshot(self) -> dict:
        """Locked copy for /healthz-style reads and harness asserts."""
        with self._lock:
            return {"probes": self._probes,
                    "restores_armed": self._restores_armed,
                    "benched": {int(d): {"attempts": self._attempts.get(d, 0),
                                         "backoff_s": round(b, 4)}
                                for d, b in self._backoff.items()}}
