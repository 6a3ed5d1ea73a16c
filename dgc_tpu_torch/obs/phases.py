"""Host-side phase instrumentation: first-call vs. warm vs. host time
(the port's copy of ``dgc_tpu.obs.phases``, on PyTorch).

Every engine's ``attempt``/``sweep`` returns host arrays (the copy home is
inside the call), so the host-side breakdown is:

- **compile** — the first ``attempt``/``sweep`` wall time per engine (in
  the port: the kernels' build at first use, when not cached, and the run
  itself). Labeled ``warm=False`` in the event stream.
- **device** — subsequent attempt/sweep wall times: kernel execution plus
  the per-attempt copies home.
- **host** — everything else the driver does: graph generation/load,
  engine build, validation, the recolor post-pass, serialization.

``PhaseCollector`` accumulates all three, fencing the card's queued work
with ``torch.cuda.synchronize`` where a section asks for it, and feeds the
same numbers to the metrics registry and the event stream.
"""

from __future__ import annotations

import contextlib
import time


def _cuda_in_use() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def block_until_ready(tree):
    """Fence the card's queued work (when this process uses one); returns
    ``tree`` unchanged."""
    if _cuda_in_use():
        import torch

        torch.cuda.synchronize()
    return tree


def device_memory_stats():
    """Per-device allocator stats: each card this process uses, or the
    host (``cpu``, no stats) when it uses none."""
    if not _cuda_in_use():
        return [("cpu", None)]
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append((f"cuda:{i}", {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }))
    return out


class PhaseCollector:
    """Accumulating per-phase wall clock + per-attempt samples.

    ``section(name)`` scopes a host phase; ``attempt_sample(...)`` records
    one attempt's wall time under compile (cold) or device (warm). The
    snapshot (``totals``/``attempts``) feeds the run manifest, the
    metrics registry, and bench.py's per-phase breakdown.
    """

    def __init__(self, logger=None, registry=None):
        self.totals: dict[str, float] = {}
        self.attempts: list[dict] = []
        self._logger = logger
        self._registry = registry

    @contextlib.contextmanager
    def section(self, name: str, fence=None):
        """Scoped host phase; ``fence`` (a pytree) is blocked on before the
        clock stops so async device work lands inside its phase."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                block_until_ready(fence)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            if self._registry is not None:
                self._registry.histogram(
                    "dgc_phase_seconds", "wall time per host phase",
                    phase=name).observe(dt)

    def attempt_sample(self, k: int, seconds: float, warm: bool) -> None:
        name = "device" if warm else "compile"
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.attempts.append({"k": int(k), "seconds": seconds, "warm": warm})
        if self._registry is not None:
            self._registry.histogram(
                "dgc_attempt_seconds", "wall time per k-attempt call",
                phase=name).observe(seconds)
        if self._logger is not None:
            self._logger.event("phase", name=name, seconds=round(seconds, 6),
                               k=int(k), warm=warm,
                               attempt_index=len(self.attempts) - 1)

    def log_device_memory(self) -> None:
        stats = device_memory_stats()
        if not stats:
            return
        for dev, s in stats:
            if self._registry is not None and s:
                for key in ("bytes_in_use", "peak_bytes_in_use"):
                    if key in s:
                        self._registry.gauge(
                            "dgc_device_" + key, "device allocator " + key,
                            device=dev).set(s[key])
            if self._logger is not None:
                fields = {"device": dev}
                if s:
                    for key in ("bytes_in_use", "peak_bytes_in_use",
                                "bytes_limit"):
                        if key in s:
                            fields[key] = int(s[key])
                else:
                    fields["stats"] = None
                self._logger.event("device_memory", **fields)

    def snapshot(self) -> dict:
        return {"totals": {k: round(v, 6) for k, v in self.totals.items()},
                "attempts": [dict(a, seconds=round(a["seconds"], 6))
                             for a in self.attempts]}
