"""Metrics registry: counters, gauges, histograms, and their exporters
(the port's copy of ``dgc_tpu.obs.metrics``, without its opt-in runtime
lock assertions, which live in ``dgc_tpu``'s analysis package).

The operational layer the reference lacks entirely (SURVEY.md §5 — its
only numbers are prints). One process-wide registry per run; exporters:

- ``to_prometheus()`` — Prometheus text exposition format (``# HELP`` /
  ``# TYPE`` + samples), for ``--metrics-prom`` and scrape sidecars;
- ``to_dict()`` — plain JSON-able snapshot, embedded in the run manifest.

No third-party client library: the container does not ship one, and the
exposition format is a few lines of text.
"""

from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# wall-time histogram buckets (seconds): spans compile (~10s) down to a
# single superstep dispatch (~ms)
DEFAULT_TIME_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                        10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@dataclass
class Counter:
    name: str
    help: str
    labels: dict = field(default_factory=dict)   # guarded-by: init
    value: float = 0.0                           # guarded-by: _lock
    # serve worker threads mutate concurrently with exporter reads; the
    # per-metric lock makes each update/read atomic (MetricsRegistry's
    # lock only guards the get-or-create dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        with self._lock:
            self.value += v


@dataclass
class Gauge:
    name: str
    help: str
    labels: dict = field(default_factory=dict)   # guarded-by: init
    value: float = 0.0                           # guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


@dataclass
class Histogram:
    name: str
    help: str
    labels: dict = field(default_factory=dict)   # guarded-by: init
    buckets: tuple = DEFAULT_TIME_BUCKETS        # guarded-by: init
    counts: list = None                          # guarded-by: _lock
    total: float = 0.0                           # guarded-by: _lock
    n: int = 0                                   # guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def __post_init__(self):
        if self.counts is None:
            self.counts = [0] * (len(self.buckets) + 1)  # +1: +Inf

    def observe(self, v: float) -> None:
        with self._lock:
            self.total += float(v)
            self.n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile estimate — the
        ``histogram_quantile`` rule: find the bucket the q·n-th
        observation falls in, interpolate linearly inside its
        ``(lower, upper]`` bounds (lower = previous edge, 0 before the
        first — observations are assumed non-negative, which every
        latency/time series here is). A quantile landing in the +Inf
        overflow bucket clamps to the largest finite edge. ``None`` when
        empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            n = self.n
            counts = list(self.counts)
        if n == 0:
            return None
        target = q * n
        cum = 0.0
        lo = 0.0
        for i, b in enumerate(self.buckets):
            c = counts[i]
            if c > 0 and cum + c >= target:
                return lo + (b - lo) * max(0.0, target - cum) / c
            cum += c
            lo = b
        return float(self.buckets[-1]) if self.buckets else None


class MetricsRegistry:
    """Get-or-create registry keyed on (name, sorted labels).

    Thread-safe: the serve worker pool (``serve.queue`` threads) and the
    batch dispatcher mutate counters/histograms concurrently with
    exporter reads (the ``--metrics-port`` scrape endpoint, manifest
    finalization). The registry lock guards the get-or-create maps; each
    metric's own lock makes updates and exporter reads atomic."""

    def __init__(self):
        self._metrics: dict = {}   # (name, labelkey) -> metric; guarded-by: _lock
        self._meta: dict = {}      # name -> (kind, help); guarded-by: _lock
        self._lock = threading.RLock()

    def _get(self, cls, kind: str, name: str, help: str, labels: dict, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        with self._lock:
            prior = self._meta.get(name)
            if prior is not None and prior[0] != kind:
                raise ValueError(
                    f"metric {name} already registered as {prior[0]}, "
                    f"not {kind}")
            self._meta[name] = (kind, help or (prior[1] if prior else ""))
            key = (name, tuple(sorted(labels.items())))
            if key not in self._metrics:
                self._metrics[key] = cls(name=name, help=help,
                                         labels=dict(labels), **kw)
            return self._metrics[key]

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, "counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, "gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_TIME_BUCKETS, **labels) -> Histogram:
        return self._get(Histogram, "histogram", name, help, labels,
                         buckets=buckets)

    def _snapshot(self):
        with self._lock:
            return sorted(self._metrics.items()), dict(self._meta)

    def histograms(self, name: str) -> list:
        """All label variants of one histogram family (the serve tier's
        per-shape-class latency summaries read these)."""
        metrics, meta = self._snapshot()
        if meta.get(name, (None,))[0] != "histogram":
            return []
        return [m for (n, _), m in metrics if n == name]

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, families grouped and
        terminated with the required trailing newline."""
        out = []
        metrics, meta = self._snapshot()
        for name, (kind, help) in sorted(meta.items()):
            out.append(f"# HELP {name} {help}")
            out.append(f"# TYPE {name} {kind}")
            for (n, _), m in metrics:
                if n != name:
                    continue
                with m._lock:
                    if kind == "histogram":
                        cum = 0
                        for b, c in zip(tuple(m.buckets) + (math.inf,),
                                        m.counts):
                            cum += c
                            lab = dict(m.labels, le=_fmt(b))
                            out.append(
                                f"{name}_bucket{_labels_str(lab)} {cum}")
                        out.append(f"{name}_sum{_labels_str(m.labels)} "
                                   f"{_fmt(m.total)}")
                        out.append(f"{name}_count{_labels_str(m.labels)} "
                                   f"{m.n}")
                    else:
                        out.append(f"{name}{_labels_str(m.labels)} "
                                   f"{_fmt(m.value)}")
        return "\n".join(out) + "\n"

    def to_dict(self) -> dict:
        """JSON-able snapshot (embedded in the run manifest)."""
        snap = {}
        metrics, meta = self._snapshot()
        for (name, labelkey), m in metrics:
            kind = meta[name][0]
            key = name + _labels_str(dict(labelkey))
            with m._lock:
                if kind == "histogram":
                    snap[key] = {"kind": kind, "sum": m.total, "count": m.n,
                                 "buckets": dict(zip(map(_fmt, m.buckets),
                                                     m.counts[:-1])),
                                 "inf": m.counts[-1]}
                else:
                    snap[key] = {"kind": kind, "value": m.value}
        return snap

    def write_prom(self, path: str) -> None:
        from pathlib import Path

        p = Path(path)
        if p.parent != Path(""):
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_prometheus())
