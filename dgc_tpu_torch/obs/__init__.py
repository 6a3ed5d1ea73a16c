"""Telemetry (the port of ``dgc_tpu.obs``, the parts ported so far).

- ``obs.kernel`` — in-kernel superstep telemetry: a trajectory buffer on
  the card that the recording kernels write one row per superstep, copied
  home once per attempt with its colors row.
- ``obs.devclock`` — the clock behind the trajectory's timing column.
- ``obs.metrics`` — ``MetricsRegistry`` (counters, gauges, histograms)
  with its Prometheus text and dict exporters.
- ``obs.events`` — the JSONL event stream (``RunLogger``).
- ``obs.schema`` — the event schema (``validate_record``).
- ``obs.phases`` — host phase timing and the card's memory stats.
- ``obs.manifest`` — the single-JSON run manifest (``RunManifest``).
- ``obs.instrument`` — ``ObservedEngine``, the engine proxy that wires them
  into the minimal-k driver.

``events``, ``schema``, ``manifest`` and ``instrument`` are ``dgc_tpu``'s
files verbatim (``tests/test_torch_import.py`` pins them); ``metrics``
drops the JAX package's lock assertions and ``phases`` reads the card
through PyTorch. Not ported yet: the profiler windows, the flight
recorder, the HTTP endpoint, the time series, usage metering and tracing
(ROADMAP A3).
"""

from dgc_tpu_torch.obs.events import RunLogger
from dgc_tpu_torch.obs.instrument import ObservedEngine
from dgc_tpu_torch.obs.kernel import SuperstepTrajectory, decode_trajectory
from dgc_tpu_torch.obs.manifest import RunManifest
from dgc_tpu_torch.obs.metrics import MetricsRegistry
from dgc_tpu_torch.obs.phases import PhaseCollector

__all__ = [
    "MetricsRegistry",
    "ObservedEngine",
    "PhaseCollector",
    "RunLogger",
    "RunManifest",
    "SuperstepTrajectory",
    "decode_trajectory",
]
