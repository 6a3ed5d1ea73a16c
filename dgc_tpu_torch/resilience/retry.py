"""Error classification and bounded retry/backoff policy.

The reference delegates this wholesale to Spark (task retry with
``spark.task.maxFailures``, lineage recompute); on the TPU port an error
surfaces as an ``XlaRuntimeError`` whose *gRPC-style status prefix* is the
only machine-readable signal of whether retrying can help. The classifier
maps any exception to one of three classes:

- ``TRANSIENT`` — worth retrying on the *same* engine (UNAVAILABLE,
  DEADLINE_EXCEEDED, ABORTED, connection drops): the supervisor backs off
  and re-dispatches the identical attempt, which is bit-identical by
  engine determinism.
- ``RESOURCE`` — ``RESOURCE_EXHAUSTED`` / OOM: deterministic for a fixed
  (engine, graph, k) configuration, so retrying the same rung would fail
  the same way; the supervisor skips straight down the fallback ladder.
- ``FATAL`` — everything else (internal errors, invalid-coloring
  assertions): no retry; the ladder may still cure it if the failure is
  engine-specific, otherwise the sweep ends in a structured abort.

Backoff is exponential with deterministic seeded jitter — resilience must
never make a run irreproducible, so the jitter sequence is a function of
the policy seed, not the wall clock.
"""

from __future__ import annotations

import enum
import random
from dataclasses import dataclass

from dgc_tpu_torch.resilience.faults import FaultInjected


class ErrorClass(str, enum.Enum):
    TRANSIENT = "transient"
    RESOURCE = "resource"
    FATAL = "fatal"
    # a mesh device dropped out: deterministic for the same mesh (the
    # device is gone), so never retried on the same engine — the
    # failure-domain plane (resilience.domains) re-shards onto the
    # survivors instead (serve tier) or the supervisor takes its
    # re-shard rung (single-graph sharded sweep)
    DEVICE_LOSS = "device_loss"


# device-loss status markers beyond the injected class: what a real lost
# chip surfaces through XLA/PJRT (message-based, like the classes below)
_DEVICE_LOSS_MARKERS = ("DEVICE_LOST", "DEVICE IS LOST", "CHIP REBOOT",
                        "DEVICE OR RESOURCE BUSY")


# gRPC/XLA status markers, checked against str(exc) uppercased. RESOURCE
# markers are checked first: "RESOURCE_EXHAUSTED: ... transfer aborted"
# must classify as resource, not transient.
_RESOURCE_MARKERS = (
    "RESOURCE_EXHAUSTED", "OUT OF MEMORY", "OOM", "ALLOCATION FAILURE",
)
_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
    "CONNECTION RESET", "SOCKET CLOSED", "BROKEN PIPE", "UNREACHABLE",
)


def classify_error(exc: BaseException) -> ErrorClass:
    """Map an exception to its retry class (see module docstring)."""
    cls = getattr(exc, "error_class", None)
    if cls is not None and isinstance(exc, FaultInjected):
        return ErrorClass(cls)
    msg = str(exc).upper()
    # XlaRuntimeError isn't importable without jaxlib, and wrapped device
    # errors (e.g. through shard_map) keep the status prefix in the
    # message — so classification is message-based for any exception type
    if any(m in msg for m in _DEVICE_LOSS_MARKERS):
        return ErrorClass.DEVICE_LOSS
    if any(m in msg for m in _RESOURCE_MARKERS):
        return ErrorClass.RESOURCE
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return ErrorClass.TRANSIENT
    return ErrorClass.FATAL


@dataclass
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    ``delay_i = min(base * 2**i, max) * (1 + jitter * u_i)`` with
    ``u_i ~ U[-1, 1)`` drawn from ``random.Random(seed)`` — the same seed
    replays the same delay sequence."""

    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delays(self):
        rng = random.Random(self.seed)
        i = 0
        while True:
            d = min(self.base_delay_s * (2 ** i), self.max_delay_s)
            yield max(0.0, d * (1.0 + self.jitter * (rng.random() * 2.0 - 1.0)))
            i += 1


class RetryBudget:
    """Per-sweep cap on transient retries — a flapping backend must not
    turn a bounded sweep into an unbounded one."""

    def __init__(self, total: int):
        self.total = int(total)
        self.used = 0

    @property
    def left(self) -> int:
        return max(0, self.total - self.used)

    def take(self) -> bool:
        """Consume one retry; False when the budget is exhausted."""
        if self.used >= self.total:
            return False
        self.used += 1
        return True
