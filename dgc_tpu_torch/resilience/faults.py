"""Deterministic, seeded fault-injection plane.

The TPU port inherits none of Spark's fault tolerance (RDD lineage, task
retry — SURVEY.md §5), so the resilience layer has to be *testable*: every
failure mode the supervisor claims to survive must be reproducible on
demand, on CPU, bit-for-bit. This module is that test plane — named
injection points threaded through the real execution path:

- ``device_init``       — first backend touch (``utils.watchdog.guarded_device_init``)
- ``compile``           — a rung's first engine call (cold dispatch)
- ``attempt``           — every attempt/sweep dispatch (``supervisor.RetryingEngine``)
- ``transfer``          — device→host result transfer (after the engine call)
- ``checkpoint_write``  — after ``CheckpointManager.save`` lands its files

and, since the serve tier grew its own fault plane (the crash-safe serve
PR — quarantine/watchdog semantics live in ``serve.engine``, journal
recovery in ``serve.netfront``):

- ``serve_dispatch``    — every batched slice/pair kernel dispatch
  (``serve.engine.BatchScheduler``; hangs here are what the dispatch
  watchdog tears down and rebuilds)
- ``lane_seat``         — seating one queued call into a lane
- ``deliver``           — handing a finished result back to its ticket
  (``serve.queue.ServeFrontEnd._worker``)
- ``journal_write``     — every ticket-journal append
  (``serve.netfront.journal.TicketJournal``)
- ``net_accept``        — the listener's submit path
  (``serve.netfront.listener.NetFront``)

and, since the failure-domain plane (``resilience.domains``) taught the
mesh tiers to survive losing hardware:

- ``mesh``              — every sharded dispatch (the serve scheduler's
  sharded slice/pair kernels when ``--mesh-devices`` is active, and
  ``parallel.mesh.make_mesh`` on the single-graph sharded engines'
  build path), so a fault can land exactly at the Nth multi-device
  dispatch

and fault *kinds* that mimic the production failure classes:

- ``transient``  — an ``XlaRuntimeError``-shaped ``UNAVAILABLE`` error
- ``oom``        — ``RESOURCE_EXHAUSTED`` (persistent per engine config:
  the classifier sends these down the fallback ladder, not into retries)
- ``fatal``      — an unclassifiable internal error
- ``hang``       — block for ``param`` seconds (exercises the attempt
  watchdog; default long enough that an unguarded run visibly wedges)
- ``truncate``   — cut the checkpoint manifest short (torn write)
- ``corrupt``    — scribble garbage into ``best_colors.npy``
- ``kill``       — die mid-sweep: ``os._exit(KILL_RC)`` when the plane is
  ``hard_kill`` (real process, chaos harness) or raise ``SimulatedKill``
  (a ``BaseException`` no handler swallows) for in-process tests
- ``device_loss`` — one mesh device drops out mid-run
  (``POINT@N=device_loss:DEV`` — DEV is the lost device's index;
  composable with every serve/sweep point above): raises
  :class:`InjectedDeviceLoss`, which the failure-domain plane
  (``resilience.domains``) classifies as a device loss — the serve
  scheduler re-shards onto the survivors, the single-graph supervisor
  takes its re-shard rung

**Zero overhead when disabled**: every call site goes through
:func:`fault_point`, which is a single module-global ``None`` check — no
allocation, no locking, no schedule lookup — until :func:`install` arms a
plane. Schedules are deterministic: a fault fires on the Nth hit of its
point (1-based occurrence counting), so the same spec string replays the
same failure at the same place every run.

Spec grammar (CLI ``--inject-faults`` / chaos harness)::

    SPEC   := entry ("," entry)*
    entry  := POINT "@" OCCURRENCE "=" KIND [":" PARAM]
    e.g.     "attempt@2=transient,checkpoint_write@1=truncate,attempt@3=hang:0.2"
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

KILL_RC = 137  # simulated SIGKILL exit code (128 + 9), documented in README

POINTS = ("device_init", "compile", "attempt", "transfer", "checkpoint_write",
          # serve tier (crash-safe serve PR)
          "serve_dispatch", "lane_seat", "deliver", "journal_write",
          "net_accept",
          # failure-domain plane: sharded dispatches (serve mesh kernels,
          # make_mesh on the single-graph sharded build path)
          "mesh")
KINDS = ("transient", "oom", "fatal", "hang", "truncate", "corrupt", "kill",
         "device_loss")

# the serve tier's injection points (chaos_serve schedules draw over
# exactly these; the sweep-side chaos harness never hits them)
SERVE_POINTS = ("serve_dispatch", "lane_seat", "deliver", "journal_write",
                "net_accept")

# kinds that act on checkpoint files need the checkpoint_write context
_CHECKPOINT_KINDS = ("truncate", "corrupt")


class FaultInjected(RuntimeError):
    """Base of all injected errors; ``error_class`` drives the classifier."""

    error_class = "transient"


class InjectedTransientError(FaultInjected):
    error_class = "transient"


class InjectedResourceExhausted(FaultInjected):
    error_class = "resource"


class InjectedFatalError(FaultInjected):
    error_class = "fatal"


class InjectedDeviceLoss(FaultInjected):
    """One mesh device dropped out (the ``device_loss`` kind). ``device``
    is the lost device's index into the mesh's device list (None when
    the spec carried no ``:DEV`` param — an anonymous loss the health
    model attributes conservatively). Non-retryable on the same mesh by
    construction: the classifier sends it to the failure-domain plane
    (re-shard onto survivors), never into same-engine retries."""

    error_class = "device_loss"

    def __init__(self, message: str, device: int | None = None):
        super().__init__(message)
        self.device = device


class SimulatedKill(BaseException):
    """In-process stand-in for a SIGKILL: a ``BaseException`` so no retry
    handler can swallow it — only the test harness catches it."""


@dataclass(frozen=True)
class FaultSpec:
    point: str
    occurrence: int          # fires on the Nth hit of ``point`` (1-based)
    kind: str
    param: float | None = None  # hang: seconds to block

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r} (want one of {POINTS})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (want one of {KINDS})")
        if self.occurrence < 1:
            raise ValueError(f"occurrence must be >= 1, got {self.occurrence}")
        if self.kind in _CHECKPOINT_KINDS and self.point != "checkpoint_write":
            raise ValueError(f"{self.kind!r} only applies at checkpoint_write")

    def to_token(self) -> str:
        tok = f"{self.point}@{self.occurrence}={self.kind}"
        if self.param is not None:
            tok += f":{self.param:g}"
        return tok

    @classmethod
    def parse_token(cls, token: str) -> "FaultSpec":
        try:
            head, kind = token.split("=", 1)
            point, occ = head.split("@", 1)
            param = None
            if ":" in kind:
                kind, raw = kind.split(":", 1)
                param = float(raw)
            return cls(point=point.strip(), occurrence=int(occ), kind=kind.strip(),
                       param=param)
        except ValueError as e:
            raise ValueError(f"bad fault token {token!r} "
                             f"(want POINT@N=KIND[:PARAM]): {e}") from e


class FaultSchedule:
    """An ordered set of :class:`FaultSpec`; parse/serialize round-trips."""

    def __init__(self, specs: list[FaultSpec] | None = None):
        self.specs = list(specs or [])

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        tokens = [t.strip() for t in spec.split(",") if t.strip()]
        return cls([FaultSpec.parse_token(t) for t in tokens])

    def to_spec(self) -> str:
        return ",".join(s.to_token() for s in self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    @classmethod
    def random(cls, rng, n_faults: int = 2, *,
               kinds: tuple = ("transient", "oom", "truncate", "corrupt",
                               "kill", "hang"),
               max_occurrence: int = 3,
               hang_seconds: float = 0.2) -> "FaultSchedule":
        """Draw a deterministic schedule from ``rng`` (``random.Random``).

        Chaos-harness entry: every draw from the same seed is the same
        schedule. Kinds are mapped to their natural points (checkpoint
        kinds to ``checkpoint_write``, the rest to ``attempt``) and at most
        one ``kill`` per schedule (the process only dies once)."""
        specs: list[FaultSpec] = []
        killed = False
        for _ in range(n_faults):
            kind = rng.choice(kinds)
            if kind == "kill":
                if killed:
                    kind = "transient"
                killed = True
            point = "checkpoint_write" if kind in _CHECKPOINT_KINDS + ("kill",) \
                else "attempt"
            occ = rng.randint(1, max_occurrence)
            param = hang_seconds if kind == "hang" else None
            spec = FaultSpec(point=point, occurrence=occ, kind=kind, param=param)
            if any(s.point == spec.point and s.occurrence == spec.occurrence
                   for s in specs):
                continue  # one fault per (point, occurrence) slot
            specs.append(spec)
        return cls(specs)

    @classmethod
    def random_serve(cls, rng, n_faults: int = 2, *,
                     kinds: tuple = ("transient", "oom", "fatal", "hang"),
                     points: tuple = SERVE_POINTS,
                     must_cover: str | None = None,
                     max_occurrence: int = 3,
                     hang_seconds: float = 0.2) -> "FaultSchedule":
        """Seeded serve-tier schedule: faults land on the serve points
        (``tools/chaos_serve.py``'s entry). ``must_cover`` forces at
        least one fault onto that point, so a round-robin over
        ``SERVE_POINTS`` provably exercises every point. No ``kill``
        kind here — in-process serve chaos asserts recovery, and the
        real-process kill leg is the harness's SIGKILL-at-journal-offset
        cycle, not an injected exit."""
        specs: list[FaultSpec] = []
        want = list(points)
        if must_cover is not None:
            want = [must_cover] + [p for p in want if p != must_cover]
        for i in range(n_faults):
            point = want[0] if i == 0 and must_cover is not None \
                else rng.choice(list(points))
            kind = rng.choice(list(kinds))
            occ = rng.randint(1, max_occurrence)
            param = hang_seconds if kind == "hang" else None
            spec = FaultSpec(point=point, occurrence=occ, kind=kind,
                             param=param)
            if any(s.point == spec.point and s.occurrence == spec.occurrence
                   for s in specs):
                continue  # one fault per (point, occurrence) slot
            specs.append(spec)
        return cls(specs)

    @classmethod
    def random_mesh(cls, rng, n_devices: int, n_faults: int = 1, *,
                    points: tuple = ("mesh", "serve_dispatch", "lane_seat"),
                    max_occurrence: int = 4) -> "FaultSchedule":
        """Seeded device-kill schedule for the failure-domain chaos
        harness (``tools/chaos_mesh.py``): every fault is a
        ``device_loss`` of a drawn device index, landed on a drawn
        sharded point/occurrence — so seeded draws cover losses at
        slice boundaries (``mesh``/``serve_dispatch``), mid-ladder
        (later occurrences), and during seating (``lane_seat``)."""
        specs: list[FaultSpec] = []
        for _ in range(n_faults):
            spec = FaultSpec(
                point=rng.choice(list(points)),
                occurrence=rng.randint(1, max_occurrence),
                kind="device_loss",
                param=float(rng.randrange(max(1, n_devices))))
            if any(s.point == spec.point and s.occurrence == spec.occurrence
                   for s in specs):
                continue  # one fault per (point, occurrence) slot
            specs.append(spec)
        return cls(specs)


class FaultPlane:
    """Armed fault schedule: counts hits per point, fires matching specs.

    ``on_fire(record)`` (if given) observes every fired fault — the CLI
    routes it into the obs event stream. ``fired`` keeps the same records
    for callers that poll (bench, tests).

    Hit counting is lock-guarded: the sweep tier fires from one driver
    thread, but the serve points fire concurrently from listener handler
    threads, the batch dispatcher, and worker threads — occurrence
    semantics must stay exact under that interleaving. The fault BODY
    runs outside the lock (a ``hang`` at one point must not serialize
    every other point's no-op hit)."""

    def __init__(self, schedule: FaultSchedule, *, hard_kill: bool = False,
                 on_fire=None):
        self.schedule = schedule
        self.hard_kill = hard_kill
        self.on_fire = on_fire
        self._lock = threading.Lock()
        self.fired: list[dict] = []          # guarded-by: _lock
        self._counts: dict[str, int] = {}    # guarded-by: _lock

    def fire(self, point: str, **ctx) -> None:
        due: list[tuple] = []
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            for spec in self.schedule:
                if spec.point == point and spec.occurrence == n:
                    record = {"point": point, "kind": spec.kind,
                              "occurrence": n, "param": spec.param}
                    self.fired.append(record)
                    due.append((spec, record))
        for spec, record in due:
            if self.on_fire is not None:
                self.on_fire(record)
            self._execute(spec, ctx)

    def fired_snapshot(self) -> list[dict]:
        """Locked copy of the fired records (pollers racing serve
        threads)."""
        with self._lock:
            return [dict(r) for r in self.fired]

    # -- fault bodies ---------------------------------------------------

    def _execute(self, spec: FaultSpec, ctx: dict) -> None:
        kind = spec.kind
        if kind == "transient":
            raise InjectedTransientError(
                f"INJECTED UNAVAILABLE: transient device error at "
                f"{spec.point}@{spec.occurrence}")
        if kind == "oom":
            raise InjectedResourceExhausted(
                f"INJECTED RESOURCE_EXHAUSTED: out of memory at "
                f"{spec.point}@{spec.occurrence}")
        if kind == "fatal":
            raise InjectedFatalError(
                f"INJECTED INTERNAL: unrecoverable error at "
                f"{spec.point}@{spec.occurrence}")
        if kind == "hang":
            time.sleep(spec.param if spec.param is not None else 30.0)
            return
        if kind == "kill":
            if self.hard_kill:
                os._exit(KILL_RC)
            raise SimulatedKill(f"injected kill at {spec.point}@{spec.occurrence}")
        if kind == "device_loss":
            dev = None if spec.param is None else int(spec.param)
            raise InjectedDeviceLoss(
                f"INJECTED DEVICE_LOST: mesh device "
                f"{'?' if dev is None else dev} dropped at "
                f"{spec.point}@{spec.occurrence}", device=dev)
        if kind in _CHECKPOINT_KINDS:
            directory = ctx.get("directory")
            if directory is None:
                return  # nothing to corrupt at this call site
            self._corrupt_checkpoint(str(directory), kind)
            return
        raise AssertionError(f"unhandled fault kind {kind!r}")

    @staticmethod
    def _corrupt_checkpoint(directory: str, kind: str) -> None:
        from dgc_tpu_torch.utils import checkpoint as _ck

        if kind == "truncate":
            # torn manifest write: keep the first half of the JSON
            path = os.path.join(directory, _ck._MANIFEST)
            if os.path.exists(path):
                with open(path, "r+b") as fh:
                    data = fh.read()
                    fh.seek(0)
                    fh.truncate(max(1, len(data) // 2))
        else:  # corrupt: scribble over the colors payload
            path = os.path.join(directory, _ck._COLORS)
            if os.path.exists(path):
                with open(path, "r+b") as fh:
                    fh.seek(0)
                    fh.write(b"\xde\xad\xbe\xef" * 4)


# -- the global plane ----------------------------------------------------
# fault_point() is on real hot-ish paths (per attempt dispatch, per
# checkpoint write); when no plane is installed it must cost one global
# load and one comparison — nothing else.

_plane: FaultPlane | None = None


def install(plane: FaultPlane) -> FaultPlane:
    global _plane
    _plane = plane
    return plane


def uninstall() -> None:
    global _plane
    _plane = None


def active() -> FaultPlane | None:
    return _plane


def fault_point(name: str, **ctx) -> None:
    """Injection hook. A no-op (one ``None`` check) unless a plane is armed."""
    if _plane is not None:
        _plane.fire(name, **ctx)


class injected:
    """``with injected(plane): ...`` — scoped install for tests."""

    def __init__(self, plane: FaultPlane):
        self.plane = plane

    def __enter__(self) -> FaultPlane:
        return install(self.plane)

    def __exit__(self, *exc) -> None:
        uninstall()
