"""Failure domains over a device mesh: health, blast radius, degrade/restore.

The paper's BSP design assumes every worker survives every superstep
(PAPER.md §0 — broadcast-everything supersteps with no failure story),
and the mesh tiers inherited that: one lost device killed the lane pool
(serve) or the whole sharded sweep (single-graph). This module is the
shared substrate both tiers degrade through instead:

- :class:`DomainMap` — which devices share a failure domain (host,
  tray, PCIe switch). Losing one device makes its whole domain suspect;
  the map also answers "the largest power-of-two sub-mesh of the
  survivors" — the shape every lane pad / pow2 pool can re-shard onto
  without changing any kernel body (compile caches already key on mesh
  shape, and the in/out-shardings jit factories re-lower the SAME
  bodies onto the smaller mesh).
- :class:`DeviceHealth` — per-device health fed by dispatch outcomes:
  a classified device loss marks the culprit ``lost``; an operator (or
  probe) marking it ``healthy`` again arms the restore path. Thread-safe
  — the serve dispatcher writes while ``/healthz`` handler threads read.
- :class:`MeshState` — the degrade/restore state machine: ``full`` →
  (loss) → ``degraded`` → (loss…) → ``collapsed`` (single device /
  unsharded), and back up on restore. Every transition is recorded with
  a monotonic ``generation`` so compile-cache keys can never confuse two
  same-sized meshes over different survivor sets.
- :func:`is_device_loss` — the classifier gate: injected
  :class:`~dgc_tpu_torch.resilience.faults.InjectedDeviceLoss` or a real
  XLA/PJRT device-lost error (``retry.classify_error`` message markers).
- :func:`reshard_ladder` — the single-graph supervisor's re-shard rungs
  (``sharded@7`` = the same engine rebuilt over 7 devices): resume the
  sweep on N−1 devices from the last attempt checkpoint before the
  ladder concedes to single-device engines — exact because the sharded
  engines are shard-count-invariant bit-for-bit (MULTICHIP_r02–r05).

Everything here is host-side bookkeeping over small integers — no jax
import, so the module loads in tools and tests without a backend.
"""

from __future__ import annotations

import threading

from dgc_tpu_torch.resilience.retry import ErrorClass, classify_error

#: health vocabulary (the /healthz per-device states)
HEALTHY = "healthy"
LOST = "lost"


def is_device_loss(exc: BaseException) -> bool:
    """True when ``exc`` means a mesh device dropped out — the gate the
    serve dispatcher uses to choose re-sharding over a plain pool
    rebuild. Covers the injected kind (``error_class`` attribute) and
    real XLA/PJRT losses (message markers via ``classify_error``)."""
    return classify_error(exc) is ErrorClass.DEVICE_LOSS


def largest_pow2(n: int) -> int:
    """The largest power of two ≤ ``n`` (0 for n < 1) — the only pool
    shape the pow2 lane pads can shard evenly over."""
    if n < 1:
        return 0
    return 1 << (int(n).bit_length() - 1)


class DomainMap:
    """Failure-domain map over ``n`` mesh devices.

    ``domain_of[i]`` names device ``i``'s failure domain; the default
    (one domain per device) models independent local chips. A multi-host
    mesh passes e.g. ``[0, 0, 0, 0, 1, 1, 1, 1]`` — two 4-device hosts —
    so one lost device can take its whole domain out of the survivor
    set (``blast_radius``: a dead host loses all its chips at once).
    Immutable after construction; safe to share across threads."""

    def __init__(self, n_devices: int, domain_of=None):
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.n_devices = int(n_devices)
        if domain_of is None:
            domain_of = list(range(self.n_devices))
        domain_of = [int(d) for d in domain_of]
        if len(domain_of) != self.n_devices:
            raise ValueError(
                f"domain_of has {len(domain_of)} entries for "
                f"{self.n_devices} device(s)")
        self.domain_of = tuple(domain_of)

    def blast_radius(self, device: int) -> tuple:
        """Every device sharing the lost device's failure domain —
        what a dead host actually takes with it."""
        dom = self.domain_of[device]
        return tuple(i for i in range(self.n_devices)
                     if self.domain_of[i] == dom)

    def submesh(self, surviving) -> tuple:
        """The largest power-of-two sub-mesh of ``surviving`` device
        indices (index order preserved — deterministic, so every
        incarnation of the same loss sequence re-shards onto the same
        devices). Returns () when nothing survives."""
        surv = sorted(int(i) for i in surviving)
        return tuple(surv[:largest_pow2(len(surv))])


class DeviceHealth:   # dgc-lint: threaded
    """Per-device health over ``n`` mesh devices, fed by dispatch
    outcomes. The serve dispatcher marks losses; ``/healthz`` handler
    threads and harness pollers read snapshots; an operator/probe marks
    a replaced device healthy to arm the restore path."""

    def __init__(self, n_devices: int, domains: DomainMap | None = None):
        self.domains = domains or DomainMap(n_devices)
        self._lock = threading.Lock()
        self._status = [HEALTHY] * int(n_devices)   # guarded-by: _lock
        self._losses = 0                            # guarded-by: _lock
        self._ok_dispatches = 0                     # guarded-by: _lock

    def mark_lost(self, device: int) -> tuple:
        """Record a device loss; the whole failure domain goes with it
        (``DomainMap.blast_radius``). Returns the devices newly lost."""
        hit = self.domains.blast_radius(int(device))
        newly = []
        with self._lock:
            self._losses += 1
            for d in hit:
                if self._status[d] != LOST:
                    self._status[d] = LOST
                    newly.append(d)
        return tuple(newly)

    def mark_healthy(self, device: int | None = None) -> None:
        """Mark one device (or, with None, every device) healthy again —
        the operator/probe's restore arm."""
        with self._lock:
            if device is None:
                for d in range(len(self._status)):
                    self._status[d] = HEALTHY
            else:
                self._status[int(device)] = HEALTHY

    def record_ok(self) -> None:
        """One successful dispatch over the current mesh (health-model
        evidence that the survivors are actually serving)."""
        with self._lock:
            self._ok_dispatches += 1

    def lost(self) -> tuple:
        with self._lock:
            return tuple(i for i, s in enumerate(self._status) if s == LOST)

    def surviving(self) -> tuple:
        with self._lock:
            return tuple(i for i, s in enumerate(self._status)
                         if s == HEALTHY)

    def snapshot(self) -> dict:
        """Locked copy for /healthz: per-device status plus counters."""
        with self._lock:
            return {"devices": list(self._status),
                    "losses": self._losses,
                    "ok_dispatches": self._ok_dispatches}


#: MeshState states
FULL = "full"
DEGRADED = "degraded"
COLLAPSED = "collapsed"   # < 2 survivors: the unsharded single-device path


class MeshState:   # dgc-lint: threaded
    """The degrade/restore state machine over one mesh's lifetime.

    ``on_loss(surviving)`` plans the next shape (the largest pow2
    sub-mesh of the survivors) and advances the generation;
    ``on_restore()`` plans the return to the full mesh. The GENERATION
    is the monotonic counter compile-cache keys embed, so a 4-device
    mesh over devices {0..3} and a later 4-device mesh over {4..7} can
    never share a cache entry."""

    def __init__(self, n_devices: int, domains: DomainMap | None = None):
        self.n_devices = int(n_devices)
        self.domains = domains or DomainMap(self.n_devices)
        self._lock = threading.Lock()
        self.state = FULL            # guarded-by: _lock
        self.generation = 0          # guarded-by: _lock
        self.degrades = 0            # guarded-by: _lock
        self.restores = 0            # guarded-by: _lock
        self.current = tuple(range(self.n_devices))   # guarded-by: _lock

    def on_loss(self, surviving) -> dict:
        """Plan the degrade: returns ``{"devices": (idx...), "state",
        "generation"}`` for the new mesh (devices empty/1-long means
        collapse to the unsharded path)."""
        plan = self.domains.submesh(surviving)
        with self._lock:
            self.generation += 1
            self.degrades += 1
            self.current = plan
            self.state = COLLAPSED if len(plan) < 2 else DEGRADED
            return {"devices": plan, "state": self.state,
                    "generation": self.generation}

    def on_restore(self) -> dict:
        """Plan the restore back to the full mesh (every domain healthy
        again)."""
        with self._lock:
            self.generation += 1
            self.restores += 1
            self.current = tuple(range(self.n_devices))
            self.state = FULL
            return {"devices": self.current, "state": self.state,
                    "generation": self.generation}

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "generation": self.generation,
                    "degrades": self.degrades, "restores": self.restores,
                    "devices": list(self.current)}


def reshard_ladder(backend: str, shards: int, *, rungs: int = 1) -> list:
    """The supervisor's re-shard rungs for a sharded backend: the same
    engine rebuilt over one fewer device per rung (``sharded@7``,
    ``sharded@6``, …) — each resumes from the SHARED per-base-backend
    checkpoint namespace (``cli._rung_base``), exact because the sharded
    engines are shard-count-invariant bit-for-bit. ``rungs`` bounds how
    many losses the ladder absorbs before conceding to the single-device
    engines below it."""
    if shards < 2:
        return [backend]
    names = [backend]
    for i in range(1, min(int(rungs), shards - 1) + 1):
        names.append(f"{backend}@{shards - i}")
    return names
