"""Batch scheduler: lane recycling, affinity batching, first-use caches
(port of ``dgc_tpu.serve.engine``, single device).

The front-end (``serve.queue``) runs one ``find_minimal_coloring`` per
request on a worker thread — the exact jump-mode driver the CLI uses, so
attempt sequences, validation and the recolor post-pass are the
single-graph semantics by construction. Each worker's engine is a
:class:`BatchMemberEngine` proxy whose ``sweep(k)`` does not dispatch: it
enqueues the (member, k) call with the :class:`BatchScheduler` and blocks.

Two dispatch modes:

- ``mode="continuous"`` (default) — **lane recycling**: each shape class
  owns a :class:`_LanePool` of at most ``batch_max`` lanes. The dispatcher
  runs one slice (``serve.batched.run_slice`` over the pool's lanes: at
  most ``slice_steps`` batched supersteps on the card), reads the per-lane
  phase/rung/nc back, swaps every done lane's result out and a queued
  request in (``reset`` flag; the slice re-inits the lane from its
  inputs), and re-enters. The pool's width adapts to demand (power-of-two
  pads up to ``batch_max``). ``slice_steps=None`` prices the slice size
  per (class, pool width) (``serve.batched.auto_slice_steps``).
- ``mode="sync"`` — batch-complete dispatch (one whole jump-mode pair per
  batch, ``serve.batched.batched_sweep``), the A/B baseline.

Two carry modes. The **host mirror** (default): between slices the carry
stays on the card as the tensors the kernels return; the input stacks are
uploaded when a swap changed them; the whole carry comes home on a slice
where some lane finished, and for a resize. The **device-resident carry**
(``device_carry=True``, ``--device-carry``, B12f): the carry and the
input stacks live on the card only; a seat uploads one lane's row and
K17 scatters it, a resize moves the kept lanes on the card (K18, K19),
and only the delivered lanes' result slots come home. Either way the
phase/rung/nc scheduling scalars (and ``T_US`` under timing) come home
every slice in one copy. ``h2d``/``d2h`` count the bytes either mode
moves, in the ``serve_slice`` events.

**The speculation plane** (``single_attempt``, ``speculate``,
``speculate_many``, ``claim_speculative``, ``cancel_speculative``;
``serve.speculate``): attempt-only calls carry K16's spec tag (K15 runs
no confirm for them); speculative calls seat only into lanes no real
call wants, after the real wave, and are killed at a slice entry through
K16's cancel vector when cancelled, or preempted (lowest k first) when
real calls need their lanes. The vectors go up only once speculation was
used.

**Affinity batching** rides both modes: pending calls carry a predicted
sweep-depth bucket (the bit length of the budget ``k``), and the scheduler
co-schedules calls of the same bucket so lanes finish together. A
starvation guard falls back to FIFO for any call older than ``50 ×
window_s``.

The reference's "compile cache" hit/miss counts become the first use of a
``(class, b_pad[, slice_steps])`` key here (PyTorch compiles nothing per
shape; the kernels are built once), so the event fields keep their
schema; :meth:`BatchScheduler.warm_class` runs each pad of a class once
before serving.

**The lane mesh** (``mesh_devices``, ``--mesh-devices``; B12g): every
pool's lane axis is split over a ``serve.batched.LaneMesh`` of n shard
slots (lane ``i`` on shard ``i // (b_pad / n)``, each shard its own
tensors and control block), pool widths floored at n, seats placed in the
least-loaded shard, and the slices, seats and resizes run through the
sharded twins (K16/K15 partial per shard, the last to finish folding the
routing in its tail (K26); K17 per
shard with seats; the mesh instances of K18/K19, where kept lanes may
cross shards). ``serve_slice``/``serve_batch`` events carry
``mesh_devices`` and the per-shard ``device_occupancy``. A resolved mesh
of 1 (or none asked for) is the unsharded path, byte for byte.

**The failure-domain plane** (``resilience.domains``): on the mesh, a
dispatch error classified as a device loss (the ``mesh`` fault point's
``device_loss:D`` names shard slot D) marks the slot lost, evacuates every
pool (live calls reseat from their inputs, under the abort accounting)
and rebuilds the mesh over the largest power-of-two set of survivors with
a new generation in every cache key; below two survivors the scheduler
collapses to the unsharded path. ``request_restore`` (after
``device_health.mark_healthy``; ``resilience.probe.HealthProbe`` makes
both calls) rebuilds the full mesh at the dispatcher's next quiet point.
``mesh_degrade``/``mesh_restore`` events and ``mesh_health`` record every
transition.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.base import AttemptResult, empty_budget_failure
from dgc_tpu_torch.kernels import carry as kcar
from dgc_tpu_torch.layout import (CARRY_LEN, CARRY_NC, CARRY_PHASE,
                                  CARRY_RUNG, T_US)
from dgc_tpu_torch.obs.trace import NULL_TRACER
from dgc_tpu_torch.resilience.domains import (DeviceHealth, MeshState,
                                             is_device_loss)
from dgc_tpu_torch.resilience.faults import fault_point
from dgc_tpu_torch.resilience.supervisor import STRUCTURED_ABORT_RC
from dgc_tpu_torch.serve.batched import (DEFAULT_STALL_WINDOW, LaneMesh,
                                         auto_slice_steps, batched_sweep,
                                         batched_sweep_kernel_sharded,
                                         carry_home, carry_nbytes,
                                         finish_pair, idle_carry, is_staged,
                                         lane_mesh, lane_mesh_over,
                                         lane_outputs, lanes_home,
                                         lanes_home_sharded, mesh_device_count,
                                         mesh_lanes, permute_carry,
                                         permute_carry_kernel_sharded,
                                         priced_slice_steps, resize_inputs,
                                         resize_inputs_kernel_sharded,
                                         run_mesh_slice, run_slice,
                                         seat_lane_kernel_sharded, seat_lanes,
                                         sharded_home, slice_lanes,
                                         split_lanes, stage_idx_width)
from dgc_tpu_torch.serve.shape_classes import (dummy_member, pad_ladder,
                                               padding_waste,
                                               stage_schedule_for)

# FIFO takes over affinity ordering for calls older than this many
# batching windows — affinity may reorder, never starve
_STARVE_WINDOWS = 50.0
# a call whose lane aborts this many times is quarantined (the
# poison-request policy)
MAX_LANE_ABORTS = 3
# full slices at the deepest rung before the measured slice size is priced
RECAL_MIN_SLICES = 8
# a class whose last speculative submit or seat is this recent is
# "spec-hot": its pool is kept (no pop at live == 0, no shrink), so the
# next window generation reuses the lanes instead of rebuilding them
_SPEC_IDLE_S = 0.05
# a freshly seated wave of unclaimed speculation only waits up to this
# long for the rest of the window's submits before it slices
_SPEC_COALESCE_S = 500e-6


class ServeError(RuntimeError):
    """A request the serving path cannot complete (engine error after
    fallback, scheduler shut down mid-call)."""


class PoisonedRequest(ServeError):
    """Quarantine verdict: this request's lane aborted
    ``MAX_LANE_ABORTS`` times, so it is structured-failed with rc
    context. Deliberately NOT the generic :class:`ServeError` the
    front end retries on the single-graph fallback."""


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _home(carry, mesh, slots=None) -> tuple:
    """Host copies of a carry's ``slots`` (all by default), whole: one copy
    home (a sharded carry: the shards' rows in order, one copy a
    device)."""
    if mesh is None:
        return carry_home(carry if slots is None else
                          [carry[j] for j in slots])
    return sharded_home(carry if slots is None else
                        [[c[j] for j in slots] for c in carry])


def _nbytes(carry, mesh) -> int:
    """A carry's byte size, whole or sharded."""
    if mesh is None:
        return carry_nbytes(carry)
    return sum(carry_nbytes(c) for c in carry)


def depth_bucket(k: int) -> int:
    """Predicted-sweep-depth affinity key for a budget-``k`` sweep call:
    the bit length of ``k``."""
    return max(1, int(k)).bit_length()


def priority_window(window_s: float, priority: int) -> float:
    """Effective micro-batching window when the highest-priority pending
    call has tier ``priority``: ``window / 2^priority``; priority 0 keeps
    the configured window."""
    if priority <= 0:
        return window_s
    return window_s / (1 << min(int(priority), 6))


class _SweepCall:
    __slots__ = ("member", "k", "depth", "priority", "done", "result",
                 "error", "t_enqueue", "span", "lane_span", "device_us",
                 "aborts", "attempt_only", "speculative", "cancelled",
                 "claimed", "cancel_reason")

    def __init__(self, member, k, span=None, priority=0,
                 attempt_only=False, speculative=False):
        self.member = member
        self.k = int(k)
        self.depth = depth_bucket(k)
        self.priority = max(0, int(priority))
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.t_enqueue = time.perf_counter()
        # lane aborts survived so far; at MAX_LANE_ABORTS the call is
        # quarantined (dispatcher-owned, like lane state)
        self.aborts = 0
        # request-scoped tracing (obs.trace): the sweep span begun at
        # enqueue; the lane span the dispatcher opens when it seats the call
        self.span = span
        self.lane_span = None
        self.device_us = None      # in-kernel superstep µs (timing mode)
        # the speculation plane: an attempt_only lane carries K16's spec
        # tag (no fused confirm, cancellable at slice entries); a
        # speculative call also seats below every real pending call and
        # may be cancelled or preempted before delivery. cancelled,
        # claimed and cancel_reason are checked and set under the
        # scheduler's _lock, where the claim/cancel/preempt races resolve
        self.attempt_only = bool(attempt_only)
        self.speculative = bool(speculative)
        self.cancelled = False       # guarded-by: scheduler._lock
        self.claimed = False         # guarded-by: scheduler._lock
        self.cancel_reason = None    # guarded-by: scheduler._lock


class _LanePool:   # owned by the dispatcher thread
    """One shape class's lane state (continuous mode): the host's copies
    of the small scheduling vectors, the carry (numpy until its first
    slice, then tensors on the device), the kernels' lanes
    (``serve.batched.slice_lanes``, kept from slice to slice: the inputs
    on the device are written into their tensors), and the per-lane call
    bookkeeping. ``h2d``/``d2h`` count the host↔device bytes the pool
    moves.

    Two carry modes:

    - **host mirror** (default): the host keeps the input stacks and
      re-uploads them on a slice where a swap changed them; a resize
      brings the carry home and re-uploads it.
    - **device-resident** (``device_carry=True``, ``--device-carry``): the
      carry and the input stacks live on the device only (no host stack).
      A seat is one lane's row going up once and K17 scattering it
      (``seat_lanes``); a resize moves the kept lanes' carry rows into a
      fresh idle carry built there (K18, ``permute_carry``) and the input
      stacks (K19, ``resize_inputs``; ``dummy_dev``, the class dummy's
      table row on the device, is uploaded by the first pool of the class
      and passed to the next); seats pending at a resize are seated again
      after it.

    ``mesh`` (a ``serve.batched.LaneMesh``) splits the lane axis over its
    shards: the pool width stays a multiple of the mesh size, lane ``i``
    lives on shard ``i // (b_pad / n)``, seats go to the least-loaded
    shard, and every device-side buffer (inputs, vectors, carry, lanes) is
    a per-shard list. ``mesh=None`` is the unsharded pool."""

    __slots__ = ("cls", "b_pad", "comb", "degrees", "k0", "max_steps",
                 "reset", "carry", "calls", "t_fill", "slices_in",
                 "t_seen", "_dev_inputs", "_dev_vecs", "_dirty", "_dummy",
                 "h2d", "d2h", "a_pad", "device", "lanes", "device_carry",
                 "_stacks", "_dummy_dev", "_spec_dev", "mesh", "mesh_n")

    def __init__(self, cls, b_pad: int, dummy, device, a_pad: int = 1,
                 device_carry: bool = False, dummy_dev=None, mesh=None):
        self.cls = cls
        self._dummy = dummy
        self.mesh = mesh
        self.mesh_n = mesh.n if mesh is not None else 1
        self.device = mesh.device if mesh is not None else device
        self.device_carry = bool(device_carry)
        self.a_pad = int(a_pad)   # the class ladder's CARRY_IDX width
        self.b_pad = 0
        self.calls = []
        self.t_fill = []
        self.slices_in = []
        self.h2d = 0
        self.d2h = 0
        self.carry = None
        self._stacks = None       # device carry: comb, degrees, k0, ms, reset
        self._dummy_dev = dummy_dev   # device carry: the dummy's table row
        self._spec_dev = None     # the spec/cancel vectors, int32[2, b_pad]
        self._dirty = []
        self._resize(self._pad(b_pad))

    def _pad(self, n: int) -> int:
        """The pool width that seats ``n`` lanes: the power-of-two pad,
        floored at the mesh size (1 without a mesh)."""
        return max(_pow2_ceil(max(int(n), 1)), self.mesh_n)

    def device_live(self) -> list:
        """Live-lane count per shard (lane ``i`` on shard ``i // (b_pad /
        n)``); a pool without a mesh reports one shard."""
        per = self.b_pad // self.mesh_n
        counts = [0] * self.mesh_n
        for i, c in enumerate(self.calls):
            if c is not None:
                counts[i // per] += 1
        return counts

    def _free_lane(self) -> int:
        """The lane the next seat lands in: the first free lane or, on a
        mesh, the first free lane of the least-loaded shard (ties: the
        lowest shard), so live lanes spread across the shards."""
        if self.mesh is None:
            return self.calls.index(None)
        per = self.b_pad // self.mesh_n
        live = self.device_live()
        for d in sorted(range(self.mesh_n), key=lambda d: (live[d], d)):
            for i in range(d * per, (d + 1) * per):
                if self.calls[i] is None:
                    return i
        raise ValueError("no free lane")

    def _resize(self, b_pad: int) -> None:
        """(Re)allocate at ``b_pad`` lanes, compacting live lanes into the
        low indices (lane identity is per-slice; the call list follows the
        carry rows). Host mirror: a carry on the device comes home for it
        and the input stacks re-upload. Device carry: K18 and K19 move the
        kept lanes on the device, and the seats still pending are
        re-seated by K17 before the next slice."""
        keep = [i for i, c in enumerate(self.calls) if c is not None]
        assert len(keep) <= b_pad, "resize would drop live lanes"
        cls, dummy = self.cls, self._dummy
        old_b = self.b_pad
        k0 = np.ones(b_pad, np.int32)
        max_steps = np.full(b_pad, dummy.max_steps, np.int32)
        reset = np.zeros(b_pad, np.int32)
        calls = [None] * b_pad
        t_fill = [0.0] * b_pad
        slices_in = [0] * b_pad
        t_seen = np.zeros(b_pad, np.int64)
        for new_i, old_i in enumerate(keep):
            k0[new_i] = self.k0[old_i]
            max_steps[new_i] = self.max_steps[old_i]
            reset[new_i] = self.reset[old_i]
            calls[new_i] = self.calls[old_i]
            t_fill[new_i] = self.t_fill[old_i]
            slices_in[new_i] = self.slices_in[old_i]
            t_seen[new_i] = self.t_seen[old_i]
        if self.device_carry:
            self._resize_on_device(keep, old_b, b_pad)
            self.comb = self.degrees = None
            self._dirty = [keep.index(lane) for lane in self._dirty
                           if lane in keep]
        else:
            self._resize_host(keep, b_pad)
            self._dirty = []
        self.b_pad = b_pad
        self.k0, self.max_steps, self.reset = k0, max_steps, reset
        self.calls, self.t_fill, self.slices_in = calls, t_fill, slices_in
        self.t_seen = t_seen
        self._dev_inputs = None
        self._dev_vecs = None
        self.lanes = None   # new lanes: ``nxt`` a copy of the moved packed

    def _resize_host(self, keep: list, b_pad: int) -> None:
        cls, dummy = self.cls, self._dummy
        comb = np.repeat(dummy.comb[None], b_pad, axis=0)
        degrees = np.zeros((b_pad, cls.v_pad), np.int32)
        carry = idle_carry(b_pad, cls.v_pad, self.a_pad)
        if keep:
            if not isinstance(self.carry[0], np.ndarray):
                self.d2h += _nbytes(self.carry, self.mesh)
                old_carry = _home(self.carry, self.mesh)
            else:
                old_carry = self.carry
            for new_i, old_i in enumerate(keep):
                comb[new_i] = self.comb[old_i]
                degrees[new_i] = self.degrees[old_i]
                for j in range(CARRY_LEN):
                    carry[j][new_i] = old_carry[j][old_i]
        self.comb, self.degrees, self.carry = comb, degrees, carry

    def _resize_on_device(self, keep: list, old_b: int, b_pad: int) -> None:
        cls, device, mesh = self.cls, self.device, self.mesh
        if self._dummy_dev is None:
            self._dummy_dev = torch.from_numpy(self._dummy.comb).to(
                device, copy=True)
            self.h2d += self._dummy.comb.nbytes
        if self._stacks is None:   # the first allocation: from no lanes
            w = self._dummy.comb.shape[-1]

            def empty(d):
                return (tuple(torch.empty(shape, dtype=torch.int32, device=d)
                              for shape in ((0, cls.v_pad, w), (0, cls.v_pad),
                                            (0,), (0,), (0,))),
                        [torch.empty(kcar.slot_shape(j, 0, cls.v_pad,
                                                     self.a_pad),
                                     dtype=torch.int32, device=d)
                         for j in range(CARRY_LEN)])
            if mesh is None:
                self._stacks, self.carry = empty(device)
            else:
                parts = [empty(d) for d in mesh.devices]
                self._stacks = [p[0] for p in parts]
                self.carry = [p[1] for p in parts]
        src = keep + [old_b] * (b_pad - len(keep))   # past old_b: the dummy
        if mesh is None:
            self._stacks = resize_inputs(self._stacks, src, self._dummy_dev,
                                         self._dummy.max_steps)
            self.carry = permute_carry(self.carry, keep, b_pad)
        else:
            # kept lanes compact to the front: a lane may cross shards
            self._stacks = resize_inputs_kernel_sharded(
                mesh, self._stacks, src, self._dummy_dev,
                self._dummy.max_steps)
            self.carry = permute_carry_kernel_sharded(
                mesh, self.carry, keep, list(range(len(keep))), b_pad)
        self.h2d += 2 * b_pad * 4   # K19's source list and K18's row map

    @property
    def live(self) -> int:
        return sum(1 for c in self.calls if c is not None)

    def live_depths(self) -> list:
        return [c.depth for c in self.calls if c is not None]

    def reserve(self, n: int) -> None:
        """Grow ONCE to fit ``n`` more seats."""
        need = self.live + n
        if need > self.b_pad:
            self._resize(self._pad(need))

    def fill(self, call: _SweepCall) -> int:
        """Seat ``call`` in the first free lane (growing the pool if every
        lane is taken); the slice re-inits the lane from its inputs
        (``reset``), written into the host mirror here or, with the
        device carry, scattered by K17 before the slice
        (:meth:`dev_state`)."""
        try:
            lane = self._free_lane()
        except ValueError:
            self._resize(self.b_pad * 2)
            lane = self._free_lane()
        m = call.member
        if not self.device_carry:
            self.comb[lane] = m.comb
            self.degrees[lane] = m.degrees
        self.k0[lane] = call.k
        self.max_steps[lane] = m.max_steps
        self.reset[lane] = 1
        self.calls[lane] = call
        self.t_fill[lane] = time.perf_counter()
        self.slices_in[lane] = 0
        self.t_seen[lane] = 0   # reset re-zeroes the lane's timing slot
        self._dirty.append(lane)
        return lane

    def dev_inputs(self):
        """Host mirror: the (comb, degrees) copies on the device,
        re-uploaded only on slices where a swap (or resize) changed the
        host mirror; after the first, into the same tensors."""
        if self._dev_inputs is None:
            self._dev_inputs = tuple(
                torch.from_numpy(a).to(self.device, copy=True)
                if self.mesh is None else split_lanes(a, self.mesh)
                for a in (self.comb, self.degrees))
        elif self._dirty:
            for dev, a in zip(self._dev_inputs, (self.comb, self.degrees)):
                if self.mesh is None:
                    dev.copy_(torch.from_numpy(a))
                else:
                    per = self.b_pad // self.mesh_n
                    for i, t in enumerate(dev):
                        t.copy_(torch.from_numpy(a[i * per:(i + 1) * per]))
        else:
            return self._dev_inputs
        self.h2d += self.comb.nbytes + self.degrees.nbytes
        self._dirty = []
        return self._dev_inputs

    def dev_vecs(self):
        """Host mirror: the scheduling vectors (k0, max_steps, reset) on
        the device, one int32[3, b_pad] tensor written every slice (on a
        mesh one int32[3, b_pad / n] a shard); returns the three."""
        self._dev_vecs = self._put_rows(
            np.stack([self.k0, self.max_steps, self.reset]), self._dev_vecs)
        self.h2d += self.k0.nbytes + self.max_steps.nbytes + self.reset.nbytes
        if self.mesh is None:
            return tuple(self._dev_vecs)
        return tuple([t[r] for t in self._dev_vecs] for r in range(3))

    def _put_rows(self, host: np.ndarray, dev):
        """``host`` (int32[k, b_pad]) into its copy on the device ``dev``,
        made anew when None or of another width: one tensor, or on a mesh
        one int32[k, b_pad / n] a shard. Returns the copy."""
        host = torch.from_numpy(host)
        if self.mesh is None:
            if dev is None or dev.shape[1] != self.b_pad:
                return host.to(self.device, copy=True)
            dev.copy_(host)
            return dev
        per = self.b_pad // self.mesh_n
        parts = [host[:, i * per:(i + 1) * per] for i in range(self.mesh_n)]
        if dev is None or dev[0].shape[1] != per:
            return [x.to(d, copy=True).contiguous()
                    for x, d in zip(parts, self.mesh.devices)]
        for t, x in zip(dev, parts):
            t.copy_(x)
        return dev

    def dev_state(self):
        """Device carry: the resident ``(comb, degrees, k0, max_steps,
        reset)``, the lanes seated since the last slice scattered in by
        one K17 launch (each seat's rows go up once)."""
        if self._dirty:
            seats = [(lane, self.calls[lane].member.comb,
                      self.calls[lane].member.degrees, int(self.k0[lane]),
                      int(self.max_steps[lane])) for lane in self._dirty]
            if self.mesh is None:
                self.h2d += seat_lanes(self._stacks, seats)
            else:   # one K17 a shard with seats in the wave
                self.h2d += seat_lane_kernel_sharded(self.mesh, self._stacks,
                                                     seats)
            self._dirty = []
        return self._stacks

    def arm(self, spec: np.ndarray, cancel: np.ndarray) -> None:
        """The slice's speculation vectors into the lanes' spec/cancel
        tensors (one copy up)."""
        self._spec_dev = self._put_rows(np.stack([spec, cancel]),
                                        self._spec_dev)
        if self.mesh is None:
            self.lanes.arm_spec(self._spec_dev[0], self._spec_dev[1])
        else:
            for L, t in zip(self.lanes.shards, self._spec_dev):
                L.arm_spec(t[0], t[1])
        self.h2d += spec.nbytes + cancel.nbytes

    def rearm(self, carry) -> None:
        """Post-slice bookkeeping: adopt the advanced carry and lower every
        reset flag (the device carry's on the device: no transfer)."""
        self.carry = carry
        self.reset[:] = 0
        if self.device_carry:
            for stacks in ([self._stacks] if self.mesh is None
                           else self._stacks):
                stacks[4].zero_()

    def maybe_shrink(self) -> None:
        """Shrink to the live set's power-of-two pad as soon as a pad
        boundary is crossed (the caller skips this while the class still
        has queued work)."""
        target = self._pad(max(self.live, 1))
        if target < self.b_pad:
            self._resize(target)


class BatchScheduler:
    """Groups concurrent sweep calls by shape class; dispatches them as
    recycled lane slices (continuous mode) or whole-pair batches (sync
    mode) — see the module docstring.

    ``window_s`` is the micro-batching window: a class with pending calls
    but no live lanes waits up to the window for more of the same class
    (or ``batch_max``) before first dispatch. ``on_batch(record)``
    observes every sync dispatch and ``on_event(kind, record)`` every
    continuous slice / lane swap. ``device``: where the kernels run
    (default the card). ``device_carry``: the device-resident carry
    (continuous mode; :class:`_LanePool`). ``mesh_devices``: the lane mesh
    (module docstring): ``"auto"`` or a count of ``device``'s kind
    (``serve.batched.mesh_device_count``), or a ``LaneMesh``
    (``lane_mesh_over``: an explicit slot list, several slots on one card);
    None, or a resolved size of 1, keeps the unsharded path."""

    def __init__(self, *, batch_max: int = 8, window_s: float = 0.002,
                 mode: str = "continuous", slice_steps: int | None = None,
                 affinity: bool = True, timing: bool = False,
                 stages="auto", device_carry: bool = False,
                 mesh_devices=None,
                 on_batch=None, on_event=None, tracer=None,
                 device="cuda"):
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        if mode not in ("continuous", "sync"):
            raise ValueError(f"mode must be continuous|sync, got {mode!r}")
        if slice_steps is not None and int(slice_steps) < 1:
            raise ValueError(
                f"slice_steps must be >= 1 or None (auto), got {slice_steps}")
        if not (stages in ("auto", "off") or isinstance(stages, tuple)):
            raise ValueError(
                f"stages must be 'auto', 'off', or a stage ladder tuple, "
                f"got {stages!r}")
        self.device = resolve_device(device)
        self.platform = "gpu" if self.device.type == "cuda" else "cpu"
        self.batch_max = int(batch_max)
        self.window_s = float(window_s)
        self.mode = mode
        self.slice_steps = None if slice_steps is None else int(slice_steps)
        self.affinity = bool(affinity)
        # staged frontier ladder: "auto" derives each class's ladder
        # (engine.compact.class_stage_schedule), "off" runs the full
        # table, an explicit ladder applies to every class
        self.stages = stages
        # the device-resident carry (continuous mode): seats through K17,
        # resizes through K18/K19, only done lanes' result slots home
        self.device_carry = bool(device_carry)
        # the lane mesh and its failure-domain plane; mesh and
        # mesh_devices are reshaped by degrade/restore on the dispatcher
        # thread only (other threads read them for display). Without a
        # mesh (None, or a resolved size of 1) all of it stays off: the
        # unsharded path, its cache keys and its event stream
        self.mesh = None               # guarded-by: dispatcher
        self.mesh_devices = 0          # guarded-by: dispatcher
        self._mesh_all = []            # guarded-by: init
        self.device_health = None
        self._mesh_state = None
        self._mesh_gen = 0             # guarded-by: dispatcher
        self._restore_requested = False   # guarded-by: _lock
        if mesh_devices is not None:
            if isinstance(mesh_devices, LaneMesh):
                mesh = mesh_devices
                if mesh.device.type != self.device.type:
                    raise ValueError(f"the lane mesh lies on {mesh.device}, "
                                     f"the scheduler on {self.device}")
            else:
                n = mesh_device_count(mesh_devices, self.device)
                mesh = lane_mesh(n, self.device) if n > 1 else None
            if mesh is not None and mesh.n > 1:
                self.mesh = mesh
                self.mesh_devices = mesh.n
                self._mesh_all = list(mesh.devices)
                self.device_health = DeviceHealth(mesh.n)
                self._mesh_state = MeshState(mesh.n)
        # the configured mesh size (a degrade goes below it, a restore
        # returns to it); 0 = never sharded
        self.mesh_devices0 = self.mesh_devices
        # per-shard live lanes summed over the dispatches, and the lane
        # slices they were counted over (mesh_snapshot's mean occupancy)
        self._dev_live_sum = [0] * max(1, self.mesh_devices)  # guarded-by: _lock
        self._dev_live_n = 0       # guarded-by: _lock
        # in-kernel timing (obs.devclock): splits slice wall time into
        # superstep compute vs dispatch overhead and, with slice_steps
        # auto, re-prices the slice size ONCE per class from the measured
        # split after RECAL_MIN_SLICES full slices at the deepest rung
        self.timing = bool(timing)
        self.on_batch = on_batch
        self.on_event = on_event
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the Condition wraps an RLock, so guarded sections nest freely
        self._lock = threading.Condition()
        self._pending: dict = {}   # class -> [_SweepCall]; guarded-by: _lock
        # the speculation plane: pending speculative calls, seated only
        # into capacity left after every real pending call; _spec_used
        # flips once, at the first speculative or attempt-only call, and
        # from then on the slices carry the spec/cancel vectors (all-zero
        # vectors change nothing, so running lanes stay exact across it)
        self._spec_pending: dict = {}  # class -> [_SweepCall]; guarded-by: _lock
        self._spec_used = False        # guarded-by: _lock (sticky)
        # the last speculative submit or seat of each class (_spec_hot)
        self._spec_last: dict = {}     # class -> perf_counter s; guarded-by: _lock
        self._kernels: dict = {}   # first-use key -> fn; guarded-by: _lock
        self._dummies: dict = {}   # class -> ServeMember; guarded-by: _lock
        self._class_stages: dict = {}  # class -> stages|None; guarded-by: _lock
        self._pools: dict = {}     # class -> _LanePool; guarded-by: dispatcher
        # device carry: each class's dummy table row on the device, kept
        # across the class's pools
        self._dummy_rows: dict = {}   # class -> tensor; guarded-by: dispatcher
        self._timing_acc: dict = {}  # cls -> window dict; guarded-by: dispatcher
        self._recal: dict = {}     # cls -> slice_steps; guarded-by: _lock
        self._stop = False         # guarded-by: _lock
        self._thread = None        # guarded-by: owner
        self.stats = {"batches": 0, "sweeps": 0, "compile_hits": 0,
                      "compile_misses": 0, "slices": 0, "recycles": 0,
                      "max_live": 0, "recals": 0,
                      "h2d_bytes": 0, "d2h_bytes": 0,
                      "rebuilds": 0, "quarantined": 0,
                      # the failure-domain plane: mesh degrades and
                      # restores, and the live lanes reseated across them
                      "mesh_degrades": 0, "mesh_restores": 0,
                      "lanes_evacuated": 0,
                      # the speculation plane: seated, cancelled and
                      # preempted speculative attempts, claims, and the
                      # supersteps killed lanes burned
                      "spec_seated": 0, "spec_cancelled": 0,
                      "spec_preempted": 0, "spec_wins": 0,
                      "spec_wasted_steps": 0}   # guarded-by: _lock

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "BatchScheduler":
        if self._thread is None:
            target = (self._loop_continuous if self.mode == "continuous"
                      else self._loop_sync)
            self._thread = threading.Thread(target=target, daemon=True,
                                            name="dgc-serve-batcher")
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # calls stranded by shutdown fail loudly — pending AND in-lane
        # (the dispatcher has exited; pools are safe to touch)
        with self._lock:
            stranded = [c for calls in self._pending.values() for c in calls]
            self._pending.clear()
            stranded.extend(c for calls in self._spec_pending.values()
                            for c in calls)
            self._spec_pending.clear()
        for pool in self._pools.values():
            stranded.extend(c for c in pool.calls if c is not None)
        self._pools.clear()
        for call in stranded:
            if call.lane_span is not None:
                call.lane_span.end({"error": "scheduler stopped"})
            call.error = ServeError("batch scheduler stopped")
            call.done.set()

    # -- submission (worker threads) ------------------------------------
    def sweep(self, member, k: int, priority: int = 0):
        """Blocking batched sweep: returns the raw per-member outputs
        ``(p1, s1, st1, used, p2, s2, st2)`` (host arrays and ints). The
        sweep span brackets enqueue through delivery; the dispatcher opens
        a child ``lane`` span per seating."""
        span = self.tracer.begin("sweep", attrs={"k": int(k),
                                                 "cls": member.cls.name})
        return self._submit(_SweepCall(member, k, span=span,
                                       priority=priority))

    def _submit(self, call: _SweepCall, spec_used: bool = False):
        """Queue a real call, block until it is delivered and return its
        raw outputs; its span ends with the device time or the error.
        ``spec_used`` marks the speculation plane used (the spec tag must
        then reach the kernels)."""
        span = call.span
        try:
            with self._lock:
                if self._stop:
                    raise ServeError("batch scheduler stopped")
                if spec_used:
                    self._spec_used = True
                self._pending.setdefault(call.member.cls, []).append(call)
                self._lock.notify_all()
            call.done.wait()
            if call.error is not None:
                raise call.error
        except BaseException as e:
            span.end({"error": f"{type(e).__name__}: {e}"})
            raise
        span.end({"device_us": call.device_us}
                 if call.device_us is not None else None)
        return call.result

    # -- speculation plane ------------------------------------------------
    # The outer k-loop's attempts at different budgets are independent, so
    # a minimal-k driver (serve.speculate.SpeculativeMinimalKEngine) seats
    # a window of candidate budgets into lanes the real traffic is not
    # using and claims each exactly when the sequential schedule would
    # have run it: the stopping rule and every byte of output are the
    # sequential driver's, because each attempt is deterministic in
    # (member, k) and claims happen in the sequential order. Losers are
    # killed at slice entries through K16's cancel vector; real pending
    # calls preempt unclaimed speculative lanes (lowest k first).

    def single_attempt(self, member, k: int, priority: int = 0):
        """Blocking batched single attempt (no fused confirm): returns the
        raw per-member outputs, of which only the attempt-1 slots ``(p1,
        s1, st1)`` mean anything. Continuous mode runs it as an
        attempt-only lane (the spec tag skips the confirm); sync mode runs
        the full pair and the caller discards the confirm."""
        span = self.tracer.begin("attempt", attrs={"k": int(k),
                                                   "cls": member.cls.name})
        return self._submit(_SweepCall(
            member, k, span=span, priority=priority,
            attempt_only=(self.mode == "continuous")), spec_used=True)

    def speculate(self, member, k: int, priority: int = 0):
        """Enqueue one speculative attempt-only call (non-blocking): the
        handle for :meth:`claim_speculative` / :meth:`cancel_speculative`,
        or None where speculation cannot help (sync mode, ``k`` below 1,
        the scheduler stopping). It seats only into capacity no real
        pending call wants."""
        if self.mode != "continuous" or k < 1:
            return None
        call = _SweepCall(member, k, priority=priority,
                          attempt_only=True, speculative=True)
        with self._lock:
            if self._stop:
                return None
            self._spec_used = True
            self._spec_pending.setdefault(member.cls, []).append(call)
            self._spec_last[member.cls] = time.perf_counter()
            self._lock.notify_all()
        return call

    def speculate_many(self, member, ks, priority: int = 0):
        """Enqueue a whole speculative window at once (one lock hold, one
        wakeup): one handle per budget, None where :meth:`speculate` would
        return None."""
        if self.mode != "continuous":
            return [None for _ in ks]
        calls = [
            _SweepCall(member, k, priority=priority,
                       attempt_only=True, speculative=True)
            if k >= 1 else None
            for k in ks
        ]
        with self._lock:
            if self._stop:
                return [None for _ in ks]
            live = [c for c in calls if c is not None]
            if live:
                self._spec_used = True
                self._spec_pending.setdefault(member.cls, []).extend(live)
                self._spec_last[member.cls] = time.perf_counter()
                self._lock.notify_all()
        return calls

    def _spec_hot(self, cls) -> bool:
        """Speculative activity on this class within the keep-warm
        horizon? A lock-free read of one float (a stale read costs one
        extra pool rebuild or one extra warm pool)."""
        return (time.perf_counter()
                - self._spec_last.get(cls, float("-inf")) < _SPEC_IDLE_S)

    def claim_speculative(self, call):
        """Adopt a speculative call as the driver's real next attempt:
        block until its result lands and return the raw outputs (as
        :meth:`single_attempt`), or None when it was cancelled or
        preempted before the claim (the caller then runs the attempt for
        real). A claimed call still waiting to seat moves to the head of
        the real queue."""
        with self._lock:
            if call.cancelled:
                return None
            call.claimed = True
            ready = call.done.is_set()
            lst = self._spec_pending.get(call.member.cls)
            if lst is not None and call in lst:
                lst.remove(call)
                if not lst:
                    self._spec_pending.pop(call.member.cls, None)
                self._pending.setdefault(call.member.cls, [])[:0] = [call]
                self._lock.notify_all()
        call.done.wait()
        if call.error is not None:
            raise call.error
        with self._lock:
            self.stats["spec_wins"] += 1
        if self.on_event is not None:
            self.on_event("spec_win", {
                "shape_class": call.member.cls.name, "k": call.k,
                "ready": bool(ready),
            })
        return call.result

    def cancel_speculative(self, call, reason: str = "superseded") -> None:
        """Cancel a speculative call the driver will never claim: dropped
        from the speculative queue at once, killed at its lane's next
        slice entry when seated (its lane freed), or its parked result
        dropped when delivered. Claimed or cancelled calls are left
        alone."""
        if call is None:
            return
        with self._lock:
            if call.cancelled or call.claimed:
                return
            call.cancelled = True
            call.cancel_reason = reason
            self.stats["spec_cancelled"] += 1
            where = "lane"
            lst = self._spec_pending.get(call.member.cls)
            if lst is not None and call in lst:
                lst.remove(call)
                if not lst:
                    self._spec_pending.pop(call.member.cls, None)
                where = "queue"
            elif call.done.is_set():
                where = "done"
                # the whole attempt ran for nothing: charge its steps
                self.stats["spec_wasted_steps"] += int(call.result[1])
        if self.on_event is not None and where != "lane":
            # a seated call's spec_cancelled comes from the dispatcher at
            # kill time (with its wasted supersteps)
            self.on_event("spec_cancelled", {
                "shape_class": call.member.cls.name, "k": call.k,
                "reason": reason, "where": where,
            })

    # -- warmup ---------------------------------------------------------
    def warm_class(self, cls) -> dict:
        """Run a class's kernels once at every power-of-two pad the pool
        can visit (up to ``batch_max``) on all-dummy lanes, so the first
        use of each lands here (on the card: the kernels' build and load)
        instead of in first-batch latency. Returns ``{"kernels",
        "stage_bodies", "seconds"}``."""
        with self._lock:
            dummy = self._dummies.get(cls)
            if dummy is None:
                dummy = self._dummies[cls] = dummy_member(cls)
        t0 = time.perf_counter()
        warmed = 0
        for b in pad_ladder(self.batch_max,
                            min_pad=max(1, self.mesh_devices)):
            comb = np.repeat(dummy.comb[None], b, axis=0)
            degrees = np.zeros((b, cls.v_pad), np.int32)
            k0 = np.ones(b, np.int32)
            max_steps = np.full(b, dummy.max_steps, np.int32)
            if self.mode == "continuous":
                kernel, _ = self._slice_kernel_for(cls, b)
                carry = kernel(self._lanes_for(
                    cls, comb, degrees, k0, max_steps, np.ones(b, np.int32),
                    idle_carry(b, cls.v_pad,
                               stage_idx_width(self.stages_for(cls)))))
                _home(carry, self.mesh, [CARRY_PHASE])
            else:
                kernel, _ = self._kernel_for(cls, b)
                out = kernel(comb, degrees, k0, max_steps)
                _home(out, self.mesh)
            warmed += 1
        stages = self.stages_for(cls)
        return {"kernels": warmed,
                "stage_bodies": len(stages) if stages else 1,
                "seconds": time.perf_counter() - t0}

    # -- affinity -------------------------------------------------------
    def _affinity_order(self, calls: list, live_depths: list) -> list:
        """Order a class's pending calls for seating: priority tier first,
        then same-depth-bucket calls together (nearest the live lanes'
        median bucket first in continuous mode; largest group first when
        the pool is empty), FIFO within a bucket, and strict FIFO for
        anything waiting past the starvation guard."""
        if not self.affinity or len(calls) <= 1:
            return list(calls)
        now = time.perf_counter()
        guard = _STARVE_WINDOWS * max(self.window_s, 1e-3)
        starving = [c for c in calls if now - c.t_enqueue > guard]
        if starving:
            return sorted(calls, key=lambda c: c.t_enqueue)
        if live_depths:
            target = sorted(live_depths)[len(live_depths) // 2]
            key = lambda c: (-c.priority, abs(c.depth - target), c.depth,
                             c.t_enqueue)
        else:
            groups: dict = {}
            for c in calls:
                groups[c.depth] = groups.get(c.depth, 0) + 1
            key = lambda c: (-c.priority, -groups[c.depth], c.depth,
                             c.t_enqueue)
        return sorted(calls, key=key)

    def stats_snapshot(self) -> dict:
        """Locked copy of the live counters."""
        with self._lock:
            return dict(self.stats)

    def mesh_snapshot(self) -> dict | None:
        """The lane mesh's size and each shard's mean live-lane occupancy
        over every dispatched slice or batch (sliced to the current mesh
        size), or None without a mesh."""
        if self.mesh is None:
            return None
        with self._lock:
            n = self._dev_live_n
            sums = list(self._dev_live_sum[:self.mesh_devices])
        return {"mesh_devices": self.mesh_devices,
                "device_occupancy": [round(s / n, 4) if n else 0.0
                                     for s in sums]}

    def mesh_health(self) -> dict | None:
        """The failure-domain health document (None when the lane axis was
        never sharded): configured and surviving shard slots, the degraded
        flag, each slot's state and the transition counts. Safe from any
        thread."""
        if self.device_health is None:
            return None
        snap = self.device_health.snapshot()
        surviving = sum(1 for s in snap["devices"] if s == "healthy")
        with self._lock:
            degrades = self.stats["mesh_degrades"]
            restores = self.stats["mesh_restores"]
        return {"devices_total": int(self.mesh_devices0),
                "devices_surviving": int(surviving),
                "mesh_devices": int(max(1, self.mesh_devices)),
                "degraded": bool(self.mesh_devices < self.mesh_devices0),
                "degrades": int(degrades), "restores": int(restores),
                "devices": snap["devices"]}

    def slot_device(self, slot: int):
        """The device shard slot ``slot`` of the configured mesh lies on
        (None out of range or without a mesh): what the restore probe
        runs its canary on."""
        return self._mesh_all[slot] if 0 <= slot < len(self._mesh_all) \
            else None

    def request_restore(self) -> None:
        """Arm the restore: once every lost slot is marked healthy again
        (``device_health.mark_healthy``), the dispatcher rebuilds the full
        mesh at its next quiet point, evacuating live lanes onto it. A
        request made while slots are still lost is dropped. No-op without
        a mesh."""
        if self.device_health is None:
            return
        with self._lock:
            self._restore_requested = True
            self._lock.notify_all()

    # -- stage-ladder resolution ----------------------------------------
    def stages_for(self, cls):
        """The staged-frontier-ladder schedule of ``cls`` (None = the full
        table): an explicit ladder / "off" override, else the
        engine-derived default (``shape_classes.stage_schedule_for``).
        Cached per class; part of every kernel key."""
        if self.stages == "off":
            return None
        if isinstance(self.stages, tuple):
            return stage_schedule_for(cls, self.stages)
        with self._lock:
            if cls in self._class_stages:
                return self._class_stages[cls]
        st = stage_schedule_for(cls, "auto")
        with self._lock:
            self._class_stages[cls] = st
        return st

    # -- first-use caches -----------------------------------------------
    def _kernel_for(self, cls, b_pad: int):
        stages = self.stages_for(cls)
        key = ("sync", cls.v_pad, cls.w_pad, cls.planes, b_pad, stages)
        mesh = self.mesh
        if mesh is not None:
            # the generation tells apart same-size meshes over other
            # survivor sets across degrades and restores
            key += ("mesh", self.mesh_devices, self._mesh_gen)
        with self._lock:
            hit = key in self._kernels
            if not hit:
                if mesh is not None:
                    self._kernels[key] = \
                        lambda *a: batched_sweep_kernel_sharded(
                            mesh, *a, planes=cls.planes,
                            stall_window=DEFAULT_STALL_WINDOW, stages=stages)
                else:
                    self._kernels[key] = lambda *a: batched_sweep(
                        *a, planes=cls.planes,
                        stall_window=DEFAULT_STALL_WINDOW, stages=stages,
                        device=self.device)
                self.stats["compile_misses"] += 1
            else:
                self.stats["compile_hits"] += 1
            return self._kernels[key], hit

    def _slice_kernel_for(self, cls, b_pad: int):
        s = self.resolved_slice_steps(cls, b_pad)
        stages = self.stages_for(cls)
        key = ("slice", cls.v_pad, cls.w_pad, cls.planes, b_pad, s,
               self.timing, stages)
        run = run_slice
        if self.mesh is not None:
            key += ("mesh", self.mesh_devices, self._mesh_gen)
            run = run_mesh_slice
        with self._lock:
            hit = key in self._kernels
            if not hit:
                self._kernels[key] = lambda lanes: run(
                    lanes, slice_steps=s, staged=is_staged(stages),
                    timing=self.timing)
                self.stats["compile_misses"] += 1
            else:
                self.stats["compile_hits"] += 1
            return self._kernels[key], hit

    def _lanes_for(self, cls, comb, degrees, k0, max_steps, reset, carry):
        """The kernels' lanes of a pool of ``cls`` (``slice_lanes``; on the
        mesh ``mesh_lanes``, the inputs whole or per shard)."""
        if self.mesh is not None:
            return mesh_lanes(self.mesh, comb, degrees, k0, max_steps, reset,
                              carry, planes=cls.planes,
                              stall_window=DEFAULT_STALL_WINDOW,
                              stages=self.stages_for(cls))
        return slice_lanes(comb, degrees, k0, max_steps, reset, carry,
                           planes=cls.planes,
                           stall_window=DEFAULT_STALL_WINDOW,
                           stages=self.stages_for(cls), device=self.device)

    def resolved_slice_steps(self, cls, b_pad: int) -> int:
        if self.slice_steps is not None:
            return self.slice_steps
        with self._lock:
            recal = self._recal.get(cls)
        if recal is not None:
            return recal
        return auto_slice_steps(cls.entries(), b_pad, self.platform)

    def _timing_sample(self, cls, overhead_s: float, iter_s: float,
                       rung: int = 0) -> None:
        """One full slice's measured (dispatch overhead, per-superstep
        seconds) at ladder rung ``rung``; after ``RECAL_MIN_SLICES``
        samples at the deepest rung seen, the class's slice size is
        re-priced ONCE from the MEDIAN of that window (slice_steps auto
        only). The window restarts whenever a deeper rung appears and
        shallower late samples are skipped."""
        acc = self._timing_acc.setdefault(
            cls, {"rung": -1, "ovh": [], "it": []})
        if rung > acc["rung"]:
            acc["rung"] = rung
            acc["ovh"] = []
            acc["it"] = []
        elif rung < acc["rung"]:
            return   # a recycled lane dragged the pool back up-ladder
        acc["ovh"].append(overhead_s)
        acc["it"].append(iter_s)
        n = len(acc["it"])
        with self._lock:
            done = (self.slice_steps is not None or cls in self._recal
                    or n < RECAL_MIN_SLICES)
        if done:
            return
        import statistics

        overhead = statistics.median(acc["ovh"])
        iter_med = statistics.median(acc["it"])
        s_new = priced_slice_steps(overhead, iter_med)
        s_old = auto_slice_steps(cls.entries(),
                                 self._pools[cls].b_pad
                                 if cls in self._pools else 1, self.platform)
        with self._lock:
            self._recal[cls] = s_new
        if s_new != s_old:
            with self._lock:
                self.stats["recals"] += 1
            if self.on_event is not None:
                self.on_event("slice_recalibrated", {
                    "shape_class": cls.name, "from_steps": int(s_old),
                    "to_steps": int(s_new),
                    "overhead_ms": round(overhead * 1e3, 3),
                    "sstep_ms": round(iter_med * 1e3, 3),
                    "samples": int(n), "rung": int(acc["rung"]),
                })

    # -- fault plane: quarantine and rebuild -------------------------------
    def _quarantine(self, call, error) -> None:
        """Poison-request policy: structured-fail one call with rc
        context after its lane abort budget is spent."""
        if call.lane_span is not None:
            call.lane_span.end({"error": "quarantined"})
            call.lane_span = None
        call.error = PoisonedRequest(
            f"request quarantined after {call.aborts} lane aborts "
            f"(rc {STRUCTURED_ABORT_RC}): {type(error).__name__}: {error}")
        call.done.set()
        with self._lock:
            self.stats["quarantined"] += 1

    def _evacuate_pool(self, cls, error):
        """Tear one class's pool down and requeue its live calls at the
        queue head (a deterministic re-run from their inputs). With an
        ``error`` each is charged one lane abort and quarantined past its
        budget; ``error=None`` is a voluntary evacuation (a mesh restore):
        no charge. Returns ``(survivors, poisoned, aborts_max)``."""
        pool = self._pools.pop(cls, None)
        survivors, poisoned = [], []
        aborts_max = 0
        for call in (pool.calls if pool is not None else []):
            if call is None:
                continue
            if call.speculative and not call.claimed:
                # unclaimed speculation is dropped with the pool (no abort
                # charge, no requeue: its claim sees it cancelled and runs
                # the attempt for real); a claimed one is the driver's
                # next attempt and is requeued as any call
                with self._lock:
                    if not call.cancelled:
                        call.cancelled = True
                        call.cancel_reason = "evacuated"
                        self.stats["spec_cancelled"] += 1
                    reason = call.cancel_reason
                call.done.set()
                if self.on_event is not None:
                    self.on_event("spec_cancelled", {
                        "shape_class": cls.name, "k": call.k,
                        "reason": reason, "where": "lane",
                    })
                continue
            if error is not None:
                call.aborts += 1
            aborts_max = max(aborts_max, call.aborts)
            if call.lane_span is not None:
                call.lane_span.end(
                    {"error": f"lane aborted: {error}"} if error is not None
                    else {"error": "lane evacuated (mesh reshape)"})
                call.lane_span = None
            (poisoned if error is not None
             and call.aborts >= MAX_LANE_ABORTS else survivors).append(call)
        for call in poisoned:
            call.error = PoisonedRequest(
                f"request quarantined after {call.aborts} lane aborts "
                f"(rc {STRUCTURED_ABORT_RC}): "
                f"{type(error).__name__}: {error}")
            call.done.set()
        with self._lock:
            if survivors:
                self._pending.setdefault(cls, [])[:0] = survivors
            self.stats["quarantined"] += len(poisoned)
            self._lock.notify_all()
        return survivors, poisoned, aborts_max

    def _recover_class(self, cls, error) -> None:
        """Dispatch failure recovery: tear the class's pool down,
        quarantine calls past their abort budget, reseat the survivors,
        emit ``lane_rebuild``."""
        survivors, poisoned, aborts_max = self._evacuate_pool(cls, error)
        with self._lock:
            self.stats["rebuilds"] += 1
        if self.on_event is not None:
            self.on_event("lane_rebuild", {
                "shape_class": cls.name,
                "reason": "abort",
                "reseated": len(survivors),
                "quarantined": len(poisoned),
                "aborts_max": int(aborts_max),
                "error": f"{type(error).__name__}: {error}"[:300],
            })

    # -- failure-domain plane: mesh degrade and restore -------------------
    def _degrade_mesh(self, error, sync_batch=None) -> None:
        """Device-loss recovery: mark the lost slot in the health model,
        tear every pool down (their buffers span the lost slot), reseat
        live calls under the abort accounting, and rebuild over the
        largest power-of-two set of survivors (a new generation in every
        cache key); below two survivors the unsharded path
        (``mesh=None``). ``sync_batch=(cls, calls)`` carries sync mode's
        in-flight batch through the same accounting. Dispatcher thread
        only."""
        before = max(1, self.mesh_devices)
        dev = getattr(error, "device", None)
        if dev is None or not (0 <= int(dev) < self.mesh_devices0):
            # an anonymous loss: blame the highest-index survivor (the
            # degrade shape depends on the survivor count only)
            surv = self.device_health.surviving()
            dev = surv[-1] if surv else 0
        dev = int(dev)
        self.device_health.mark_lost(dev)
        reseated = quarantined = 0
        for cls in sorted(list(self._pools), key=lambda c: c.name):
            s_, p_, _ = self._evacuate_pool(cls, error)
            reseated += len(s_)
            quarantined += len(p_)
        if sync_batch is not None:
            cls, calls = sync_batch
            survivors = []
            for call in calls:
                call.aborts += 1
                if call.aborts >= MAX_LANE_ABORTS:
                    self._quarantine(call, error)
                    quarantined += 1
                else:
                    survivors.append(call)
            with self._lock:
                if survivors:
                    self._pending.setdefault(cls, [])[:0] = survivors
                self._lock.notify_all()
            reseated += len(survivors)
        plan = self._mesh_state.on_loss(self.device_health.surviving())
        if len(plan["devices"]) >= 2:
            self.mesh = lane_mesh_over(
                [self._mesh_all[i] for i in plan["devices"]])
            self.mesh_devices = len(plan["devices"])
        else:
            self.mesh = None
            self.mesh_devices = 0
        self._mesh_gen = plan["generation"]
        with self._lock:
            self.stats["mesh_degrades"] += 1
            self.stats["lanes_evacuated"] += reseated
        if self.on_event is not None:
            self.on_event("mesh_degrade", {
                "devices_before": int(before),
                "devices_after": int(max(1, self.mesh_devices)),
                "lost_device": dev,
                "reseated": int(reseated),
                "quarantined": int(quarantined),
                "error": f"{type(error).__name__}: {error}"[:300],
            })

    def _maybe_restore(self) -> None:
        """A restore request (``request_restore``): when every slot is
        healthy again and the mesh is below its configured size, evacuate
        live lanes (no abort charge) and rebuild the full mesh. Dispatcher
        thread only."""
        with self._lock:
            want = self._restore_requested
            self._restore_requested = False
        if not want or self._mesh_state is None:
            return
        if self.mesh_devices == self.mesh_devices0:
            return
        if self.device_health.lost():
            return   # still unhealthy: re-request after mark_healthy
        before = max(1, self.mesh_devices)
        reseated = 0
        for cls in sorted(list(self._pools), key=lambda c: c.name):
            s_, _p, _ = self._evacuate_pool(cls, None)
            reseated += len(s_)
        plan = self._mesh_state.on_restore()
        self.mesh = lane_mesh_over(
            [self._mesh_all[i] for i in plan["devices"]])
        self.mesh_devices = len(plan["devices"])
        self._mesh_gen = plan["generation"]
        with self._lock:
            self.stats["mesh_restores"] += 1
            self.stats["lanes_evacuated"] += reseated
        if self.on_event is not None:
            self.on_event("mesh_restore", {
                "devices_before": int(before),
                "devices_after": int(self.mesh_devices),
                "reseated": int(reseated),
            })

    # =====================================================================
    # continuous mode: lane recycling
    # =====================================================================
    def _wait_for_work(self):
        """Block until there is something to do. Returns False on stop.
        When a class has pending calls but no live lanes yet, honor the
        batching window (coalesce the first fill)."""
        with self._lock:
            while (not self._stop and not self._pending
                   and not self._spec_pending
                   and not self._restore_requested
                   and not any(p.live for p in self._pools.values())):
                self._lock.wait()
            if self._stop:
                return False
            if (self.window_s > 0 and self._pending
                    and not any(p.live for p in self._pools.values())):
                cls = max(self._pending, key=lambda c: max(
                    x.priority for x in self._pending[c]))
                window = priority_window(
                    self.window_s,
                    max(x.priority for x in self._pending[cls]))
                if len(self._pending[cls]) < self.batch_max:
                    deadline = time.perf_counter() + window
                    while (not self._stop
                           and len(self._pending.get(cls) or [])
                           < self.batch_max):
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        self._lock.wait(timeout=left)
            return not self._stop

    def _pop_pending(self, cls, free: int, live_depths: list) -> list:
        with self._lock:
            calls = self._pending.get(cls)
            if not calls:
                return []
            ordered = self._affinity_order(calls, live_depths)
            take = ordered[:free]
            rest = [c for c in calls if c not in take]
            if rest:
                self._pending[cls] = rest
            else:
                self._pending.pop(cls, None)
            return take

    def _loop_continuous(self) -> None:
        while True:
            if not self._wait_for_work():
                return
            self._maybe_restore()
            with self._lock:
                classes = set(self._pending) | set(self._spec_pending)
            classes.update(c for c, p in self._pools.items() if p.live)
            # deterministic service order (sets hash-order otherwise)
            for cls in sorted(classes, key=lambda c: c.name):
                with self._lock:
                    if self._stop:
                        return
                try:
                    self._service_class(cls)
                except Exception as e:
                    if self.mesh is not None and is_device_loss(e):
                        # a shard's device dropped out: re-shard onto the
                        # survivors (the failure-domain plane)
                        self._degrade_mesh(e)
                    else:
                        # dispatch abort: rebuild instead of failing the
                        # whole batch — survivors reseat, poisoned calls
                        # structured-fail
                        self._recover_class(cls, e)

    def _service_class(self, cls) -> None:
        """One slice of one class's pool: preempt unclaimed speculation for
        real calls, seat queued calls in free lanes (then speculative ones
        in what is left), run the slice, deliver every done lane (free a
        killed speculative one), shrink a draining pool."""
        pool = self._pools.get(cls)
        if pool is None:
            with self._lock:
                dummy = self._dummies.get(cls)
                if dummy is None:
                    dummy = self._dummies[cls] = dummy_member(cls)
            pool = self._pools[cls] = _LanePool(
                cls, 1, dummy, self.device,
                a_pad=stage_idx_width(self.stages_for(cls)),
                device_carry=self.device_carry,
                dummy_dev=self._dummy_rows.get(cls), mesh=self.mesh)
            if self.device_carry:
                self._dummy_rows[cls] = pool._dummy_dev

        free = self.batch_max - pool.live
        spec_evicted: list = []
        evict_b_pad = pool.b_pad
        with self._lock:
            spec_used = self._spec_used
            n_real = len(self._pending.get(cls) or [])
        if spec_used and n_real > free:
            # real traffic preempts speculation: cancel unclaimed
            # speculative lanes (lowest k first) and hand their lanes to
            # the real wave this slice (a reseat's reset beats the cancel
            # bit in K16, so a reseated lane re-inits cleanly)
            need = n_real - free
            cand = sorted((int(pool.k0[i]), i)
                          for i in range(pool.b_pad)
                          if pool.calls[i] is not None
                          and pool.calls[i].speculative)
            steps_now = self.resolved_slice_steps(cls, pool.b_pad)
            victims = []
            with self._lock:
                for _k, i in cand:
                    if len(victims) >= need:
                        break
                    c = pool.calls[i]
                    if c.claimed or c.cancelled:
                        continue
                    c.cancelled = True
                    c.cancel_reason = "preempted"
                    victims.append(i)
                self.stats["spec_cancelled"] += len(victims)
                self.stats["spec_preempted"] += len(victims)
                self.stats["spec_wasted_steps"] += sum(
                    pool.slices_in[i] * steps_now for i in victims)
            for i in victims:
                c = pool.calls[i]
                if self.on_event is not None:
                    self.on_event("spec_cancelled", {
                        "shape_class": cls.name, "k": c.k,
                        "reason": "preempted", "where": "lane",
                        "wasted_steps": int(pool.slices_in[i] * steps_now),
                    })
                c.done.set()
                pool.calls[i] = None
                spec_evicted.append(i)
            free = self.batch_max - pool.live
        admitted = 0
        if free > 0:
            take = self._pop_pending(cls, free, pool.live_depths())
            if take:
                pool.reserve(len(take))   # ONE resize for the whole wave
            for call in take:
                try:
                    fault_point("lane_seat", shape_class=cls.name)
                except Exception as e:
                    if self.mesh is not None and is_device_loss(e):
                        # a device died while seating: this call and the
                        # rest of the wave go back to the queue head, and
                        # the loop's device-loss handler re-shards
                        with self._lock:
                            self._pending.setdefault(cls, [])[:0] = \
                                take[take.index(call):]
                            self._lock.notify_all()
                        raise
                    # a seat fault costs THIS call one abort (quarantine
                    # past the budget, back of the queue otherwise)
                    call.aborts += 1
                    if call.aborts >= MAX_LANE_ABORTS:
                        self._quarantine(call, e)
                    else:
                        with self._lock:
                            self._pending.setdefault(cls, []).append(call)
                            self._lock.notify_all()
                    continue
                lane = pool.fill(call)
                call.lane_span = self.tracer.begin(
                    "lane", parent=call.span,
                    attrs={"lane": int(lane), "b_pad": int(pool.b_pad)})
                admitted += 1
        # speculation: capacity no real call wanted seats pending
        # speculative attempts, strictly after the real wave
        spec_admitted = 0

        def _seat_spec_wave() -> int:
            with self._lock:
                sl = self._spec_pending.get(cls) or []
                room = self.batch_max - pool.live
                spec_take, rest = sl[:room], sl[room:]
                if rest:
                    self._spec_pending[cls] = rest
                elif cls in self._spec_pending:
                    del self._spec_pending[cls]
                if spec_take:
                    self._spec_last[cls] = time.perf_counter()
            for call in spec_take:
                lane = pool.fill(call)
                with self._lock:
                    self.stats["spec_seated"] += 1
                if self.on_event is not None:
                    self.on_event("spec_seated", {
                        "shape_class": cls.name, "lane": int(lane),
                        "k": call.k})
            return len(spec_take)

        if spec_used and pool.live < self.batch_max:
            spec_admitted += _seat_spec_wave()
        if (spec_admitted and admitted == 0 and pool.live < self.batch_max
                and all(c is None or (c.speculative and not c.claimed)
                        for c in pool.calls)):
            # a wave of unclaimed speculation only: wait a hair for the
            # rest of the window's submits (one a claim), re-armed by each
            # arrival, but not for a claim, a real call or shutdown
            deadline = time.perf_counter() + _SPEC_COALESCE_S
            while pool.live < self.batch_max:
                if any(c is not None and c.claimed for c in pool.calls):
                    break
                with self._lock:
                    if self._stop or self._pending.get(cls):
                        break
                    if not self._spec_pending.get(cls):
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        self._lock.wait(timeout=left)
                        continue
                spec_admitted += _seat_spec_wave()
                deadline = time.perf_counter() + _SPEC_COALESCE_S
        live = pool.live
        if live == 0:
            # a spec-hot pool stays warm between window generations (a
            # rebuild per generation otherwise); speculation never used:
            # popped as before
            if not self._spec_hot(cls):
                self._pools.pop(cls, None)
            return
        # shrink a draining tail — but not while queued work is about to
        # refill the freed lanes, nor mid speculative sweep
        with self._lock:
            has_pending = bool(self._pending.get(cls)) or bool(
                self._spec_pending.get(cls))
        if not has_pending and not self._spec_hot(cls):
            pool.maybe_shrink()
        # live lanes per shard at dispatch (after the shrink, so counts and
        # width describe one pool; before delivery clears done lanes)
        dev_live = pool.device_live() if pool.mesh is not None else None

        kernel, cache_hit = self._slice_kernel_for(cls, pool.b_pad)
        slice_steps = self.resolved_slice_steps(cls, pool.b_pad)
        # the speculation vectors (the per-lane spec tag of attempt-only
        # calls, the cancel mask K16 kills at the slice entry): only once
        # speculation was ever used, else the slice is the plain one
        spec_vec = cancel_vec = None
        if spec_used:
            spec_vec = np.zeros(pool.b_pad, np.int32)
            cancel_vec = np.zeros(pool.b_pad, np.int32)
            with self._lock:
                for i, c in enumerate(pool.calls):
                    if c is None:
                        continue
                    if c.attempt_only:
                        spec_vec[i] = 1
                    if c.speculative and c.cancelled:
                        cancel_vec[i] = 1
            for i in spec_evicted:
                # a preempted lane no real call reseated still carries the
                # spec tag: the cancel bit retires it (a resize while
                # seating compacted such lanes away already)
                if pool.b_pad == evict_b_pad and pool.calls[i] is None:
                    spec_vec[i] = 1
                    cancel_vec[i] = 1
        slice_span = self.tracer.begin(
            "slice", trace="sched",
            attrs={"cls": cls.name, "live": int(live),
                   "b_pad": int(pool.b_pad)})
        t0 = time.perf_counter()

        try:
            fault_point("serve_dispatch", shape_class=cls.name)
            if pool.mesh is not None:
                # the sharded dispatch's fault point (mesh@N=device_loss:D
                # loses shard slot D at the Nth sharded dispatch)
                fault_point("mesh", shape_class=cls.name,
                            mesh_devices=self.mesh_devices)
            if self.device_carry:
                # the carry and the stacks stay on the device: this
                # slice's seats go up a row each (K17), nothing else
                stacks = pool.dev_state()
                if pool.lanes is None:
                    if pool.mesh is not None:   # per shard, input by input
                        stacks = [list(x) for x in zip(*stacks)]
                    pool.lanes = self._lanes_for(cls, *stacks, pool.carry)
            else:
                comb_dev, degrees_dev = pool.dev_inputs()
                # the scheduling vectors go up every slice (one copy), the
                # carry once (its first slice after a resize, with the
                # lanes; then the lanes' tensors advance in place)
                vecs = pool.dev_vecs()
                if pool.lanes is None:
                    pool.h2d += carry_nbytes(pool.carry)
                    pool.lanes = self._lanes_for(cls, comb_dev, degrees_dev,
                                                 *vecs, pool.carry)
            if spec_vec is not None:
                pool.arm(spec_vec, cancel_vec)
            carry = kernel(pool.lanes)
            # the per-lane scheduling scalars — the ONLY unconditional
            # device→host transfer per slice, one copy: the slice's sync
            slots = [CARRY_PHASE, CARRY_RUNG, CARRY_NC] + (
                [T_US] if self.timing else [])
            home = _home(carry, pool.mesh, slots)
        except BaseException as e:
            # every opened span must end (the validate_runlog contract)
            slice_span.end({"error": f"{type(e).__name__}: {e}"})
            raise
        if self.device_health is not None:
            self.device_health.record_ok()
        phase, rung, nc = home[0], home[1], home[2]
        pool.d2h += 3 * phase.nbytes
        device_s = time.perf_counter() - t0
        pool.rearm(carry)
        for i in range(pool.b_pad):
            pool.slices_in[i] += 1

        # in-kernel timing split (the T_US carry slot): per-lane
        # accumulated superstep µs; the per-slice in-kernel wall is the
        # max lane delta, overhead = host wall − in-kernel wall
        sstep_s = overhead_s = None
        t_acc = None
        if self.timing:
            t_acc = home[3].astype(np.int64)
            pool.d2h += phase.nbytes
            deltas = t_acc - pool.t_seen
            live_mask = np.array([c is not None for c in pool.calls])
            sstep_s = (float(deltas[live_mask].max()) / 1e6
                       if live_mask.any() else 0.0)
            overhead_s = max(0.0, device_s - sstep_s)
            pool.t_seen = t_acc.copy()

        done_lanes = [i for i in range(pool.b_pad)
                      if pool.calls[i] is not None and phase[i] >= 2]
        spec_killed = 0
        if done_lanes:
            with self._lock:
                dropped = {i for i in done_lanes
                           if pool.calls[i].speculative
                           and pool.calls[i].cancelled}
            delivered = [i for i in done_lanes if i not in dropped]
            if self.device_carry:
                # only the delivered lanes' result slots come home
                if not delivered:
                    outs = {}
                elif pool.mesh is None:
                    outs = dict(zip(delivered, lanes_home(carry, delivered)))
                else:
                    outs = dict(zip(delivered, lanes_home_sharded(
                        carry, delivered, pool.b_pad // pool.mesh_n)))
                pool.d2h += len(delivered) * (2 * cls.v_pad + 5) * 4
            else:
                # the host mirror: the whole carry comes home, one copy
                out_src = _home(carry, pool.mesh)
                pool.d2h += carry_nbytes(out_src)
                outs = {i: lane_outputs(out_src, i) for i in delivered}
            now = time.perf_counter()
            for lane in done_lanes:
                call = pool.calls[lane]
                if lane in dropped:
                    # a cancelled speculative lane killed at this slice's
                    # entry (or done after its cancel): free the lane,
                    # deliver nothing, charge its supersteps as wasted
                    wasted = int(pool.slices_in[lane]) * int(slice_steps)
                    with self._lock:
                        self.stats["spec_wasted_steps"] += wasted
                        reason = call.cancel_reason or "superseded"
                    call.done.set()
                    pool.calls[lane] = None
                    spec_killed += 1
                    if self.on_event is not None:
                        self.on_event("spec_cancelled", {
                            "shape_class": cls.name, "k": call.k,
                            "reason": reason, "where": "lane",
                            "wasted_steps": wasted,
                        })
                    continue
                call.result = outs[lane]
                if t_acc is not None:
                    call.device_us = int(t_acc[lane])
                if call.lane_span is not None:
                    call.lane_span.end(
                        {"slices": int(pool.slices_in[lane]),
                         "device_us": call.device_us})
                call.done.set()
                pool.calls[lane] = None
                with self._lock:
                    self.stats["sweeps"] += 1
                    self.stats["recycles"] += 1
                if self.on_event is not None:
                    rec = {
                        "shape_class": cls.name, "lane": int(lane),
                        "k": call.k, "depth_bucket": call.depth,
                        "slices": int(pool.slices_in[lane]),
                        "queue_ms": round(
                            (pool.t_fill[lane] - call.t_enqueue) * 1e3, 3),
                        "service_ms": round(
                            (now - pool.t_fill[lane]) * 1e3, 3),
                    }
                    if call.device_us is not None:
                        rec["device_us"] = call.device_us
                    self.on_event("lane_recycled", rec)

        # stage-occupancy telemetry from the rung/nc carry slots
        live_idx = [i for i in range(pool.b_pad)
                    if pool.calls[i] is not None]
        stages = self.stages_for(cls)
        stage_pads = ([cls.v_pad if s is None else _pow2_ceil(s)
                       for s, _ in stages] if stages else [cls.v_pad])
        rung_min = rung_max = 0
        frontier = slot_total = 0
        if live_idx:
            rungs = [int(rung[i]) for i in live_idx]
            rung_min, rung_max = min(rungs), max(rungs)
            frontier = int(sum(int(nc[i]) for i in live_idx))
            slot_total = sum(stage_pads[min(r, len(stage_pads) - 1)]
                             for r in rungs)

        h2d, d2h = pool.h2d, pool.d2h
        pool.h2d = pool.d2h = 0
        with self._lock:
            self.stats["batches"] += 1
            self.stats["slices"] += 1
            self.stats["max_live"] = max(self.stats["max_live"], live)
            self.stats["h2d_bytes"] += h2d
            self.stats["d2h_bytes"] += d2h
            if dev_live is not None:
                for d, c in enumerate(dev_live):
                    self._dev_live_sum[d] += c
                self._dev_live_n += pool.b_pad // pool.mesh_n
        slice_span.end({"done": len(done_lanes), "admitted": int(admitted)})
        if self.on_event is not None:
            rec = {
                "shape_class": cls.name, "live": int(live),
                "b_pad": int(pool.b_pad),
                "occupancy": round(live / pool.b_pad, 4),
                "done": len(done_lanes), "admitted": int(admitted),
                "slice_steps": int(slice_steps),
                "compile_cache": "hit" if cache_hit else "miss",
                "device_ms": round(device_s * 1e3, 3),
                "stage_min": int(rung_min), "stage_max": int(rung_max),
                "frontier": int(frontier),
                "stage_occupancy": (round(frontier / slot_total, 4)
                                    if slot_total else 0.0),
                "h2d_bytes": int(h2d), "d2h_bytes": int(d2h),
            }
            if dev_live is not None:
                per = pool.b_pad // pool.mesh_n
                rec["mesh_devices"] = int(pool.mesh_n)
                rec["device_occupancy"] = [round(c / per, 4)
                                           for c in dev_live]
            if sstep_s is not None:
                rec["sstep_ms"] = round(sstep_s * 1e3, 3)
                rec["overhead_ms"] = round(overhead_s * 1e3, 3)
            if spec_used:
                # the speculation plane's cost side: live speculative
                # lanes, this slice's seats, the lanes K16 just killed
                rec["spec_live"] = int(sum(
                    1 for c in pool.calls
                    if c is not None and c.speculative))
                rec["spec_admitted"] = int(spec_admitted)
                rec["spec_killed"] = int(spec_killed)
            self.on_event("serve_slice", rec)
        # recalibration samples: full slices only (no lane finished
        # early), tagged with the slice's minimum live rung
        if (self.timing and cache_hit and not done_lanes and live > 0
                and sstep_s is not None and sstep_s > 0):
            self._timing_sample(cls, overhead_s, sstep_s / slice_steps,
                                rung=rung_min)
        if pool.live == 0 and not self._spec_hot(cls):
            self._pools.pop(cls, None)

    # =====================================================================
    # sync mode: the batch-complete dispatch (the A/B baseline)
    # =====================================================================
    def _take_batch(self):
        """Wait for work, honor the batching window, pop one class's
        batch (the largest same-depth affinity group when enabled).
        Returns (cls, calls) or None on stop."""
        with self._lock:
            while (not self._stop and not self._pending
                   and not self._restore_requested):
                self._lock.wait()
            if self._stop or not self._pending:
                # stop, or a restore request with nothing queued: the
                # loop services the restore and comes back
                return None
            cls = max(self._pending, key=lambda c: max(
                x.priority for x in self._pending[c]))
            window = priority_window(
                self.window_s, max(x.priority for x in self._pending[cls]))
            if self.window_s > 0 and len(self._pending[cls]) < self.batch_max:
                deadline = time.perf_counter() + window
                while (not self._stop
                       and len(self._pending.get(cls) or []) < self.batch_max):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._lock.wait(timeout=left)
                if self._stop:
                    return None
                if cls not in self._pending:   # drained by a concurrent pop
                    return self._take_batch()
            ordered = self._affinity_order(self._pending[cls], [])
            calls = ordered[: self.batch_max]
            rest = [c for c in self._pending[cls] if c not in calls]
            if rest:
                self._pending[cls] = rest
            else:
                del self._pending[cls]
            return cls, calls

    def _loop_sync(self) -> None:
        while True:
            self._maybe_restore()
            got = self._take_batch()
            if got is None:
                with self._lock:
                    if self._stop:
                        return
                continue
            cls, calls = got
            try:
                self._dispatch(cls, calls)
            except Exception as e:
                if self.mesh is not None and is_device_loss(e):
                    # the failure-domain plane re-shards onto the
                    # survivors; the batch rides its accounting
                    self._degrade_mesh(e, sync_batch=(cls, calls))
                    continue
                # the continuous loop's quarantine policy: each batch
                # member pays one abort; survivors requeue at the head
                survivors = []
                aborts_max = 0
                for call in calls:
                    call.aborts += 1
                    aborts_max = max(aborts_max, call.aborts)
                    if call.aborts >= MAX_LANE_ABORTS:
                        self._quarantine(call, e)
                    else:
                        survivors.append(call)
                with self._lock:
                    if survivors:
                        self._pending.setdefault(cls, [])[:0] = survivors
                    self.stats["rebuilds"] += 1
                    self._lock.notify_all()
                if self.on_event is not None:
                    self.on_event("lane_rebuild", {
                        "shape_class": cls.name,
                        "reason": "abort",
                        "reseated": len(survivors),
                        "quarantined": len(calls) - len(survivors),
                        "aborts_max": int(aborts_max),
                        "error": f"{type(e).__name__}: {e}"[:300],
                    })

    def _dispatch(self, cls, calls) -> None:
        b = len(calls)
        b_pad = min(_pow2_ceil(b), self.batch_max)
        if b_pad < b:   # batch_max not a power of two: pad up past it
            b_pad = _pow2_ceil(b)
        mesh = self.mesh
        if mesh is not None:
            # the lanes shard evenly: a power-of-two pad of at least the
            # mesh size
            b_pad = max(_pow2_ceil(b), self.mesh_devices)
        members = [c.member for c in calls]
        fill = b_pad - b
        if fill:
            with self._lock:
                dummy = self._dummies.get(cls)
                if dummy is None:
                    dummy = self._dummies[cls] = dummy_member(cls)
            members = members + [dummy] * fill
        comb = np.stack([m.comb for m in members])
        degrees = np.stack([m.degrees for m in members])
        k0 = np.array([c.k for c in calls] + [1] * fill, np.int32)
        max_steps = np.array([m.max_steps for m in members], np.int32)

        kernel, cache_hit = self._kernel_for(cls, b_pad)
        batch_span = self.tracer.begin(
            "batch", trace="sched",
            attrs={"cls": cls.name, "batch": int(b), "b_pad": int(b_pad)})
        t0 = time.perf_counter()

        try:
            fault_point("serve_dispatch", shape_class=cls.name)
            if mesh is not None:
                fault_point("mesh", shape_class=cls.name,
                            mesh_devices=self.mesh_devices)
            # one transfer home for the epilogues
            p1, s1, st1, used, p2, s2, st2 = _home(
                kernel(comb, degrees, k0, max_steps), mesh)
        except BaseException as e:
            batch_span.end({"error": f"{type(e).__name__}: {e}"})
            raise
        if self.device_health is not None:
            self.device_health.record_ok()
        device_s = time.perf_counter() - t0
        batch_span.end()

        queue_ms_max = max(
            (t0 - c.t_enqueue) * 1e3 for c in calls)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["sweeps"] += b
            self.stats["max_live"] = max(self.stats["max_live"], b)
            if mesh is not None:
                per = b_pad // self.mesh_devices
                for d in range(self.mesh_devices):
                    self._dev_live_sum[d] += max(0, min(per, b - d * per))
                self._dev_live_n += per
        if self.on_batch is not None:
            # straggler waste: the fraction of dispatched real-lane
            # supersteps spent re-running already-finished lanes while the
            # slowest member swept on (0.0 for b == 1)
            steps = (s1[:b].astype(np.int64) + s2[:b].astype(np.int64))
            smax = int(steps.max()) if b else 0
            waste = (round(1.0 - float(steps.mean()) / smax, 4)
                     if smax > 0 else 0.0)
            depths = {c.depth for c in calls}
            stages = self.stages_for(cls)
            rec = {
                "shape_class": cls.name, "batch": b, "b_pad": int(b_pad),
                "occupancy": round(b / b_pad, 4),
                "padding_waste": padding_waste([c.member for c in calls],
                                               cls, b_pad),
                "straggler_waste": waste,
                "depth_buckets": len(depths),
                "compile_cache": "hit" if cache_hit else "miss",
                "device_ms": round(device_s * 1e3, 3),
                "queue_ms_max": round(queue_ms_max, 3),
                "stage_bodies": len(stages) if stages else 1,
            }
            if mesh is not None:
                # real lanes per shard: sync mode fills lanes 0..b-1, so
                # shard d holds rows [d * per, (d + 1) * per)
                per = b_pad // self.mesh_devices
                rec["mesh_devices"] = int(self.mesh_devices)
                rec["device_occupancy"] = [
                    round(max(0, min(per, b - d * per)) / per, 4)
                    for d in range(self.mesh_devices)]
            self.on_batch(rec)
        for i, call in enumerate(calls):
            call.result = (p1[i], s1[i], st1[i], int(used[i]),
                           p2[i], s2[i], int(st2[i]))
            call.done.set()


class BatchMemberEngine:
    """Per-request engine proxy: the ``sweep``/``attempt`` protocol over
    the batch scheduler, so ``find_minimal_coloring`` drives the batched
    path exactly like any fused engine."""

    def __init__(self, member, scheduler: BatchScheduler,
                 priority: int = 0):
        self.member = member
        self.scheduler = scheduler
        self.priority = max(0, int(priority))
        self._fallback = None

    # the STALLED-confirm fallback owns the widen-and-retry loop; with
    # covering class windows it is reachable only on a genuine stall
    def _fallback_engine(self):
        if self._fallback is None:
            from dgc_tpu_torch.engine.compact import CompactFrontierEngine

            self._fallback = CompactFrontierEngine(
                self.member.arrays, device=self.scheduler.device)
        return self._fallback

    def attempt(self, k: int) -> AttemptResult:
        v = self.member.num_vertices
        if k < 1:
            return empty_budget_failure(v, k)
        return self._fallback_engine().attempt(k)

    def sweep(self, k0: int):
        if k0 < 1:
            return self.attempt(k0), None
        out = self.scheduler.sweep(self.member, k0,
                                   priority=self.priority)
        member = _KMember(self.member, k0)
        return finish_pair(member, *out, self.attempt)


class _KMember:
    """View of a member at a non-default budget (``finish_pair`` reads
    ``k0``/``num_vertices`` only)."""

    __slots__ = ("member", "k0")

    def __init__(self, member, k0: int):
        self.member = member
        self.k0 = int(k0)

    @property
    def num_vertices(self) -> int:
        return self.member.num_vertices
