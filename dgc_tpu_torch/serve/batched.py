"""Batched fused jump-mode sweep — B graphs per dispatch (port of
``dgc_tpu.serve.batched``).

One shape class's batch runs as a loop of batched supersteps over
lane-leading carry tensors (the reference's 20 slots, ``layout.CARRY_*``):
each lane's phase, budget k, live attempt state and both result slots.
Every lane advances through its own supersteps, phase transitions and
``max_steps`` clamp; a finished lane is frozen. The whole jump-mode sweep
— attempt(k0), then the confirm at (colors used − 1) — is one loop.

The superstep runs in four hand-written CUDA kernels (``kernels.serve``,
``csrc/serve.cu``): K16 ``lane_reset`` at the slice entry (re-init of the
flagged lanes, the timing seed), then per superstep K14 ``lane_compact``
(the stage-entry recompaction; staged ladders only), K13
``lane_superstep`` (the rule at the executed rung) and K15 ``lane_finish``
(the transition, the freeze, the routing of the next superstep). The
executed rung is the min over the live lanes' rungs, as the reference:
exact for every lane, because a wider pad covers a deeper lane's frontier.
The routing lives in a control block on the card, so the host enqueues a
slice's supersteps back to back with no sync: the kernels do nothing once
no lane runs or the slice's steps are spent.

- ``batched_sweep`` (sync mode, ``batched_sweep_kernel``): every lane
  re-initialized, then supersteps in chunks of ``SWEEP_CHUNK`` with one
  host read of the live word between chunks, until every lane is done;
  returns the seven result slots.
- ``batched_slice`` (continuous mode, ``batched_slice_kernel``): at most
  ``slice_steps`` supersteps from the given carry after re-initializing
  the lanes flagged in ``reset``; returns the carry. It is
  ``run_slice`` over ``slice_lanes``; the scheduler keeps the lanes of a
  pool and calls ``run_slice`` each slice. Slicing is
  result-invariant: the same superstep sequence is applied to each lane
  however the budget partitions it. With ``timing`` each live lane's
  superstep wall-µs accumulate in ``T_US`` (the card's clock, one reading
  per batched superstep; the host clock on the CPU); the other slots are
  byte-identical timing on or off. The speculation plane's optional
  ``spec``/``cancel`` int32[B] vectors (``batched_slice_kernel``'s) arm
  K16: a flagged lane is seated with its spec tag (an attempt-only lane:
  K15 runs no confirm for it), and a spec-tagged lane that is cancelled
  and not flagged is killed (phase 2) before any superstep of the slice;
  without them (None) the slice is the plain one.

The carry is updated in place when its tensors are on the device already
(numpy arrays are copied there first); the JAX kernels are functional, so
``batched_slice_kernel_donated`` needs no kernel of its own here.

The device-resident carry (``--device-carry``, B12f) moves lanes on the
card: ``seat_lanes`` (K17, a wave of seats; each seat's table row goes up
once), ``permute_carry`` (K18, a pool resize's carry move into a fresh
idle carry built on the card) and ``resize_inputs`` (K19, the input
stacks at a new width, the class dummy in the new rows) over
``kernels.carry``; ``lanes_home`` brings only done lanes' result slots
home.

**The lane mesh** (``--mesh-devices``, B12g; the reference's sharded
section): a :class:`LaneMesh` is an ordered list of n shard slots, each a
``torch.device`` (repeats allowed: several slots on one card), and lane
``i`` of a ``B``-lane pool lives on shard ``i // (B / n)``, the reference's
``NamedSharding(P("lanes"))`` blocks. Each shard holds its own ``Lanes``
(carry rows, inputs, ``nxt``, counters, control block). The reference's
cross-lane values are full reductions (the executed rung, the live
predicate), which its SPMD partitioner turns into all-reductions; here
each shard runs the partial instances of K16/K15, and the last of them to
finish writes the folded routing into every shard's control block in its
tail, K26's fold (``kernels.serve.mesh_reset`` / ``mesh_superstep``), so
a lane's values are byte-identical to the unsharded run's. The six ``_sharded``
twins (``batched_sweep_kernel_sharded``, ``batched_slice_kernel_sharded``
and its ``_donated`` form, ``seat_lane_kernel_sharded``,
``permute_carry_kernel_sharded``, ``resize_inputs_kernel_sharded``) take
whole ``[B, ...]`` inputs (numpy or tensors, split on upload) or per-shard
lists; a sharded carry is a list of n per-shard carries.

Bit identity with the single-graph engines (``CompactFrontierEngine
.sweep``) is the reference's argument (``dgc_tpu/serve/batched.py``
docstring): priorities invariant under the relabeling, windows covering
every width, inert padding, the same rule and status transition.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.base import AttemptResult, AttemptStatus
from dgc_tpu_torch.engine.compact import _check_stage_ladder
from dgc_tpu_torch.kernels import carry as kcar
from dgc_tpu_torch.kernels import serve as ks
from dgc_tpu_torch.kernels.superstep import indexed_device
from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_LEN, CARRY_P1, CARRY_P2,
                                  CARRY_PACKED, MESH_AXIS, N_OUT, OUT0)

_FAILURE = AttemptStatus.FAILURE

DEFAULT_STALL_WINDOW = 64  # the engines' shared defensive exit
SWEEP_CHUNK = 16           # supersteps enqueued per host read (sync mode)


def resolve_stages(stages, v: int):
    """Validated ``(stages, pads, a0)`` of a ladder (``None``: the
    full-table-only schedule); the single-graph engine's
    ``_check_stage_ladder`` rule, opening with a full-table stage. ``a0``
    is the carried slot-list width: the widest pad, 1 without one."""
    if stages is None:
        stages = ((None, 0),)
    else:
        stages = tuple((None if s is None else int(s), int(t))
                       for s, t in stages)
    _check_stage_ladder(stages, v)
    if stages[0][0] is not None:
        raise ValueError(
            f"serve stage ladder must open with a full-table stage "
            f"(scale None), got {stages!r}")
    if len(stages) > ks.MAX_STAGES:
        raise ValueError(f"serve stage ladder has {len(stages)} stages, at "
                         f"most {ks.MAX_STAGES}")
    pads = tuple(None if s is None else
                 1 << max(0, (int(s) - 1).bit_length()) for s, _ in stages)
    a0 = max((p for p in pads if p is not None), default=1)
    return stages, pads, a0


def stage_idx_width(stages) -> int:
    """The carried compacted-slot-list width (``CARRY_IDX``) a ladder
    implies — the host-side twin of ``resolve_stages``' ``a0``, used by
    the scheduler/tests to size ``idle_carry``."""
    if stages is None:
        return 1
    return max((1 << max(0, (int(s) - 1).bit_length())
                for s, _ in stages if s is not None), default=1)


_LADDERS: dict = {}


def _ladder_ctrl(stages: tuple, device: torch.device) -> torch.Tensor:
    """A fresh control block of the ladder on ``device``: a copy on the
    card of one uploaded once per (ladder, device)."""
    key = (stages, str(device))
    base = _LADDERS.get(key)
    if base is None:
        base = _LADDERS[key] = ks.ladder_ctrl(stages, device)
    return base.clone()


def _device_of(device, *xs) -> torch.device:
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                      "cuda")
    return resolve_device(device)


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor on ``device``: numpy arrays are
    copied, tensors already there are used as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.tensor(np.ascontiguousarray(x, dtype=np.int32),
                        device=device)


def _rounds(L: ks.Lanes, n: int, staged: bool, timing: bool) -> None:
    """Enqueue ``n`` batched supersteps (on the CPU: until the live word
    drops)."""
    cpu = L.device.type == "cpu"
    for _ in range(n):
        if cpu and not int(L.ctrl[ks.CTRL_LIVE]):
            return
        if staged:
            ks.lane_compact(L)
        ks.lane_superstep(L)
        ks.lane_finish(L, timing)


def batched_sweep(comb, degrees, k0, max_steps, planes: int,
                  stall_window: int = DEFAULT_STALL_WINDOW, stages=None,
                  device=None):
    """The batch-synchronous class sweep: ``comb int32[B, V_pad, W_pad]``,
    ``degrees int32[B, V_pad]``, per-graph ``k0``/``max_steps`` int32[B]
    (numpy or tensors). Every lane runs its whole jump-mode pair; returns
    the result slots ``(p1, s1, st1, used, p2, s2, st2)`` as tensors on
    the device, when the last lane finishes. ``stages``: the ladder (or
    None, the full table). ``device``: the inputs' (default ``cuda``)."""
    device = _device_of(device, degrees, comb)
    degrees = _on(degrees, device)
    b, v = degrees.shape
    stages, _pads, a0 = resolve_stages(stages, v)
    carry = [torch.empty((b, a0) if j == CARRY_IDX else
                         (b, v) if j in (CARRY_PACKED, CARRY_P1, CARRY_P2)
                         else (b,), dtype=torch.int32, device=device)
             for j in range(CARRY_LEN)]
    L = ks.new_lanes(carry, _on(comb, device), degrees, _on(k0, device),
                     _on(max_steps, device),
                     torch.ones(b, dtype=torch.int32, device=device),
                     _ladder_ctrl(stages, device), planes=planes,
                     stall_window=stall_window, budget=ks.INT32_MAX)
    staged = is_staged(stages)
    ks.lane_reset(L)
    while int(L.ctrl[ks.CTRL_LIVE]):  # one host read per chunk
        _rounds(L, SWEEP_CHUNK, staged, False)
    return tuple(L.carry[OUT0:OUT0 + N_OUT])


def is_staged(stages) -> bool:
    """Whether a ladder (``None``: the full table) has a staged rung."""
    return stages is not None and any(s is not None for s, _ in stages)


def slice_lanes(comb, degrees, k0, max_steps, reset, carry, *, planes: int,
                stall_window: int = DEFAULT_STALL_WINDOW, stages=None,
                device=None, spec=None, cancel=None) -> ks.Lanes:
    """The lanes of a continuous batch for :func:`run_slice`: the inputs
    and the ``CARRY_LEN`` carry slots on the device (numpy arrays copied
    there, tensors already there used as they are), the back buffer a copy
    of ``packed``; ``spec``/``cancel`` (int32[B], either None) arm the
    speculation plane (``Lanes.arm_spec``). The scheduler's pool keeps
    them from slice to slice and writes each slice's inputs into their
    tensors; they are made again only when the pool is resized."""
    if len(carry) != CARRY_LEN:
        raise ValueError(f"the carry has {CARRY_LEN} slots, got {len(carry)}")
    device = _device_of(device, degrees, comb, *carry)
    degrees = _on(degrees, device)
    stages, _pads, a0 = resolve_stages(stages, degrees.shape[1])
    if carry[CARRY_IDX].shape[1] != a0:
        raise ValueError(f"the carry's slot list is {carry[CARRY_IDX].shape[1]}"
                         f" wide, the ladder's {a0}")
    L = ks.new_lanes([_on(c, device) for c in carry], _on(comb, device),
                     degrees, _on(k0, device), _on(max_steps, device),
                     _on(reset, device), _ladder_ctrl(stages, device),
                     planes=planes, stall_window=stall_window, budget=1)
    if spec is not None or cancel is not None:
        L.arm_spec(None if spec is None else _on(spec, device),
                   None if cancel is None else _on(cancel, device))
    return L


def run_slice(L: ks.Lanes, *, slice_steps: int, staged: bool,
              timing: bool = False) -> tuple:
    """One slice of ``L``: K16 (the lanes flagged in ``L.reset``
    re-initialized), then at most ``slice_steps`` batched supersteps of
    every live lane, enqueued without a host sync. Returns the carry, the
    tensors of ``L`` advanced in place. ``staged``: the ladder has a
    staged rung (:func:`is_staged`)."""
    if int(slice_steps) < 1:
        raise ValueError(f"slice_steps must be >= 1, got {slice_steps}")
    L.set_budget(int(slice_steps))
    ks.lane_reset(L, timing)
    _rounds(L, int(slice_steps), staged, timing)
    return tuple(L.carry)


def batched_slice(comb, degrees, k0, max_steps, reset, carry, spec=None,
                  cancel=None, *, planes: int, slice_steps: int,
                  stall_window: int = DEFAULT_STALL_WINDOW,
                  timing: bool = False, stages=None, device=None):
    """The continuous-batching class slice: re-init the lanes flagged in
    ``reset int32[B]`` from their inputs, then at most ``slice_steps``
    batched supersteps of every live lane, enqueued without a host sync.
    ``carry`` is the ``CARRY_LEN`` slots, lane-leading (numpy or tensors);
    returns the advanced carry as tensors on the device (the same tensors
    when they were there already). The host reads ``carry[CARRY_PHASE] >=
    2`` as the done mask. ``timing``, ``spec`` and ``cancel``: module
    docstring."""
    if int(slice_steps) < 1:
        raise ValueError(f"slice_steps must be >= 1, got {slice_steps}")
    L = slice_lanes(comb, degrees, k0, max_steps, reset, carry,
                    planes=planes, stall_window=stall_window, stages=stages,
                    device=device, spec=spec, cancel=cancel)
    return run_slice(L, slice_steps=slice_steps, staged=is_staged(stages),
                     timing=timing)


def to_host(x) -> np.ndarray:
    """A carry slot (or any array) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def carry_home(slots) -> tuple:
    """Host copies (numpy) of carry slots: slots on a card come home in
    one copy, the one host sync of the read."""
    if not isinstance(slots[0], torch.Tensor):
        return tuple(np.asarray(s) for s in slots)
    flat = torch.cat([s.reshape(-1) for s in slots]).cpu().numpy()
    out, at = [], 0
    for s in slots:
        out.append(flat[at:at + s.numel()].reshape(tuple(s.shape)))
        at += s.numel()
    return tuple(out)


def idle_carry(b_pad: int, v_pad: int, a_pad: int = 1):
    """Host-side all-idle lane carry (phase 2, inert; each slot filled with
    ``kernels.carry.idle_values``, the values K18 gives a row it does not
    fill): the host-mirror pool's starting state and the shape every
    resize pads with. Plain numpy — the kernel's first invocation uploads
    it. ``a_pad`` is the class ladder's carried slot-list width
    (:func:`stage_idx_width`; 1 for full-table-only kernels)."""
    idle = kcar.idle_values(v_pad)
    return tuple(np.full(kcar.slot_shape(j, b_pad, v_pad, a_pad), idle[j],
                         np.int32) for j in range(CARRY_LEN))


def lane_outputs(carry, lane: int):
    """Extract one done lane's ``(p1, s1, st1, used, p2, s2, st2)`` —
    the sweep-result convention ``finish_pair`` consumes — from a
    host-materialized carry (numpy tuple) or one on the device (only this
    lane's two result rows and five scalars come home)."""
    p1, s1, st1, used, p2, s2, st2 = (to_host(carry[j][lane])
                                      for j in range(OUT0, OUT0 + N_OUT))
    return p1, int(s1), int(st1), int(used), p2, int(s2), int(st2)


def lanes_home(carry, lanes) -> list:
    """``lane_outputs`` of each of ``lanes`` from a carry on the device:
    only their result slots (two rows and five scalars a lane) come home,
    in one copy."""
    idx = torch.tensor([int(x) for x in lanes], dtype=torch.int64,
                       device=carry[OUT0].device)
    rows = carry_home([carry[j].index_select(0, idx)
                       for j in range(OUT0, OUT0 + N_OUT)])
    return [lane_outputs((None,) * OUT0 + tuple(rows), i)
            for i in range(len(lanes))]


def seat_lanes(stacks, seats) -> int:
    """K17 over a wave of ``seats`` ``(lane, comb int32[V, W], degrees
    int32[V], k0, max_steps)`` (numpy rows) into ``stacks`` (the resident
    ``comb, degrees, k0, max_steps, reset`` tensors), in seat order: each
    seat's rows go up once into a staging buffer on the stacks' device.
    Returns the bytes uploaded."""
    if not seats:
        return 0
    comb, degrees = stacks[0], stacks[1]
    device = degrees.device
    n = len(seats)
    s_comb = torch.empty((n,) + tuple(comb.shape[1:]), dtype=torch.int32,
                         device=device)
    s_degrees = torch.empty((n, degrees.shape[1]), dtype=torch.int32,
                            device=device)
    for i, (_lane, m_comb, m_degrees, _k, _ms) in enumerate(seats):
        s_comb[i].copy_(torch.from_numpy(np.ascontiguousarray(m_comb,
                                                              np.int32)))
        s_degrees[i].copy_(torch.from_numpy(np.ascontiguousarray(m_degrees,
                                                                 np.int32)))
    kcar.lane_seat(*stacks, [s[0] for s in seats], s_comb, s_degrees,
                   [s[3] for s in seats], [s[4] for s in seats])
    return int(s_comb.numel() + s_degrees.numel() + 3 * n) * 4


def permute_carry(carry, keep, b_new: int) -> list:
    """K18: the carry of a pool resized to ``b_new`` lanes, the kept lanes'
    rows (old lanes ``keep``) in rows ``0..len(keep)-1``, the others idle
    (``idle_carry``'s values), built on the carry's device."""
    return kcar.carry_permute(carry, list(keep), list(range(len(keep))),
                              b_new)


def resize_inputs(stacks, src, dummy_comb, dummy_max_steps: int) -> tuple:
    """K19: the input stacks ``(comb, degrees, k0, max_steps, reset)`` at
    ``len(src)`` lanes, row ``i`` old lane ``src[i]`` or (past the old
    width) the class dummy: ``dummy_comb`` on the stacks' device, zero
    degrees, ``k0`` 1, ``dummy_max_steps``; reset all 0."""
    return kcar.inputs_resize(*stacks[:4], list(src), dummy_comb, 1,
                              int(dummy_max_steps))


def carry_nbytes(carry) -> int:
    """Total byte size of a carry tuple (transfer accounting; every slot
    is int32, and the shape touches no device data)."""
    return int(sum(int(np.prod(a.shape)) * 4 for a in carry))


# -- the lane mesh (B12g) -------------------------------------------------

# A host without a card has no device count of its own: it gets 8 lane
# slots, the counterpart of the 8 host devices the JAX package's tests
# force, so ``--mesh-devices 8`` and ``auto`` run on the CPU and 16 exceeds.
CPU_LANE_SLOTS = 8


class LaneMesh:
    """A one-axis lane mesh (axis ``layout.MESH_AXIS``): an ordered list of
    n shard slots, each a ``torch.device``; a device may repeat (several
    slots on one card share its stream, and launch order is the order).
    Slots on several cards must reach each other (peer access, enabled
    here); the mesh refuses otherwise."""

    def __init__(self, devices):
        devs = tuple(indexed_device(d) for d in devices)
        if not devs:
            raise ValueError("a lane mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a lane mesh lies on one kind of device, got "
                             f"{[str(d) for d in devs]}")
        ks.enable_peer_access(devs)
        self.devices = devs
        self.axis_names = (MESH_AXIS,)

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first slot's device (where the fold's ticket lives)."""
        return self.devices[0]

    def per(self, b: int) -> int:
        """The lanes a shard holds in a ``b``-lane pool."""
        if b % self.n:
            raise ValueError(f"{b} lanes do not shard evenly over {self.n}")
        return b // self.n

    def __repr__(self) -> str:
        return f"LaneMesh({[str(d) for d in self.devices]})"


def mesh_device_count(devices="auto", device="cuda") -> int:
    """Resolve a ``--mesh-devices`` value to a lane-mesh size on ``device``'s
    kind (the card count; ``CPU_LANE_SLOTS`` without a card): ``auto`` (or
    None) is the largest power of two not above the count; an explicit N
    must be a power of two (lane pads are powers of two and must shard
    evenly) and not above the count. 1 means no mesh (the unsharded
    path)."""
    dev = resolve_device(device)
    n_avail = (torch.cuda.device_count() if dev.type == "cuda"
               else CPU_LANE_SLOTS)
    if devices in ("auto", None):
        return 1 << max(0, n_avail.bit_length() - 1)
    n = int(devices)
    if n < 1 or (n & (n - 1)) != 0:
        raise ValueError(
            f"mesh devices must be a power of two (lane pads are pow2 "
            f"and must shard evenly), got {devices!r}")
    if n > n_avail:
        raise ValueError(
            f"mesh devices {n} exceeds the {n_avail} local device(s)")
    return n


def lane_mesh(devices="auto", device="cuda") -> LaneMesh:
    """The lane mesh over the first :func:`mesh_device_count` cards (or as
    many CPU lane slots)."""
    n = mesh_device_count(devices, device)
    if resolve_device(device).type == "cuda":
        return LaneMesh([torch.device("cuda", i) for i in range(n)])
    return LaneMesh([torch.device("cpu")] * n)


def lane_mesh_over(devices) -> LaneMesh:
    """A lane mesh over an explicit device list (repeats allowed: the
    failure-domain plane's survivor meshes, several slots on one card). Its
    length must be a power of two >= 2 (one survivor takes the unsharded
    path instead)."""
    devices = list(devices)
    n = len(devices)
    if n < 2 or (n & (n - 1)) != 0:
        raise ValueError(
            f"lane_mesh_over needs a power-of-two device list >= 2 "
            f"(got {n}); a single survivor takes the unsharded path")
    return LaneMesh(devices)


def _is_sharded(x) -> bool:
    """A per-shard list (not a whole array, and for a carry not a list of
    slots)."""
    return isinstance(x, (list, tuple)) and len(x) > 0 and isinstance(
        x[0], (list, tuple))


def split_lanes(x, mesh: LaneMesh) -> list:
    """A whole lane-leading array (numpy or tensor) as n contiguous
    per-shard int32 tensors on the shards' devices."""
    b = x.shape[0]
    per = mesh.per(b)
    return [_on(x[i * per:(i + 1) * per], d)
            for i, d in enumerate(mesh.devices)]


def _stack_shards(x, mesh: LaneMesh) -> list:
    """Per-shard tensors of a stack given whole or as a per-shard list."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.n:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.n}")
        return [_on(t, d) for t, d in zip(x, mesh.devices)]
    return split_lanes(x, mesh)


def carry_shards(carry, mesh: LaneMesh) -> list:
    """A carry given whole (``CARRY_LEN`` lane-leading slots) or sharded
    (n per-shard carries) as n per-shard lists of tensors (tensors already
    on their shard's device are used as they are)."""
    if _is_sharded(carry):
        if len(carry) != mesh.n:
            raise ValueError(f"{len(carry)} carry shards for a mesh of "
                             f"{mesh.n}")
        return [[_on(t, d) for t in c] for c, d in zip(carry, mesh.devices)]
    if len(carry) != CARRY_LEN:
        raise ValueError(f"the carry has {CARRY_LEN} slots, got {len(carry)}")
    slots = [split_lanes(t, mesh) for t in carry]
    return [[slots[j][i] for j in range(CARRY_LEN)] for i in range(mesh.n)]


def sharded_home(shards) -> tuple:
    """Whole host copies (numpy) of the slots of n per-shard tuples, the
    shards' rows in order; one copy home per device."""
    n_slots = len(shards[0])
    by_device: dict = {}
    for i, sh in enumerate(shards):
        dev = str(sh[0].device) if isinstance(sh[0], torch.Tensor) else "np"
        by_device.setdefault(dev, []).append(i)
    homes = [None] * len(shards)
    for idx in by_device.values():
        flat = carry_home([t for i in idx for t in shards[i]])
        for k, i in enumerate(idx):
            homes[i] = flat[k * n_slots:(k + 1) * n_slots]
    return tuple(np.concatenate([h[j] for h in homes])
                 for j in range(n_slots))


def lanes_home_sharded(shards, lanes, per: int) -> list:
    """``lanes_home`` of each of ``lanes`` (global lane ids) from a
    sharded carry: each shard's delivered lanes' result slots, one copy a
    shard."""
    out = {}
    for s, sh in enumerate(shards):
        mine = [lane for lane in lanes if lane // per == s]
        if mine:
            out.update(zip(mine, lanes_home(sh, [lane - s * per
                                                 for lane in mine])))
    return [out[lane] for lane in lanes]


def mesh_lanes(mesh: LaneMesh, comb, degrees, k0, max_steps, reset, carry, *,
               planes: int, stall_window: int = DEFAULT_STALL_WINDOW,
               stages=None, spec=None, cancel=None) -> ks.MeshLanes:
    """``slice_lanes`` per shard: each shard's block of the inputs and the
    carry (whole or per-shard) on its device."""
    parts = [_stack_shards(x, mesh) for x in (comb, degrees, k0, max_steps,
                                               reset)]
    vecs = [None if v is None else _stack_shards(v, mesh)
            for v in (spec, cancel)]
    shards = carry_shards(carry, mesh)
    return ks.new_mesh_lanes([
        slice_lanes(*(x[i] for x in parts), shards[i], planes=planes,
                    stall_window=stall_window, stages=stages,
                    device=mesh.devices[i],
                    spec=None if vecs[0] is None else vecs[0][i],
                    cancel=None if vecs[1] is None else vecs[1][i])
        for i in range(mesh.n)])


def _mesh_rounds(M: ks.MeshLanes, n: int, staged: bool, timing: bool) -> None:
    """Enqueue ``n`` mesh supersteps (on the CPU: until the live word
    drops)."""
    cpu = M.device.type == "cpu"
    for _ in range(n):
        if cpu and not int(M.ctrl[ks.CTRL_LIVE]):
            return
        ks.mesh_superstep(M, staged, timing)


def run_mesh_slice(M: ks.MeshLanes, *, slice_steps: int, staged: bool,
                   timing: bool = False) -> list:
    """``run_slice`` over a lane mesh: every shard's partial K16 (the last
    folding), then at most ``slice_steps`` mesh supersteps, enqueued without a host
    sync. Returns the sharded carry, advanced in place."""
    if int(slice_steps) < 1:
        raise ValueError(f"slice_steps must be >= 1, got {slice_steps}")
    M.set_budget(int(slice_steps))
    ks.mesh_reset(M, timing)
    _mesh_rounds(M, int(slice_steps), staged, timing)
    return [tuple(c) for c in M.carry]


def batched_sweep_kernel_sharded(mesh: LaneMesh, comb, degrees, k0,
                                 max_steps, planes: int,
                                 stall_window: int = DEFAULT_STALL_WINDOW,
                                 stages=None) -> list:
    """:func:`batched_sweep` with the lanes split over ``mesh`` (sync
    mode's sharded dispatch; ``B`` a multiple of the mesh size): returns
    each shard's result slots ``(p1, s1, st1, used, p2, s2, st2)``
    (:func:`sharded_home` brings them home whole)."""
    degrees = _stack_shards(degrees, mesh)
    per, v = degrees[0].shape
    stages, _pads, a0 = resolve_stages(stages, v)
    parts = [_stack_shards(x, mesh) for x in (comb, k0, max_steps)]
    shards = []
    for i, d in enumerate(mesh.devices):
        carry = [torch.empty(kcar.slot_shape(j, per, v, a0),
                             dtype=torch.int32, device=d)
                 for j in range(CARRY_LEN)]
        shards.append(ks.new_lanes(
            carry, parts[0][i], degrees[i], parts[1][i], parts[2][i],
            torch.ones(per, dtype=torch.int32, device=d),
            _ladder_ctrl(stages, d), planes=planes,
            stall_window=stall_window, budget=ks.INT32_MAX))
    M = ks.new_mesh_lanes(shards)
    staged = is_staged(stages)
    ks.mesh_reset(M)
    while int(M.ctrl[ks.CTRL_LIVE]):  # one host read per chunk
        _mesh_rounds(M, SWEEP_CHUNK, staged, False)
    return [tuple(L.carry[OUT0:OUT0 + N_OUT]) for L in M.shards]


def _spec_vectors(spec, cancel, b: int):
    """The sharded slice's speculation vectors: an omitted one becomes an
    all-zero int32[b] vector, the no-op tags (no lane tagged, none
    cancelled), so such a slice equals the plain one byte for byte."""
    if spec is None:
        spec = np.zeros(b, np.int32)
    if cancel is None:
        cancel = np.zeros(b, np.int32)
    return spec, cancel


def _sharded_slice(mesh, comb, degrees, k0, max_steps, reset, carry, spec,
                   cancel, donate: bool, *, planes, slice_steps,
                   stall_window, timing, stages) -> list:
    b = sum(t.shape[0] for t in degrees) if isinstance(
        degrees, (list, tuple)) else degrees.shape[0]
    spec, cancel = _spec_vectors(spec, cancel, b)
    if not donate:
        carry = [[t.clone() for t in c] for c in carry_shards(carry, mesh)]
    M = mesh_lanes(mesh, comb, degrees, k0, max_steps, reset, carry,
                   planes=planes, stall_window=stall_window, stages=stages,
                   spec=spec, cancel=cancel)
    return run_mesh_slice(M, slice_steps=slice_steps,
                          staged=is_staged(stages), timing=timing)


def batched_slice_kernel_sharded(mesh: LaneMesh, comb, degrees, k0,
                                 max_steps, reset, carry, spec=None,
                                 cancel=None, *, planes: int,
                                 slice_steps: int,
                                 stall_window: int = DEFAULT_STALL_WINDOW,
                                 timing: bool = False, stages=None) -> list:
    """:func:`batched_slice` over a lane mesh (continuous mode's sharded
    dispatch): the inputs whole or per shard, ``carry`` whole or sharded
    (left as it was: the slice runs on a copy); omitted spec/cancel
    vectors are the all-zero no-op tags. Returns the sharded carry."""
    return _sharded_slice(mesh, comb, degrees, k0, max_steps, reset, carry,
                          spec, cancel, False, planes=planes,
                          slice_steps=slice_steps, stall_window=stall_window,
                          timing=timing, stages=stages)


def batched_slice_kernel_sharded_donated(mesh: LaneMesh, comb, degrees, k0,
                                         max_steps, reset, carry, spec=None,
                                         cancel=None, *, planes: int,
                                         slice_steps: int,
                                         stall_window: int =
                                         DEFAULT_STALL_WINDOW,
                                         timing: bool = False,
                                         stages=None) -> list:
    """:func:`batched_slice_kernel_sharded` advancing a sharded carry on
    its devices in place (the device-resident carry's dispatch); returns
    it."""
    return _sharded_slice(mesh, comb, degrees, k0, max_steps, reset, carry,
                          spec, cancel, True, planes=planes,
                          slice_steps=slice_steps, stall_window=stall_window,
                          timing=timing, stages=stages)


def seat_lane_kernel_sharded(mesh: LaneMesh, stacks, seats) -> int:
    """K17 over sharded stacks (n per-shard ``(comb, degrees, k0,
    max_steps, reset)``): a wave of ``seats`` ``(lane, comb, degrees, k0,
    max_steps)`` (global lanes, numpy rows) split by owning shard, one K17
    launch on each shard that has seats (a lane seated twice keeps its
    last seat). Returns the bytes uploaded."""
    if len(stacks) != mesh.n:
        raise ValueError(f"{len(stacks)} stack shards for a mesh of {mesh.n}")
    per = stacks[0][1].shape[0]
    by_shard: dict = {}
    for lane, *rest in seats:
        lane = int(lane)
        if not 0 <= lane < per * mesh.n:
            raise ValueError(f"seat lane {lane} outside 0..{per * mesh.n - 1}")
        by_shard.setdefault(lane // per, []).append((lane % per, *rest))
    total = 0
    for s, wave in sorted(by_shard.items()):
        with ks.current_card(mesh.devices[s]):
            total += seat_lanes(stacks[s], wave)
    return total


def permute_carry_kernel_sharded(mesh: LaneMesh, carry, src, dst,
                                 b_new: int) -> list:
    """K18's mesh instance, once a new shard: the sharded carry of a pool
    resized to ``b_new`` lanes, global row ``dst[i]`` old global lane
    ``src[i]`` (host ints; a kept lane may cross shards), every other row
    idle. Returns n new per-shard carries (``carry`` is left as it is)."""
    if len(src) != len(dst) or len(set(int(d) for d in dst)) != len(dst):
        raise ValueError("permute_carry_kernel_sharded: src and dst must pair "
                         "up and dst must be distinct")
    if len(carry) != mesh.n:
        raise ValueError(f"{len(carry)} carry shards for a mesh of {mesh.n}")
    per_old = carry[0][CARRY_PACKED].shape[0]
    per_new = mesh.per(b_new)
    rows = [[(-1, -1)] * per_new for _ in range(mesh.n)]
    for a, d in zip(src, dst):
        a, d = int(a), int(d)
        if not (0 <= a < per_old * mesh.n and 0 <= d < b_new):
            raise ValueError(f"permute_carry_kernel_sharded: {a} -> {d} out "
                             f"of range ({per_old * mesh.n} -> {b_new} lanes)")
        rows[d // per_new][d % per_new] = (a // per_old, a % per_old)
    return _gathers(mesh, [c[CARRY_PACKED].device for c in carry],
                    lambda s, dev: kcar.carry_permute_mesh(
                        carry, rows[s], per_new, dev))


def resize_inputs_kernel_sharded(mesh: LaneMesh, stacks, src, dummy_comb,
                                 dummy_max_steps: int) -> list:
    """K19's mesh instance, once a new shard: sharded stacks of ``len(src)``
    lanes, global row ``i`` old global lane ``src[i]`` (a row may cross
    shards) or, past the old width, the class dummy (``dummy_comb``, copied
    to each shard's device, zero degrees, ``k0`` 1,
    ``dummy_max_steps``); reset all 0. Returns n per-shard ``(comb,
    degrees, k0, max_steps, reset)``."""
    if len(stacks) != mesh.n:
        raise ValueError(f"{len(stacks)} stack shards for a mesh of {mesh.n}")
    per_old = stacks[0][1].shape[0]
    b_old = per_old * mesh.n
    per_new = mesh.per(len(src))
    def gather(s, dev):
        rows = []
        for a in src[s * per_new:(s + 1) * per_new]:
            a = int(a)
            rows.append((a // per_old, a % per_old) if 0 <= a < b_old
                        else (-1, -1))
        return kcar.inputs_resize_mesh(
            [st[:4] for st in stacks], rows, _on(dummy_comb, dev), 1,
            int(dummy_max_steps), dev)

    return _gathers(mesh, [st[1].device for st in stacks], gather)


def _gathers(mesh: LaneMesh, old_devices: list, gather) -> list:
    """``gather(s, device)`` for each new shard ``s``, on its device's
    current stream. A gather reads every old shard, so on a mesh over
    several cards it is ordered by events: each gather waits for the old
    shards' cards (their last writes), and each old shard's card waits for
    every gather, so memory the caller frees after the resize is not
    reused on its card while another card still reads it. On one card the
    stream's order is enough."""
    cards = {d for d in list(old_devices) + list(mesh.devices)
             if d.type == "cuda"}
    spread = len(cards) > 1
    olds = sorted({d for d in old_devices if d.type == "cuda"}, key=str)
    ready = {}
    if spread:
        for d in olds:
            ready[d] = torch.cuda.Event()
            ready[d].record(torch.cuda.current_stream(d))
    out = []
    for s, dev in enumerate(mesh.devices):
        with ks.current_card(dev):
            if spread:
                stream = torch.cuda.current_stream(dev)
                for d, ev in ready.items():
                    if d != dev:
                        stream.wait_event(ev)
            out.append(gather(s, dev))
            if spread:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                for d in olds:
                    if d != dev:
                        torch.cuda.current_stream(d).wait_event(done)
    return out


# -- slice-size policy ----------------------------------------------------

# Per-dispatch overhead vs per-superstep compute, by backend: the slice
# size S trades them (``dgc_tpu.serve.batched``'s constants, kept as they
# are: the "gpu" pair is the JAX package's guess, not a measurement on the
# H100 — PERF.md records the measured split).
_DISPATCH_OVERHEAD_S = {"tpu": 65e-3, "gpu": 10e-3, "cpu": 0.6e-3}
_ENTRIES_PER_S = {"tpu": 1.0e10, "gpu": 5e9, "cpu": 1.5e8}


def priced_slice_steps(overhead_s: float, superstep_s: float, *,
                       overhead_frac: float = 0.125, lo: int = 4,
                       hi: int = 64) -> int:
    """The slice-size pricing rule itself: the smallest S keeping the
    per-dispatch overhead ≤ ``overhead_frac`` of slice compute, clamped
    to [lo, hi]. ``auto_slice_steps`` feeds it the static per-backend
    model; the scheduler's timing-column recalibration
    (``serve.engine.BatchScheduler``) feeds it MEASURED overhead and
    post-ladder-median superstep seconds instead."""
    s = math.ceil(overhead_s / (overhead_frac * max(superstep_s, 1e-9)))
    return int(min(hi, max(lo, s)))


def auto_slice_steps(entries: int, b_pad: int, platform: str | None = None,
                     *, overhead_frac: float = 0.125, lo: int = 4,
                     hi: int = 64) -> int:
    """Priced slice size for a pool of ``b_pad`` lanes of a class with
    ``entries`` gathered table entries per lane-superstep
    (``ShapeClass.entries()``); ``platform`` "gpu" or "cpu" (default: the
    card when there is one)."""
    plat = platform or ("gpu" if torch.cuda.is_available() else "cpu")
    overhead = _DISPATCH_OVERHEAD_S.get(plat, 1e-3)
    rate = _ENTRIES_PER_S.get(plat, 5e8)
    superstep_s = max(b_pad * entries / rate, 1e-9)
    return priced_slice_steps(overhead, superstep_s,
                              overhead_frac=overhead_frac, lo=lo, hi=hi)


def finish_pair(member, p1, s1, st1, used, p2, s2, st2, attempt_fallback):
    """Host epilogue for one member — mirrors the single-graph
    ``CompactFrontierEngine.sweep`` + ``engine.base.finish_sweep_pair``
    contract exactly: no confirm after a non-success first attempt,
    ``k2 < 1`` fabricates the trivial empty-budget FAILURE, a STALLED
    confirm falls back to ``attempt_fallback(k2)`` (the single-graph
    attempt owns the widen-and-retry loop; unreachable for covering
    windows short of a genuine stall).

    Colors are already in original vertex ids (no relabeling); rows past
    the real V are padding and trimmed here."""
    from dgc_tpu_torch.engine.base import finish_sweep_pair

    v = member.num_vertices

    def _finish(packed, status, steps, k) -> AttemptResult:
        packed = to_host(packed)[:v]
        colors = np.where(packed >= 0, packed >> 1, -1).astype(np.int32)
        return AttemptResult(AttemptStatus(int(status)), colors,
                             int(steps), int(k))

    first = _finish(p1, st1, s1, member.k0)
    return finish_sweep_pair(
        first, int(used), int(st2),
        lambda k2: _finish(p2, st2, s2, k2),
        v, attempt_fallback,
    )


def finish_attempt(member, p1, s1, st1, k: int) -> AttemptResult:
    """Host epilogue for one attempt-only lane: decode the first-attempt
    result slots exactly as :func:`finish_pair` decodes slot 1."""
    v = member.num_vertices
    packed = to_host(p1)[:v]
    colors = np.where(packed >= 0, packed >> 1, -1).astype(np.int32)
    return AttemptResult(AttemptStatus(int(st1)), colors, int(s1), int(k))
