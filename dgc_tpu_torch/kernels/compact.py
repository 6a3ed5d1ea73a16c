"""Wrappers of the compact engine's kernels (``csrc/compact.cu``), their
plain PyTorch versions, and the control-block and ring layout they share.

- ``compact_slots`` (K3): the ordered slot list of a stage's active rows
  (``compact_idx``, the port of ``dgc_tpu.engine.compact._compact_idx``),
  after copying the current state buffer over the other one; on the card
  it takes a scratch its engine makes once (``new_slots_scratch``).
- ``stage_rows`` (K4): each slot's row of the flat table, clipped to its
  range's width, into the stage's flat layout, and the slots' state
  indices (the dummy slot ``V+1`` for unused slots).
- ``segmented_superstep`` (K5): one superstep over a whole plan
  (``ops.segmented_gather``), rows from a slot list or from ``row_base``
  on; adds the fail count, active count and ``mc`` to the control block.
  On the card a row takes a group of ``k5_lanes`` lanes (at
  ``K5_LANE_ENTRIES`` entries a lane), each segment whole warps
  (``k5_warps``).
- ``stage_finish`` (K6): the superstep epilogue: the prefix-resume ring
  push (the pre-step state, live counts and meta), stall, status, the
  commit of the hub region's staged live counts and prune tiers, and the
  flip, the last two unless the step failed.

Recording variants (B11, ``obs.kernel``), launched when a wrapper is
given the telemetry it fills:

- ``segmented_superstep`` with ``umax`` also takes the max count of
  unconfirmed real neighbors over the rows it evaluates that were active
  before the step, into ``umax[ucol]`` (the flat region's column of the
  unconf vector; ``kernels.hub`` fills the hub buckets' columns);
- ``stage_finish`` with a ``Telemetry`` also writes the superstep's
  trajectory row from the counters it folds, before it clears them: the
  active count, fail flag, ``mc``, the gather calls, max(``umax``), the
  timestamp (when ``timing``; −1 else), the bucket tail and the unconf
  tail, and clears ``umax``.

K5-K8 run a superstep only while the stage is live (``stage_live``): the
attempt RUNNING, its carried active count above the stage threshold and
its step below ``max_steps``; else they return at once, so a chunk of
enqueued supersteps can overrun a stage's end harmlessly.

The live table (``new_live``) is int32[5, nb]: per hub bucket, then the
flat region's total when there is one, the live counts ``ba``, their
staged next values, the prune tiers, their staged next values, and the
branch the hub kernels (``kernels.hub``) took this superstep.

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel (``rec_launch_counts`` those
of the recording variants): a wrapper adds one where it
launches and nowhere else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.superstep import (  # the first eight slots
    CTRL_ACTIVE, CTRL_CUR, CTRL_FAIL, CTRL_MC, CTRL_PREV_ACTIVE, CTRL_STALL,
    CTRL_STATUS, CTRL_STEP, INT32_MAX, LANE_ENTRIES, _check_int32, _stream,
    finish_step, team_lanes)
from dgc_tpu_torch.layout import TRAJ_COLS
from dgc_tpu_torch.obs.devclock import kernel_clock_us
from dgc_tpu_torch.obs.kernel import trajstep
from dgc_tpu_torch.ops.segmented_gather import (plan_rows, plan_size,
                                                plan_unconf_max,
                                                segmented_update)

# the control block is kernels.superstep's eight slots (kStatus ... kMc)
# and three more (kRecCnt, kRecBest, kDone): the ring's count and best
# candidate, and K6's block counter
CTRL_REC_CNT, CTRL_REC_BEST, CTRL_DONE = range(8, 11)
CTRL_LEN = 11
# the live table's rows (kLive* in csrc/rule.cuh)
LIVE_BA, LIVE_BA_NEXT, LIVE_TIER, LIVE_TIER_NEXT, LIVE_BRANCH = range(5)
LIVE_ROWS = 5
REC_SLOTS = 4   # prefix-resume ring: pre-states of the last 4 record steps
META_COLS = 5   # [step, best before, mc, stall, prev_active]
MAX_SEGS = 64   # segments a plan may have on the card (kMaxSegs)
_RUNNING = int(AttemptStatus.RUNNING)

SOURCE = "compact.cu"
# K5's lanes a row: the fewest (a power of two, at most 32) that hold the
# row at this many entries each (kLaneEntries in csrc/rule.cuh), the
# lanes of K1's and K23's groups too
K5_LANE_ENTRIES = LANE_ENTRIES
k5_lanes = team_lanes

launch_counts = {"compact_slots": 0, "stage_rows": 0,
                 "segmented_superstep": 0, "stage_finish": 0}
# the recording variants' launches (B11), apart from the kernels above
rec_launch_counts = {"segmented_superstep_rec": 0, "stage_finish_rec": 0}


class Telemetry(NamedTuple):
    """What K6's recording variant fills and reads: the attempt's
    trajectory buffer, the unconf vector the superstep kernels fill (K6
    clears it after each row), and the gather-call count of the superstep:
    ``gc_const`` plus one for each bucket of nonzero weight ``gc_w`` with
    live rows before the step."""

    traj: torch.Tensor  # int32[cap, 6 + 2·nt]
    umax: torch.Tensor  # int32[nt]: hub buckets, then the flat region
    gc_w: torch.Tensor  # int32[nt]
    gc_const: int
    timing: bool        # col 5: the clock (else −1)


def reset_launch_counts() -> None:
    for counts in (launch_counts, rec_launch_counts):
        for name in counts:
            counts[name] = 0


def new_ctrl(step: int, prev_active: int, device, stall: int = 0) -> torch.Tensor:
    """A control block: RUNNING at ``step``, state in buffer 0, counters
    cleared, an empty ring (count 0, best −1)."""
    return torch.tensor([_RUNNING, step, prev_active, stall, 0, 0, 0, -1,
                         0, -1, 0], dtype=torch.int32, device=device)


def new_state(pe_ext: torch.Tensor) -> torch.Tensor:
    """int32[2, V+2] state buffers, both holding ``pe_ext`` (the
    ``extend_packed`` layout: a fresh attempt's words, or a ring entry)."""
    return pe_ext.to(torch.int32).unsqueeze(0).repeat(2, 1).contiguous()


def extend_packed(packed: torch.Tensor) -> torch.Tensor:
    """``packed`` (int32[V]) with the pad sentinel −1 and the dummy row 0
    appended: the ``packed_ext`` layout (``dgc_tpu.engine.compact``)."""
    tail = torch.tensor([-1, 0], dtype=torch.int32, device=packed.device)
    return torch.cat([packed.to(torch.int32), tail])


def new_ring(v: int, nb: int, device) -> tuple[torch.Tensor, ...]:
    """(ring_pe int32[4, V+2], ring_ba int32[4, nb], ring_meta int32[4, 5])
    of an empty ring (``_empty_rec``)."""
    return (torch.zeros((REC_SLOTS, v + 2), dtype=torch.int32, device=device),
            torch.zeros((REC_SLOTS, nb), dtype=torch.int32, device=device),
            torch.full((REC_SLOTS, META_COLS), -1, dtype=torch.int32,
                       device=device))


def new_live(ba: torch.Tensor) -> torch.Tensor:
    """The live table of an attempt that starts from the live counts
    ``ba`` (int32[nb]): staged values, tiers and branches cleared (the
    prune state is fresh in every attempt, ``_fresh_prune``)."""
    live = torch.zeros((LIVE_ROWS, ba.shape[0]), dtype=torch.int32,
                       device=ba.device)
    live[LIVE_BA] = ba
    return live


def stage_live(c, thresh: int, max_steps: int) -> bool:
    """Does the stage run another superstep from control block ``c`` (a
    list)? The while conds of ``dgc_tpu.engine.compact._staged_pipeline``."""
    return (c[CTRL_STATUS] == _RUNNING and c[CTRL_PREV_ACTIVE] > thresh
            and c[CTRL_STEP] < max_steps)


@lru_cache(maxsize=256)
def k5_warps(plan: tuple) -> int:
    """K5's warps over ``plan``: each segment's rows at ``32 / lanes`` a
    warp, rounded up to whole warps (seg_warps in csrc/compact.cu)."""
    return sum(-(-s.rows * k5_lanes(s.width) // 32) for s in plan)


def plan_desc(plan: tuple, device) -> torch.Tensor:
    """int32[S, 5] (row0, rows, width, planes, flat0) of a plan, the
    kernels' view of it."""
    return torch.tensor([list(s) for s in plan], dtype=torch.int32,
                        device=device).reshape(len(plan), 5)


# ---- plain versions ---------------------------------------------------------

def compact_idx(act: torch.Tensor, pad: int, n: int) -> torch.Tensor:
    """Ordered index list of the ≤ ``pad`` active positions of ``act``
    (bool[n]); unused slots hold the dummy index ``n``. Port of
    ``dgc_tpu.engine.compact._compact_idx``."""
    pos = torch.cumsum(act.to(torch.int32), 0).to(torch.int32) - 1
    idx = torch.full((pad,), n, dtype=torch.int32, device=act.device)
    keep = act & (pos < pad)  # actives past pad are dropped
    idx[pos[keep].to(torch.int64)] = torch.arange(
        act.shape[0], dtype=torch.int32, device=act.device)[keep]
    return idx


def compact_slots_reference(ctrl: torch.Tensor, state: torch.Tensor,
                            row0: int, pad: int) -> torch.Tensor:
    """K3's plain version: copy buffer ``cur`` over the other one's rows
    ``[row0, V)`` and compact those rows' actives."""
    cur = int(ctrl[CTRL_CUR])
    v = state.shape[1] - 2
    src = state[cur, row0:v]
    state[1 - cur, row0:v] = src
    return compact_idx((src < 0) | ((src & 1) == 1), pad, v - row0)


def stage_rows_reference(flat_ext: torch.Tensor, idx: torch.Tensor,
                         plan: tuple, row0: int, v: int):
    """K4's plain version: ``(seg int32[plan_size], gidx int32[pad])``."""
    rows = idx.to(torch.int64)
    seg = torch.cat([flat_ext[rows[s.row0: s.row0 + s.rows], : s.width]
                     .reshape(-1) for s in plan])
    n = flat_ext.shape[0] - 1
    gidx = torch.where(idx == n, v + 1, idx + row0).to(torch.int32)
    return seg, gidx


def segmented_superstep_reference(ctrl: torch.Tensor, state: torch.Tensor,
                                  seg: torch.Tensor, plan: tuple, k: int,
                                  thresh: int, max_steps: int,
                                  gidx: torch.Tensor | None = None,
                                  row_base: int = 0,
                                  umax: torch.Tensor | None = None,
                                  ucol: int = 0) -> None:
    """K5's plain version: ``ops.segmented_gather.segmented_update`` over
    the state buffer ``cur``, written into the other one; with ``umax``,
    ``plan_unconf_max`` into ``umax[ucol]``."""
    if not stage_live(ctrl.tolist(), thresh, max_steps):
        return
    cur = int(ctrl[CTRL_CUR])
    src, dst = state[cur], state[1 - cur]
    if gidx is None:
        rows = slice(row_base, row_base + plan_rows(plan))
    else:
        rows = gidx.to(torch.int64)
    if umax is not None:
        u = plan_unconf_max(src, seg, plan, src[rows], state.shape[1] - 2)
        umax[ucol] = max(int(umax[ucol]), u)
    new, fail, act, mc = segmented_update(src, seg, plan, src[rows], k)
    dst[rows] = new  # duplicate slots are the dummy row: same word
    ctrl[CTRL_FAIL] += fail
    ctrl[CTRL_ACTIVE] += act
    ctrl[CTRL_MC] = torch.maximum(ctrl[CTRL_MC], mc)


def stage_finish_reference(ctrl: torch.Tensor, state: torch.Tensor,
                           ring, live: torch.Tensor, hub_buckets: int,
                           thresh: int, max_steps: int, stall_window: int,
                           record: bool, tel: Telemetry | None = None) -> None:
    """K6's plain version: ``_make_recstep`` and ``_superstep_epilogue``,
    with the trajectory row (``trajstep``) first when ``tel`` is given."""
    c = ctrl.tolist()
    if not stage_live(c, thresh, max_steps):
        return
    step, prev, stall, cur, fail, mc, cnt, best = (
        c[i] for i in (CTRL_STEP, CTRL_PREV_ACTIVE, CTRL_STALL, CTRL_CUR,
                       CTRL_FAIL, CTRL_MC, CTRL_REC_CNT, CTRL_REC_BEST))
    if tel is not None:
        nt, nh = tel.umax.shape[0], hub_buckets
        ba, nxt = live[LIVE_BA].tolist(), live[LIVE_BA_NEXT].tolist()
        gcalls = tel.gc_const + sum(1 for w, a in zip(tel.gc_w.tolist(), ba)
                                    if w != 0 and a > 0)
        tail = nxt[:nh] + ([c[CTRL_ACTIVE] - sum(nxt[:nh])] if nt > nh else [])
        trajstep(tel.traj, step, c[CTRL_ACTIVE], fail > 0, mc, gcalls, tail,
                 tel.umax.tolist(),
                 kernel_clock_us(state.device) if tel.timing else -1)
        tel.umax.zero_()
    if record and fail == 0 and mc > best:
        slot = cnt % REC_SLOTS
        ring[0][slot] = state[cur]
        ring[1][slot] = live[LIVE_BA]
        ring[2][slot] = torch.tensor([step, best, mc, stall, prev],
                                     dtype=torch.int32)
        cnt, best = cnt + 1, mc
    if fail == 0:
        nh = hub_buckets
        live[LIVE_BA, :nh] = live[LIVE_BA_NEXT, :nh]
        live[LIVE_TIER, :nh] = live[LIVE_TIER_NEXT, :nh]
        if live.shape[1] > nh:  # the flat region's total
            live[LIVE_BA, nh] = c[CTRL_ACTIVE] - int(live[LIVE_BA_NEXT, :nh].sum())
    # max_steps was tested before the step (stage_live): no ELL stall rule
    ctrl.copy_(torch.tensor(finish_step(c, INT32_MAX, stall_window)
                            + [cnt, best, 0], dtype=torch.int32))


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dgc_compact_slots_grid_max.argtypes = []
        lib.dgc_compact_slots_grid_max.restype = ci
        lib.dgc_compact_slots.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, ci,
                                          vp]
        lib.dgc_compact_slots.restype = ci
        lib.dgc_stage_rows.argtypes = [vp, ci, ci, vp, ci, vp, ci, cll, ci, ci,
                                       vp, vp, vp]
        lib.dgc_stage_rows.restype = ci
        lib.dgc_segmented_superstep.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp,
                                                ci, ci, ci, ci, ci, vp, ci, vp]
        lib.dgc_segmented_superstep.restype = ci
        lib.dgc_stage_finish.argtypes = [vp, vp, ci, vp, vp, vp, vp, ci, ci,
                                         ci, ci, ci, ci, vp, ci, ci, vp, vp,
                                         ci, ci, ci, vp]
        lib.dgc_stage_finish.restype = ci
        lib._dgc_bound = True
    return lib


def _check_cuda(name: str, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")


def _check_state(ctrl: torch.Tensor, state: torch.Tensor, device) -> None:
    _check_int32("ctrl", ctrl, device, 1)
    _check_int32("state", state, device, 2)
    if ctrl.shape[0] != CTRL_LEN or state.shape[0] != 2 or state.shape[1] < 2:
        raise ValueError(f"ctrl must be [{CTRL_LEN}] and state [2, V+2]")


def _clamp_k(k: int) -> int:
    # a budget past every window acts as the full window, so clamping it
    # to the kernel's int32 is exact
    return max(-INT32_MAX, min(int(k), INT32_MAX))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def new_slots_scratch(device) -> torch.Tensor | None:
    """K3's scratch for one engine on ``device``: an epoch and one flag a
    block (int64[1 + the most blocks K3 launches there]), zeroed once
    here and never again — each launch takes the next epoch. None on the
    CPU, whose plain version needs none."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    _check_cuda("compact_slots", device)
    with torch.cuda.device(device):
        slots = _library().dgc_compact_slots_grid_max()
    if slots < 1:
        raise RuntimeError(f"compact_slots: no grid on {device}")
    return torch.zeros(1 + slots, dtype=torch.int64, device=device)


def _check_slots_scratch(scratch, device) -> None:
    if scratch is None:
        raise ValueError("compact_slots needs its scratch on the card "
                         "(new_slots_scratch)")
    if scratch.device != device:
        raise ValueError(f"scratch is on {scratch.device}, expected {device}")
    if scratch.dtype != torch.int64:
        raise TypeError(f"scratch must be int64, got {scratch.dtype}")
    if scratch.dim() != 1 or scratch.shape[0] < 2 or \
            not scratch.is_contiguous():
        raise ValueError(f"scratch must be a contiguous int64[1 + blocks], "
                         f"got shape {tuple(scratch.shape)}")


def compact_slots(ctrl: torch.Tensor, state: torch.Tensor, row0: int,
                  pad: int, scratch: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """K3: int32[pad] slot list of the active rows of ``[row0, V)`` of
    buffer ``cur`` (dummy ``V − row0``), after copying those rows of
    ``cur`` over the other buffer. On the card it needs ``scratch``
    (``new_slots_scratch``), used by one stream at a time; the CPU's
    plain version takes none. Runs on the current stream."""
    device = state.device
    if device.type == "cpu":
        return compact_slots_reference(ctrl, state, row0, pad)
    _check_cuda("compact_slots", device)
    _check_state(ctrl, state, device)
    _check_slots_scratch(scratch, device)
    v = state.shape[1] - 2
    n = v - row0
    if not (0 <= row0 < v and pad >= 1):
        raise ValueError(f"bad row0={row0} / pad={pad} for V={v}")
    idx = torch.empty(pad, dtype=torch.int32, device=device)
    _raise_on(_library().dgc_compact_slots(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]), int(row0),
        int(n), int(pad), idx.data_ptr(), scratch.data_ptr(),
        int(scratch.shape[0]) - 1, _stream(device)), "compact_slots")
    launch_counts["compact_slots"] += 1
    return idx


def stage_rows(flat_ext: torch.Tensor, idx: torch.Tensor, plan: tuple,
               desc: torch.Tensor, row0: int, v: int):
    """K4: ``(seg int32[plan_size], gidx int32[pad])`` of a stage whose
    plan (``plan_from_ranges``, device view ``desc``) covers the slot list
    ``idx``. Runs on the current stream."""
    device = idx.device
    if device.type == "cpu":
        return stage_rows_reference(flat_ext, idx, plan, row0, v)
    _check_cuda("stage_rows", device)
    _check_int32("flat_ext", flat_ext, device, 2)
    _check_int32("idx", idx, device, 1)
    _check_int32("desc", desc, device, 2)
    pad = idx.shape[0]
    n, w_flat = flat_ext.shape[0] - 1, flat_ext.shape[1]
    if plan_rows(plan) != pad or len(plan) > MAX_SEGS or \
            tuple(desc.shape) != (len(plan), 5):
        raise ValueError(f"plan of {plan_rows(plan)} rows / {len(plan)} "
                         f"segments does not fit {pad} slots")
    if max(s.width for s in plan) > w_flat:
        raise ValueError(f"a range is wider than the flat table ({w_flat})")
    total = plan_size(plan)
    seg = torch.empty(total, dtype=torch.int32, device=device)
    gidx = torch.empty(pad, dtype=torch.int32, device=device)
    _raise_on(_library().dgc_stage_rows(
        flat_ext.data_ptr(), int(w_flat), int(n), idx.data_ptr(), int(pad),
        desc.data_ptr(), len(plan), int(total), int(row0), int(v),
        seg.data_ptr(), gidx.data_ptr(), _stream(device)), "stage_rows")
    launch_counts["stage_rows"] += 1
    return seg, gidx


def segmented_superstep(ctrl: torch.Tensor, state: torch.Tensor,
                        seg: torch.Tensor, plan: tuple, desc, k: int,
                        thresh: int, max_steps: int,
                        gidx: torch.Tensor | None = None,
                        row_base: int = 0, umax: torch.Tensor | None = None,
                        ucol: int = 0) -> None:
    """K5 over ``plan`` (device view ``desc``): rows from the slot list
    ``gidx``, or rows ``row_base + r``; its recording variant into
    ``umax[ucol]`` when ``umax`` is given. Runs on the current stream, does
    not synchronize."""
    device = state.device
    if device.type == "cpu":
        return segmented_superstep_reference(
            ctrl, state, seg, plan, k, thresh, max_steps, gidx, row_base,
            umax=umax, ucol=ucol)
    _check_cuda("segmented_superstep", device)
    _check_state(ctrl, state, device)
    _check_int32("seg", seg, device, 1)
    _check_int32("desc", desc, device, 2)
    v = state.shape[1] - 2
    rows = plan_rows(plan)
    if len(plan) > MAX_SEGS or tuple(desc.shape) != (len(plan), 5):
        raise ValueError(f"plan of {len(plan)} segments: desc "
                         f"{tuple(desc.shape)}, at most {MAX_SEGS} segments")
    if seg.shape[0] != plan_size(plan):
        raise ValueError(f"seg holds {seg.shape[0]} entries, the plan "
                         f"{plan_size(plan)}")
    if gidx is not None:
        _check_int32("gidx", gidx, device, 1)
        if gidx.shape[0] != rows:
            raise ValueError(f"gidx holds {gidx.shape[0]} slots, the plan {rows}")
    elif not (0 <= row_base and row_base + rows <= v):
        raise ValueError(f"rows [{row_base}, {row_base + rows}) outside [0, {v})")
    if umax is not None:
        _check_int32("umax", umax, device, 1)
        if not 0 <= ucol < umax.shape[0]:
            raise ValueError(f"ucol {ucol} outside umax[{umax.shape[0]}]")
    if rows == 0:
        return
    name, counts = (("segmented_superstep", launch_counts) if umax is None
                    else ("segmented_superstep_rec", rec_launch_counts))
    _raise_on(_library().dgc_segmented_superstep(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]),
        seg.data_ptr(), desc.data_ptr(), len(plan), k5_warps(plan),
        None if gidx is None else gidx.data_ptr(), int(row_base), v + 1,
        _clamp_k(k), int(thresh), int(min(max_steps, INT32_MAX)),
        None if umax is None else umax.data_ptr(), int(ucol),
        _stream(device)), name)
    counts[name] += 1


def stage_finish(ctrl: torch.Tensor, state: torch.Tensor, ring,
                 live: torch.Tensor, hub_buckets: int, thresh: int,
                 max_steps: int, stall_window: int, record: bool,
                 tel: Telemetry | None = None) -> None:
    """K6; ``ring`` is ``new_ring``'s triple, or None when not recording;
    ``live`` the live table of ``hub_buckets`` hub buckets (``new_live``);
    its recording variant when ``tel`` is given. Runs on the current
    stream."""
    device = state.device
    if device.type == "cpu":
        return stage_finish_reference(
            ctrl, state, ring, live, hub_buckets, thresh, max_steps,
            stall_window, record, tel=tel)
    _check_cuda("stage_finish", device)
    _check_state(ctrl, state, device)
    _check_int32("live", live, device, 2)
    nb = live.shape[1]
    if live.shape[0] != LIVE_ROWS or not 0 <= hub_buckets <= nb <= hub_buckets + 1:
        raise ValueError(f"live must be [{LIVE_ROWS}, nb] with nb = "
                         f"{hub_buckets} or {hub_buckets + 1}")
    ring_pe = ring_ba = ring_meta = None
    if record:
        ring_pe, ring_ba, ring_meta = ring
        for name, t in (("ring_pe", ring_pe), ("ring_ba", ring_ba),
                        ("ring_meta", ring_meta)):
            _check_int32(name, t, device, 2)
        if tuple(ring_pe.shape) != (REC_SLOTS, state.shape[1]) or \
                tuple(ring_ba.shape) != (REC_SLOTS, nb) or \
                tuple(ring_meta.shape) != (REC_SLOTS, META_COLS):
            raise ValueError("ring must be [4, V+2], [4, nb] and [4, 5]")
    name, counts = "stage_finish", launch_counts
    rec = (None, 0, 0, None, None, 0, 0, 0)
    if tel is not None:
        name, counts = "stage_finish_rec", rec_launch_counts
        nt = tel.umax.shape[0]
        for n, t, ndim in (("traj", tel.traj, 2), ("umax", tel.umax, 1),
                           ("gc_w", tel.gc_w, 1)):
            _check_int32(n, t, device, ndim)
        if not hub_buckets <= nt <= nb or tel.gc_w.shape[0] != nt or \
                tel.traj.shape[1] != TRAJ_COLS + 2 * nt or tel.traj.shape[0] < 1:
            raise ValueError(f"traj must be [cap, {TRAJ_COLS} + 2·nt], umax "
                             f"and gc_w [nt], {hub_buckets} <= nt <= {nb}")
        rec = (tel.traj.data_ptr(), int(tel.traj.shape[0]),
               int(tel.traj.shape[1]), tel.umax.data_ptr(),
               tel.gc_w.data_ptr(), int(tel.gc_const), int(nt),
               int(bool(tel.timing)))
    _raise_on(_library().dgc_stage_finish(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]),
        *(None if t is None else t.data_ptr()
          for t in (ring_pe, ring_ba, ring_meta)),
        live.data_ptr(), int(hub_buckets), int(nb), int(thresh),
        int(min(max_steps, INT32_MAX)), int(min(stall_window, INT32_MAX)),
        int(bool(record)), *rec, _stream(device)), name)
    counts[name] += 1
