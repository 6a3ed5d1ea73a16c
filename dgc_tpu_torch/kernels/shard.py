"""Wrappers of the vertex-sharded engines' kernels (``csrc/shard.cu``),
their plain PyTorch versions, and the shard control block and state they
share.

- ``shard_superstep`` (K20): one superstep of the flat sharded engine over
  the shard's rows, against the all-gathered state (buffer 0 of
  ``state``), the neighbor priority read from the degrees; the new words
  into buffer 1 at their global rows, the fail count (when
  ``fail_valid``), active count and ``mc`` into the control block. It
  takes the table's plan, each row's real length (``real_lengths``, taken
  once where the engine builds the table): on the card a row gets a group
  of ``team_lanes(W)`` lanes that walks only its real entries, and a
  confirmed row reads none.
- ``shard_finish`` (K21): the superstep's tail after the collectives: the
  ring push of the shard's pre-step words, the new words into the carry
  unless the step failed, the max color when the attempt ends, the live
  counts' commit, the next step's gather calls, the status; its recording
  variant also writes the trajectory row.
- ``shard_pair`` (K22): the fused pair's phase step after phase 0: ``used``
  from the max-reduced max color, the confirm's budget and its start from
  the ring or from scratch, or the end of the pair.

State on each rank (``new_shard_state``): int32[2, V+2], V the padded
vertex count; buffer 0 receives the all-gather of the shard's carry
``packed`` (int32[V_l]) and holds the pad sentinel −1 at V and the dummy
row 0 at V+1, buffer 1 the shard's new words. The kernels read buffer 0
only: ``cur`` stays 0. The control block is ``SC_LEN`` int32 (``SC_*``):
the first eight slots are ``kernels.superstep``'s, ``SC_GC``/``SC_MAXC``
the step's gather calls and the attempt's max color, ``SC_DONE`` the
finish kernels' block counter, then the ring's count and best candidate,
the budget, the pair's phase and phase 0's result slots. The collectives
reduce ``SUM_SLOTS`` ([fail, active]) and ``MAX_SLOTS`` ([mc, gc, maxc]);
its first ``kernels.compact.CTRL_LEN`` slots are the control block K5, K7
and K8 take.

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel (``rec_launch_counts`` those
of the recording variant): a wrapper adds one where it launches and
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.compact import (LIVE_BA, LIVE_BA_NEXT, LIVE_ROWS,
                                           LIVE_TIER, LIVE_TIER_NEXT,
                                           META_COLS, REC_SLOTS, _clamp_k,
                                           _raise_on)
from dgc_tpu_torch.kernels.superstep import (CTRL_ACTIVE, CTRL_CUR, CTRL_FAIL,
                                             CTRL_MC, CTRL_PREV_ACTIVE,
                                             CTRL_STALL, CTRL_STATUS,
                                             CTRL_STEP, INT32_MAX,
                                             _check_int32, _stream,
                                             check_plan, finish_step)
from dgc_tpu_torch.layout import TRAJ_COLS
from dgc_tpu_torch.obs.kernel import trajstep
from dgc_tpu_torch.ops.speculative import beats_rule, speculative_update_mc

# the slots after the first eight (kGc ... kResumed in csrc/shard.cu)
(SC_GC, SC_MAXC, SC_DONE, SC_REC_CNT, SC_REC_BEST, SC_K, SC_PHASE,
 SC_STEPS1, SC_STATUS1, SC_USED, SC_RESUMED) = range(8, 19)
SC_LEN = 19
SUM_SLOTS = slice(CTRL_FAIL, CTRL_MC)  # [fail, active]
MAX_SLOTS = slice(CTRL_MC, SC_DONE)    # [mc, gc, maxc]
_RUNNING = int(AttemptStatus.RUNNING)
_SUCCESS = int(AttemptStatus.SUCCESS)

SOURCE = "shard.cu"

launch_counts = {"shard_superstep": 0, "shard_finish": 0, "shard_pair": 0}
# the recording variant's launches (B11), apart from the kernels above
rec_launch_counts = {"shard_finish_rec": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, rec_launch_counts):
        for name in counts:
            counts[name] = 0


def new_shard_ctrl(step: int, prev_active: int, k: int, gc: int,
                   device) -> torch.Tensor:
    """A control block of phase 0 at budget ``k``: RUNNING at ``step``,
    counters cleared, the next gather calls ``gc``, an empty ring."""
    c = [_RUNNING, step, prev_active, 0, 0, 0, 0, -1, gc, -1, 0, 0, -1,
         int(k), 0, 0, 0, 0, -1]
    return torch.tensor(c, dtype=torch.int32, device=device)


def new_shard_state(v_pad: int, device) -> torch.Tensor:
    """int32[2, V+2] shard state: the pad sentinel −1 at V and the dummy
    row 0 at V+1 in both buffers."""
    state = torch.zeros((2, v_pad + 2), dtype=torch.int32, device=device)
    state[:, v_pad] = -1
    return state


# ---- plain versions ---------------------------------------------------------

def shard_superstep_reference(ctrl: torch.Tensor, state: torch.Tensor,
                              nbrs: torch.Tensor, lens: torch.Tensor,
                              deg: torch.Tensor, row_off: int, planes: int,
                              k: int, fail_valid: bool) -> None:
    """K20's plain version: ``ops.speculative`` over the shard's rows with
    ``beats_rule`` from the degrees (``deg`` int32[V+1], −1 at V), read up
    to the longest real row (``lens``, checked against the table: every
    entry past a row's length must be the pad sentinel V)."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    check_plan(nbrs, lens, state.shape[1] - 2)
    src = state[0]
    rows = nbrs.shape[0]
    ids = torch.arange(row_off, row_off + rows, dtype=torch.int32,
                       device=nbrs.device)
    nbrs = nbrs[:, :max(1, int(lens.max()))]
    nb = nbrs.to(torch.int64)
    beats = beats_rule(deg[nb], nbrs, deg[row_off: row_off + rows, None],
                       ids[:, None])
    new, fail_mask, active_mask, mc = speculative_update_mc(
        src[row_off: row_off + rows], src[nb], beats, k, planes)
    state[1, row_off: row_off + rows] = new
    if fail_valid:
        ctrl[CTRL_FAIL] += fail_mask.sum().to(torch.int32)
    ctrl[CTRL_ACTIVE] += active_mask.sum().to(torch.int32)
    ctrl[CTRL_MC] = torch.maximum(ctrl[CTRL_MC], mc)


def _next_gcalls(live, nh: int, gc_const: int) -> int:
    if gc_const < 0:
        return -1
    if live is None:
        return gc_const
    return gc_const + int((live[LIVE_BA, :nh] > 0).sum())


def shard_finish_reference(ctrl: torch.Tensor, packed: torch.Tensor,
                           back: torch.Tensor, ring, record: bool, live,
                           nh: int, gc_const: int, max_steps: int,
                           stall_window: int,
                           traj: torch.Tensor | None = None) -> None:
    """K21's plain version: ``_make_recstep`` and
    ``shard_superstep_epilogue`` on the reduced counters, with the
    trajectory row first when ``traj`` is given."""
    c = ctrl.tolist()
    if c[CTRL_STATUS] != _RUNNING:
        return
    step, fail, mc = c[CTRL_STEP], c[CTRL_FAIL], c[CTRL_MC]
    cnt, best = c[SC_REC_CNT], c[SC_REC_BEST]
    if traj is not None:
        trajstep(traj, step, c[CTRL_ACTIVE], fail > 0, mc, c[SC_GC])
    push = record and fail == 0 and mc > best
    if push:
        slot = cnt % REC_SLOTS
        ring[0][slot] = packed
        ring[1][slot] = (live[LIVE_BA] if live is not None else 0)
        ring[2][slot] = torch.tensor(
            [step, best, mc, c[CTRL_STALL], c[CTRL_PREV_ACTIVE]],
            dtype=torch.int32)
        cnt, best = cnt + 1, mc
    if fail == 0:
        packed.copy_(back)
        if live is not None:
            live[LIVE_BA, :nh] = live[LIVE_BA_NEXT, :nh]
            live[LIVE_TIER, :nh] = live[LIVE_TIER_NEXT, :nh]
    folded = finish_step(c, max_steps, stall_window)
    folded[CTRL_CUR] = 0
    maxc = c[SC_MAXC]
    if folded[CTRL_STATUS] != _RUNNING:
        colored = packed[packed >= 0]
        if colored.numel():
            maxc = max(maxc, int((colored >> 1).max()))
    ctrl.copy_(torch.tensor(
        folded + [_next_gcalls(live, nh, gc_const), maxc, 0, cnt, best]
        + c[SC_K:], dtype=torch.int32))


def shard_pair_reference(ctrl: torch.Tensor, packed: torch.Tensor,
                         p1: torch.Tensor, deg: torch.Tensor, init_word: int,
                         ring, live, nh: int, init_ba, init_step: int,
                         init_prev: int, gc_const: int) -> None:
    """K22's plain version: ``device_sweep_pair_resumable``'s phase step
    with ``restore_from_ring`` (the latest slot whose bracket holds k2)."""
    c = ctrl.tolist()
    if c[SC_PHASE] != 0 or c[CTRL_STATUS] == _RUNNING:
        return
    status1, used = c[CTRL_STATUS], c[SC_MAXC] + 1
    k2 = used - 1
    run2 = status1 == _SUCCESS and k2 >= 1
    meta = ring[2].tolist()
    hit = None
    for j in range(REC_SLOTS):
        if j < c[SC_REC_CNT] and meta[j][1] < k2 <= meta[j][2]:
            hit = j
    p1.copy_(packed)
    c[SC_STEPS1], c[SC_STATUS1], c[SC_USED], c[SC_DONE] = (
        c[CTRL_STEP], status1, used, 0)
    if not run2:
        c[SC_PHASE] = 2
        ctrl.copy_(torch.tensor(c, dtype=torch.int32))
        return
    if hit is not None:
        packed.copy_(ring[0][hit])
        step, _, _, stall, prev = meta[hit]
    else:
        packed.copy_(torch.where(deg == 0, 0, init_word).to(torch.int32))
        step, stall, prev = init_step, 0, init_prev
    if live is not None:
        live.zero_()
        live[LIVE_BA] = ring[1][hit] if hit is not None else init_ba
    c[:8] = [_RUNNING, step, prev, stall, 0, 0, 0, -1]
    c[SC_GC], c[SC_MAXC] = _next_gcalls(live, nh, gc_const), -1
    c[SC_K], c[SC_PHASE] = k2, 1
    c[SC_RESUMED] = step if hit is not None else -1
    ctrl.copy_(torch.tensor(c, dtype=torch.int32))


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_shard_superstep.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp,
                                            ci, ci, ci, ci, vp]
        lib.dgc_shard_superstep.restype = ci
        lib.dgc_shard_finish.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, vp,
                                         ci, ci, ci, ci, ci, vp, ci, ci, vp]
        lib.dgc_shard_finish.restype = ci
        lib.dgc_shard_pair.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp,
                                       ci, ci, vp, ci, ci, ci, vp]
        lib.dgc_shard_pair.restype = ci
        lib._dgc_bound = True
    return lib


def _check_ctrl(ctrl: torch.Tensor, device) -> None:
    _check_int32("ctrl", ctrl, device, 1)
    if ctrl.shape[0] != SC_LEN:
        raise ValueError(f"ctrl must be [{SC_LEN}]")


def _check_ring(ring, v_local: int, nb: int, device) -> None:
    for name, t in zip(("ring_pe", "ring_ba", "ring_meta"), ring):
        _check_int32(name, t, device, 2)
    shapes = tuple(tuple(t.shape) for t in ring)
    if shapes != ((REC_SLOTS, v_local), (REC_SLOTS, nb),
                  (REC_SLOTS, META_COLS)):
        raise ValueError(f"ring must be [4, {v_local}], [4, {nb}] and [4, 5], "
                         f"got {shapes}")


def _check_live(live, nh: int, device) -> int:
    """The live table's column count (1 without one)."""
    if live is None:
        if nh != 0:
            raise ValueError("nh conditioned buckets need a live table")
        return 1
    _check_int32("live", live, device, 2)
    if live.shape[0] != LIVE_ROWS or not 0 <= nh <= live.shape[1]:
        raise ValueError(f"live must be [{LIVE_ROWS}, nb >= {nh}]")
    return int(live.shape[1])


def shard_superstep(ctrl: torch.Tensor, state: torch.Tensor,
                    nbrs: torch.Tensor, lens: torch.Tensor, deg: torch.Tensor,
                    row_off: int, planes: int, k: int,
                    fail_valid: bool) -> None:
    """K20 over the shard rows ``[row_off, row_off + nbrs.shape[0])``
    (``nbrs`` int32[V_l, W] of global ids, sentinel V; ``lens`` int32[V_l]
    each row's real length, ``real_lengths(nbrs, V)``; ``deg`` int32[V+1],
    −1 at V). Runs on the current stream, does not synchronize."""
    device = state.device
    if device.type == "cpu":
        return shard_superstep_reference(ctrl, state, nbrs, lens, deg,
                                         row_off, planes, k, fail_valid)
    if device.type != "cuda":
        raise ValueError(f"shard_superstep: unsupported device {device}")
    _check_ctrl(ctrl, device)
    _check_int32("state", state, device, 2)
    _check_int32("nbrs", nbrs, device, 2)
    _check_int32("lens", lens, device, 1)
    _check_int32("deg", deg, device, 1)
    rows, width = nbrs.shape
    v = state.shape[1] - 2
    if state.shape[0] != 2 or deg.shape[0] != v + 1:
        raise ValueError(f"state must be [2, V+2] and deg [V+1], V={v}")
    if lens.shape[0] != rows:
        raise ValueError(f"lens must be [{rows}], got {tuple(lens.shape)}")
    if not (0 <= row_off and row_off + rows <= v):
        raise ValueError(f"rows [{row_off}, {row_off + rows}) outside [0, {v})")
    if not (1 <= planes <= INT32_MAX // 32 and width >= 1 and rows >= 1):
        raise ValueError(f"bad planes={planes} / width={width} / rows={rows}")
    _raise_on(_library().dgc_shard_superstep(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]),
        nbrs.data_ptr(), lens.data_ptr(), int(rows), int(width),
        deg.data_ptr(), int(row_off), int(planes), _clamp_k(k),
        int(bool(fail_valid)), _stream(device)), "shard_superstep")
    launch_counts["shard_superstep"] += 1


def shard_finish(ctrl: torch.Tensor, packed: torch.Tensor,
                 back: torch.Tensor, ring, record: bool, live, nh: int,
                 gc_const: int, max_steps: int, stall_window: int,
                 traj: torch.Tensor | None = None) -> None:
    """K21: ``packed`` the carry int32[V_l], ``back`` the shard's rows of
    buffer 1; ``ring`` (ring_pe int32[4, V_l], ring_ba int32[4, nb],
    ring_meta int32[4, 5]; ``engine.fused.shard_rec_empty``) or None when
    not recording; ``live`` the live table of ``nh`` conditioned buckets or
    None; its recording variant into ``traj`` when given. Runs on the
    current stream."""
    device = packed.device
    if device.type == "cpu":
        return shard_finish_reference(ctrl, packed, back, ring, record, live,
                                      nh, gc_const, max_steps, stall_window,
                                      traj=traj)
    if device.type != "cuda":
        raise ValueError(f"shard_finish: unsupported device {device}")
    _check_ctrl(ctrl, device)
    _check_int32("packed", packed, device, 1)
    _check_int32("back", back, device, 1)
    vl = packed.shape[0]
    if back.shape[0] != vl or vl < 1:
        raise ValueError(f"packed and back must be [V_l >= 1], got {vl} and "
                         f"{back.shape[0]}")
    nb = _check_live(live, nh, device)
    ring_ptrs = (None, None, None)
    if record:
        _check_ring(ring, vl, nb, device)
        ring_ptrs = tuple(t.data_ptr() for t in ring)
    name, counts, tptr, cap, cols = "shard_finish", launch_counts, None, 0, 0
    if traj is not None:
        _check_int32("traj", traj, device, 2)
        if traj.shape[1] < TRAJ_COLS or traj.shape[0] < 1:
            raise ValueError(f"traj must be [cap >= 1, cols >= {TRAJ_COLS}]")
        name, counts, tptr = "shard_finish_rec", rec_launch_counts, traj.data_ptr()
        cap, cols = int(traj.shape[0]), int(traj.shape[1])
    _raise_on(_library().dgc_shard_finish(
        ctrl.data_ptr(), packed.data_ptr(), back.data_ptr(), int(vl),
        *ring_ptrs, int(bool(record)),
        None if live is None else live.data_ptr(), int(nh), nb,
        int(gc_const), int(min(max_steps, INT32_MAX)),
        int(min(stall_window, INT32_MAX)), tptr, cap, cols, _stream(device)),
        name)
    counts[name] += 1


def shard_pair(ctrl: torch.Tensor, packed: torch.Tensor, p1: torch.Tensor,
               deg: torch.Tensor, init_word: int, ring, live, nh: int,
               init_ba, init_step: int, init_prev: int,
               gc_const: int) -> None:
    """K22: ``packed`` the carry, ``p1`` phase 0's result slot and ``deg``
    the shard's degrees (int32[V_l] each); the ring of phase 0; ``live``
    and ``init_ba`` (int32[nb]) or both None. Runs on the current
    stream."""
    device = packed.device
    if device.type == "cpu":
        return shard_pair_reference(ctrl, packed, p1, deg, init_word, ring,
                                    live, nh, init_ba, init_step, init_prev,
                                    gc_const)
    if device.type != "cuda":
        raise ValueError(f"shard_pair: unsupported device {device}")
    _check_ctrl(ctrl, device)
    vl = packed.shape[0]
    for name, t in (("packed", packed), ("p1", p1), ("deg", deg)):
        _check_int32(name, t, device, 1)
        if t.shape[0] != vl:
            raise ValueError(f"{name} must be [{vl}]")
    nb = _check_live(live, nh, device)
    if (live is None) != (init_ba is None):
        raise ValueError("live and init_ba go together")
    if init_ba is not None:
        _check_int32("init_ba", init_ba, device, 1)
        if init_ba.shape[0] != nb:
            raise ValueError(f"init_ba must be [{nb}]")
    _check_ring(ring, vl, nb, device)
    _raise_on(_library().dgc_shard_pair(
        ctrl.data_ptr(), packed.data_ptr(), p1.data_ptr(), deg.data_ptr(),
        int(vl), int(init_word), *(t.data_ptr() for t in ring),
        None if live is None else live.data_ptr(), int(nh), nb,
        None if init_ba is None else init_ba.data_ptr(), int(init_step),
        int(init_prev), int(gc_const), _stream(device)), "shard_pair")
    launch_counts["shard_pair"] += 1
