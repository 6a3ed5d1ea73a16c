"""Wrappers of the superstep kernels (``csrc/superstep.cu``), their plain
PyTorch versions, and the chunked superstep loop both engines run.

- ``superstep_rows`` (K1) is one superstep of the speculative rule over
  the rows ``[row0, row0+R)`` of one table, its gather included: it reads
  state buffer ``cur`` and writes the other one, and adds the rows' fail
  count (when ``fail_valid``), active count and max candidate ``mc`` to
  the control block. It takes the table's ``RowPlan`` (``row_plan``, built
  once with the table): each row's real length and the team that walks
  it, a group of ``team_lanes(width)`` lanes or, from ``K1_BLOCK_WIDTH``
  entries wide, a block of ``K1_BLOCK_THREADS``.
- ``superstep_finish`` (K2) folds those counters into the attempt's loop
  carry (status, step, stall rounds) and flips ``cur`` unless the step
  failed. Given a trajectory buffer it launches its recording variant,
  which first writes the step's row (``obs.kernel``): the active count,
  the fail flag and the gather calls it is passed, −1 elsewhere.

For tensors on the CPU each wrapper runs its plain version
(``*_reference``, built on ``ops.speculative``); for tensors on a card it
launches its kernel or raises — it never falls back. The plain versions
take tensors on any device, so a test on the card can hold a kernel
against them on the same inputs.

``launch_counts`` counts launches per kernel (``rec_launch_counts`` those
of the recording variants): a wrapper adds one where it
launches, and nowhere else (the CPU path and the plain versions do not
count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.layout import TRAJ_COLS
from dgc_tpu_torch.obs.kernel import trajstep
from dgc_tpu_torch.ops.speculative import (NBR_MASK, decode_combined,
                                           speculative_update_mc)

# control block slots (the kernel's kStatus ... kMc)
CTRL_STATUS, CTRL_STEP, CTRL_PREV_ACTIVE, CTRL_STALL, CTRL_CUR, \
    CTRL_FAIL, CTRL_ACTIVE, CTRL_MC = range(8)
CTRL_LEN = 8
INT32_MAX = (1 << 31) - 1
CHUNK_STEPS = 64  # supersteps enqueued per host sync (bucketed.py:340)
_RUNNING = int(AttemptStatus.RUNNING)

SOURCE = "superstep.cu"

# a group of lanes a row (K1, K5, K23): a lane holds the row's entries
# LANE_ENTRIES at a time (kLaneEntries in csrc/rule.cuh)
LANE_ENTRIES = 32
# K1's teams (kBlockWidth, kBlockThreads, kThreads in csrc/superstep.cu): a
# row of K1_BLOCK_WIDTH entries or more takes a block
K1_BLOCK_WIDTH = 4096
K1_BLOCK_THREADS = 512
K1_THREADS = 256

launch_counts = {"superstep_rows": 0, "superstep_finish": 0}
# the recording variant's launches (B11), apart from the kernels above
rec_launch_counts = {"superstep_finish_rec": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, rec_launch_counts):
        for name in counts:
            counts[name] = 0


def new_ctrl(step: int, prev_active: int, device) -> torch.Tensor:
    """A control block for a fresh attempt: RUNNING at ``step``, state in
    buffer 0, counters cleared."""
    return torch.tensor([_RUNNING, step, prev_active, 0, 0, 0, 0, -1],
                        dtype=torch.int32, device=device)


def new_state(packed0: torch.Tensor) -> torch.Tensor:
    """int32[2, V+1] state buffers: buffer 0 holds ``packed0``, slot V of
    both holds the −1 pad sentinel."""
    v = packed0.shape[0]
    state = torch.full((2, v + 1), -1, dtype=torch.int32, device=packed0.device)
    state[0, :v] = packed0
    return state


# ---- the plan ---------------------------------------------------------------

class RowPlan(NamedTuple):
    """K1's plan of one table: ``lens`` int32[rows] on the table's device,
    each row's real length; the team a row, ``lanes`` lanes (1-32) or a
    block (``block``)."""

    lens: torch.Tensor
    lanes: int
    block: bool


def team_lanes(width: int) -> int:
    """The lanes of a row of ``width`` entries (team_lanes in
    csrc/rule.cuh): the least power of two, at most 32, whose lanes hold
    the row at ``LANE_ENTRIES`` entries each."""
    lanes = 1
    while lanes < 32 and lanes * LANE_ENTRIES < width:
        lanes *= 2
    return lanes


def k1_grid(rows: int, width: int) -> int:
    """K1's blocks over ``rows`` rows of ``width``: one a row from
    ``K1_BLOCK_WIDTH``, else ``K1_THREADS // 32`` warps of ``32 / lanes``
    rows each."""
    if width >= K1_BLOCK_WIDTH:
        return rows
    per_block = (K1_THREADS // 32) * (32 // team_lanes(width))
    return -(-rows // per_block)


def k1_teams(rows: int, width: int) -> np.ndarray:
    """The row of each team of K1's grid over a table of ``rows`` rows
    (−1: a team past the last row), in the kernel's order: block-major,
    then warp, then the group within the warp."""
    teams = (k1_grid(rows, width) if width >= K1_BLOCK_WIDTH else
             k1_grid(rows, width) * (K1_THREADS // 32)
             * (32 // team_lanes(width)))
    t = np.arange(teams, dtype=np.int64)
    return np.where(t < rows, t, -1)


def real_lengths(table: torch.Tensor, v: int) -> torch.Tensor:
    """int32[rows]: each row of ``table`` (combined entries, pad sentinel
    ``v``) one past its last entry that is not the sentinel (0 for a row
    of sentinels alone), on the table's device."""
    col = torch.arange(1, table.shape[1] + 1, dtype=torch.int32,
                       device=table.device)
    return torch.where((table & NBR_MASK) != v, col, 0).amax(dim=1).to(
        torch.int32) if table.shape[0] else col[:0]


def row_plan(table: torch.Tensor, v: int) -> RowPlan:
    """K1's plan of ``table`` (int32[rows, width], pad sentinel ``v``),
    taken once where the table is built."""
    width = table.shape[1]
    return RowPlan(real_lengths(table, v), team_lanes(width),
                   width >= K1_BLOCK_WIDTH)


def check_plan(table: torch.Tensor, lens: torch.Tensor, v: int) -> None:
    """A table's real lengths must hold every entry that is not the pad
    sentinel ``v``: raise where an entry past a row's length is not."""
    rows, width = table.shape
    if tuple(lens.shape) != (rows,):
        raise ValueError(f"lens must be [{rows}], got {tuple(lens.shape)}")
    if rows and not bool(((lens >= 0) & (lens <= width)).all()):
        raise ValueError(f"a length outside [0, {width}]")
    col = torch.arange(width, device=table.device)
    past = col[None, :] >= lens[:, None].to(col.dtype)
    if bool((past & ((table & NBR_MASK) != v)).any()):
        raise AssertionError("the plan's lengths cut off a real entry")


# ---- plain versions ---------------------------------------------------------

def superstep_rows_reference(ctrl: torch.Tensor, state: torch.Tensor,
                             table: torch.Tensor, row0: int, planes: int, k: int,
                             fail_valid: bool, plan: RowPlan) -> None:
    """K1's plain version: the rule of ``ops.speculative`` over one table,
    read up to its longest real row (``plan.lens``, checked against the
    table: every entry past a row's length must be the pad sentinel)."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    check_plan(table, plan.lens, state.shape[1] - 1)
    cur = int(ctrl[CTRL_CUR])
    src, dst = state[cur], state[1 - cur]
    rows = table.shape[0]
    if rows == 0:
        return
    width = max(1, int(plan.lens.max()))
    nb, beats = decode_combined(table[:, :width])
    new, fail_mask, active_mask, mc = speculative_update_mc(
        src[row0: row0 + rows], src[nb.to(torch.int64)], beats, k, planes)
    dst[row0: row0 + rows] = new
    if fail_valid:
        ctrl[CTRL_FAIL] += fail_mask.sum().to(torch.int32)
    ctrl[CTRL_ACTIVE] += active_mask.sum().to(torch.int32)
    ctrl[CTRL_MC] = torch.maximum(ctrl[CTRL_MC], mc)


def status_step(any_fail: bool, active: int, stall_rounds: int,
                stall_window: int) -> AttemptStatus:
    """The per-superstep status transition (FAILURE > SUCCESS > STALLED >
    RUNNING) of ``dgc_tpu.engine.bucketed.status_step``, on host scalars."""
    if any_fail:
        return AttemptStatus.FAILURE
    if active == 0:
        return AttemptStatus.SUCCESS
    if stall_rounds >= stall_window:
        return AttemptStatus.STALLED
    return AttemptStatus.RUNNING


def finish_step(c: list, max_steps: int, stall_window: int) -> list[int]:
    """The first eight slots of control block ``c`` (a list, RUNNING)
    after one superstep's fold: ``status_step``, plus the ELL engine's
    rule that the attempt stalls when step+1 reaches ``max_steps``; the
    flip unless the step failed; the counters cleared. The plain version
    of ``dgc::finish_step`` (``csrc/rule.cuh``), shared by K2 and K6."""
    _, step, prev_active, stall, cur, fail, active, _ = c[:CTRL_LEN]
    stall = 0 if active < prev_active else stall + 1
    status = status_step(fail > 0, active, stall, stall_window)
    if status == AttemptStatus.RUNNING and step + 1 >= max_steps:
        status = AttemptStatus.STALLED
    if fail == 0:
        cur ^= 1  # on failure the pre-step state stays current
    return [int(status), step + 1, active, stall, cur, 0, 0, -1]


def superstep_finish_reference(ctrl: torch.Tensor, max_steps: int,
                               stall_window: int,
                               traj: torch.Tensor | None = None,
                               gcalls: int = -1) -> None:
    """K2's plain version: ``finish_step`` on a RUNNING attempt, after the
    row write (``obs.kernel.trajstep``) when ``traj`` is given."""
    c = ctrl.tolist()
    if c[CTRL_STATUS] != _RUNNING:
        return
    if traj is not None:
        trajstep(traj, c[CTRL_STEP], c[CTRL_ACTIVE], c[CTRL_FAIL] > 0,
                 gcalls=gcalls)
    ctrl.copy_(torch.tensor(finish_step(c, max_steps, stall_window),
                            dtype=torch.int32))


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_superstep_rows.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, ci, ci, vp]
        lib.dgc_superstep_rows.restype = ci
        lib.dgc_superstep_finish.argtypes = [vp, ci, ci, vp, ci, ci, ci, vp]
        lib.dgc_superstep_finish.restype = ci
        lib._dgc_bound = True
    return lib


def _check_int32(name: str, t: torch.Tensor, device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def indexed_device(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def superstep_rows(ctrl: torch.Tensor, state: torch.Tensor, table: torch.Tensor,
                   row0: int, planes: int, k: int, fail_valid: bool,
                   plan: RowPlan) -> None:
    """K1 over table rows ``[row0, row0 + table.shape[0])`` by the table's
    ``plan``; see the module docstring. Runs on the current stream, does
    not synchronize."""
    device = table.device
    if device.type == "cpu":
        return superstep_rows_reference(ctrl, state, table, row0, planes, k,
                                        fail_valid, plan)
    if device.type != "cuda":
        raise ValueError(f"superstep_rows: unsupported device {device}")
    _check_int32("ctrl", ctrl, device, 1)
    _check_int32("state", state, device, 2)
    _check_int32("table", table, device, 2)
    _check_int32("lens", plan.lens, device, 1)
    rows, width = table.shape
    if plan.lens.shape[0] != rows:
        raise ValueError(f"the plan has {plan.lens.shape[0]} rows, the table "
                         f"{rows}")
    v = state.shape[1] - 1
    if ctrl.shape[0] != CTRL_LEN or state.shape[0] != 2:
        raise ValueError(f"ctrl must be [{CTRL_LEN}] and state [2, V+1]")
    if not (0 <= row0 and row0 + rows <= v):
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside [0, {v})")
    if not (1 <= planes <= INT32_MAX // 32 and width >= 1):
        raise ValueError(f"bad planes={planes} / width={width}")
    if rows == 0:
        return
    # a budget past the window acts as the full window (the masks
    # saturate), so clamping it to the kernel's int32 is exact
    k = max(-INT32_MAX, min(int(k), INT32_MAX))
    rc = _library().dgc_superstep_rows(
        ctrl.data_ptr(), state.data_ptr(), table.data_ptr(),
        plan.lens.data_ptr(), int(row0),
        int(rows), int(width), int(planes), k, int(bool(fail_valid)),
        int(state.shape[1]), _stream(device))
    if rc != 0:
        raise RuntimeError(f"superstep_rows launch failed: CUDA error {rc}")
    launch_counts["superstep_rows"] += 1


def superstep_finish(ctrl: torch.Tensor, max_steps: int,
                     stall_window: int, traj: torch.Tensor | None = None,
                     gcalls: int = -1) -> None:
    """K2, or its recording variant into ``traj`` (int32[cap, cols], cols
    >= 6) when given; see the module docstring. Runs on the current
    stream."""
    device = ctrl.device
    if device.type == "cpu":
        return superstep_finish_reference(ctrl, max_steps, stall_window,
                                          traj=traj, gcalls=gcalls)
    if device.type != "cuda":
        raise ValueError(f"superstep_finish: unsupported device {device}")
    _check_int32("ctrl", ctrl, device, 1)
    if ctrl.shape[0] != CTRL_LEN:
        raise ValueError(f"ctrl must be [{CTRL_LEN}]")
    name, counts, ptr, cap, cols = ("superstep_finish", launch_counts, None,
                                    0, 0)
    if traj is not None:
        _check_int32("traj", traj, device, 2)
        if traj.shape[1] < TRAJ_COLS or traj.shape[0] < 1:
            raise ValueError(f"traj must be [cap >= 1, cols >= {TRAJ_COLS}]")
        name, counts, ptr = ("superstep_finish_rec", rec_launch_counts,
                             traj.data_ptr())
        cap, cols = int(traj.shape[0]), int(traj.shape[1])
    rc = _library().dgc_superstep_finish(
        ctrl.data_ptr(), int(min(max_steps, INT32_MAX)),
        int(min(stall_window, INT32_MAX)), ptr, cap, cols, int(gcalls),
        _stream(device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    counts[name] += 1


def run_supersteps(ctrl: torch.Tensor, state: torch.Tensor, parts, k: int,
                   max_steps: int, stall_window: int,
                   traj: torch.Tensor | None = None,
                   gcalls: int = -1) -> list[int]:
    """Enqueue ``CHUNK_STEPS`` supersteps — K1 for every ``(row0, table,
    plan, planes, fail_valid)`` part, then K2 (recording into ``traj`` when
    given) — and read the control block back: the one host sync of the
    chunk. Steps enqueued after the attempt left RUNNING return at once on
    the card (and are skipped on the CPU)."""
    for _ in range(CHUNK_STEPS):
        for row0, table, plan, planes, fail_valid in parts:
            superstep_rows(ctrl, state, table, row0, planes, k, fail_valid,
                           plan)
        superstep_finish(ctrl, max_steps, stall_window, traj, gcalls)
        if ctrl.device.type == "cpu" and int(ctrl[CTRL_STATUS]) != _RUNNING:
            break
    return ctrl.tolist()
