"""Wrappers of the serve tier's batched kernels (``csrc/serve.cu``), their
plain PyTorch versions, and the buffers they share.

A batch of B lanes (graphs of one shape class, ``serve.shape_classes``)
runs one batched superstep at a time over the reference's 20-slot carry
(``layout.CARRY_*``, one lane-leading int32 tensor per slot):

- ``lane_reset`` (K16): the slice entry: re-init the flagged lanes from
  their inputs (``dgc_tpu.serve.batched._fresh_lanes``) and their back
  buffer rows; with the speculation plane's optional ``spec``/``cancel``
  vectors (``Lanes.arm_spec``), seat a flagged lane's spec tag and kill a
  cancelled spec-tagged lane that was not flagged (``_slice_kernel``'s
  speculation branch); the timing seed, the counters and the control
  block's routing.
- ``lane_compact`` (K14): at a staged rung, rebuild the slot list of each
  live lane whose list was built at a shallower rung (``_rebuild_idx``).
  It takes the lanes' ``compact_scratch`` (``new_compact_scratch``, made
  once with the lanes and never cleared): the epoch of the last launch
  that rebuilt, and on the card one flag a block, through which the
  blocks that share a lane's rows exchange their counts.
- ``lane_superstep`` (K13): the rule over every unconfirmed row (rung 0)
  or over the rung's unconfirmed slots of each live lane, each walked up
  to its degree (the table's real entries come first, the sentinel ``V``
  after them: ``check_lane_rows``), into ``nxt``; each lane's fail and
  active counts. It relies on ``nxt`` equal to ``packed`` at entry.
- ``lane_finish`` (K15): the transition and freeze of every lane, the
  adopt or revert of the step, the result slots (a spec-tagged lane runs
  no confirm), and the next superstep's routing; with ``timing`` it reads
  the clock once (``obs.devclock``).

Every kernel reads the control block's live word first and does nothing
when it is 0 (no lane running, or the slice's steps spent), so a slice is
enqueued without a host sync (``serve.batched``).

The lane mesh (``MeshLanes``: the lane axis split over n shards, each a
``Lanes`` with a control block of its own, ``serve.batched``'s sharded
section): K16 and K15 run per shard as their partial instances (the
shard's min rung, whether any of its lanes is live, the step count, into
its own control block), and with ``mesh=`` the mesh they belong to, their
tail is K26's fold: the last shard to finish writes the folded routing
(the min rung, any live and steps within the budget) into every shard's
control block (``mesh_tail_reference`` on the CPU: the plain partial, then
``lane_mesh_fold_reference``). On one card the shards' launches share a
stream, so the last shard's launch folds; across cards every shard takes
a ticket in shard 0's control block (``CTRL_MESH_TICKET``) and the one
that draws n - 1 folds. ``mesh_reset`` and ``mesh_superstep`` are
the host loops; across cards the rounds are ordered by events, never a
host sync. ``mesh_folds`` counts the folds made (on the card: a counter
on each mesh's first card, which the folding block adds to).

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel (``timing_launch_counts`` the
clock-reading instances among them, ``spec_launch_counts`` the launches of
K15/K16 on lanes armed with the speculation vectors,
``partial_launch_counts`` their partial instances): a wrapper adds one
where it launches and nowhere else.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass, field

import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.compact import compact_idx
from dgc_tpu_torch.kernels.superstep import _check_int32, _stream
from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_IDX_RUNG, CARRY_K,
                                  CARRY_LEN, CARRY_NC, CARRY_P1, CARRY_P2,
                                  CARRY_PACKED, CARRY_PHASE,
                                  CARRY_PREV_ACTIVE, CARRY_RUNG, CARRY_S1,
                                  CARRY_S2, CARRY_SPEC, CARRY_ST1, CARRY_ST2,
                                  CARRY_STALL, CARRY_STEP, CARRY_USED, T_PREV,
                                  T_US, US_MASK)
from dgc_tpu_torch.obs.devclock import kernel_clock_us
from dgc_tpu_torch.ops.speculative import (NBR_MASK, decode_combined,
                                           speculative_update_mc)

# the control block (kRexec ... kMeshTicket in csrc/serve.cu): the executed
# rung, the live word, the slice's step count and budget, K15's block
# ticket, then the ladder: the stage count, 8 thresholds, 8 pads (0 = full
# table); last the mesh ticket (shard 0's of a lane mesh across cards: the
# shards whose partial K15/K16 has finished this round, 0 between rounds)
CTRL_REXEC, CTRL_LIVE, CTRL_STEPS, CTRL_BUDGET, CTRL_TICKET, \
    CTRL_NSTAGES = range(6)
MAX_STAGES = 8
CTRL_THRESH0 = 6
CTRL_PAD0 = CTRL_THRESH0 + MAX_STAGES
CTRL_MESH_TICKET = CTRL_PAD0 + MAX_STAGES
CTRL_LEN = CTRL_MESH_TICKET + 1
# the fold's pointer table (kMaxShards in csrc/serve.cu)
MAX_SHARDS = 64
# the per-lane counters, int32[3, B]
SCR_FAIL, SCR_ACTIVE, SCR_MAXC = range(3)
INT32_MAX = (1 << 31) - 1

_RUNNING = int(AttemptStatus.RUNNING)
_SUCCESS = int(AttemptStatus.SUCCESS)
_FAILURE = int(AttemptStatus.FAILURE)
_STALLED = int(AttemptStatus.STALLED)

SOURCE = "serve.cu"

launch_counts = {"lane_superstep": 0, "lane_compact": 0, "lane_finish": 0,
                 "lane_reset": 0}
# the clock-reading (kTiming) instances among the launches above
timing_launch_counts = {"lane_finish": 0, "lane_reset": 0}
# the launches above on lanes armed with the spec/cancel vectors
spec_launch_counts = {"lane_finish": 0, "lane_reset": 0}
# the partial (lane-mesh shard) instances among the launches above
partial_launch_counts = {"lane_finish": 0, "lane_reset": 0}


# the folds made in the partial K15/K16's tails: the plain path's, and on
# the card a counter on each mesh's first card (``_fold_counter``)
_plain_folds = [0]
_fold_counters: dict = {}


def reset_launch_counts() -> None:
    """Zero every count above and the fold counts (``mesh_folds``)."""
    for counts in (launch_counts, timing_launch_counts, spec_launch_counts,
                   partial_launch_counts):
        for name in counts:
            counts[name] = 0
    _plain_folds[0] = 0
    for t in _fold_counters.values():
        t.zero_()


def mesh_folds() -> int:
    """The folds made in the partial K15/K16's tails since the last
    ``reset_launch_counts``, on the plain path and on the card (reading
    the card's counters: a host sync)."""
    return _plain_folds[0] + sum(int(t.item())
                                 for t in _fold_counters.values())


def _fold_counter(device) -> torch.Tensor:
    """The int32[1] count of the folds made by the meshes whose first shard
    is on ``device``."""
    key = str(device)
    if key not in _fold_counters:
        _fold_counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _fold_counters[key]


def ladder_ctrl(stages: tuple, device) -> torch.Tensor:
    """A control block holding the ladder ``stages`` (``((scale | None,
    thresh), ...)``, validated by the caller): the stage count, the
    thresholds and each stage's pad (``pow2(scale)``, 0 for the full
    table); the routing words are K16's to write."""
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"a serve ladder has 1 to {MAX_STAGES} stages, "
                         f"got {len(stages)}")
    ctrl = [0] * CTRL_LEN
    ctrl[CTRL_NSTAGES] = len(stages)
    for s, (scale, thresh) in enumerate(stages):
        ctrl[CTRL_THRESH0 + s] = int(thresh)
        ctrl[CTRL_PAD0 + s] = (0 if scale is None
                               else 1 << max(0, (int(scale) - 1).bit_length()))
    return torch.tensor(ctrl, dtype=torch.int32, device=device)


class _LaneArgs(ctypes.Structure):
    """``LaneArgs`` of ``csrc/serve.cu``, passed to every launch."""

    _fields_ = [("slot", ctypes.c_void_p * CARRY_LEN),
                ("comb", ctypes.c_void_p), ("degrees", ctypes.c_void_p),
                ("k0", ctypes.c_void_p), ("max_steps", ctypes.c_void_p),
                ("reset", ctypes.c_void_p), ("nxt", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("ctrl", ctypes.c_void_p),
                ("spec", ctypes.c_void_p), ("cancel", ctypes.c_void_p),
                ("b", ctypes.c_int), ("v", ctypes.c_int), ("w", ctypes.c_int),
                ("a0", ctypes.c_int), ("planes", ctypes.c_int),
                ("stall_window", ctypes.c_int), ("budget", ctypes.c_int)]


class _FoldArgs(ctypes.Structure):
    """``FoldArgs`` of ``csrc/serve.cu``: each shard's control block, the
    folds' counter, the shard count (0: a shard's partial alone), whether
    the shards sit on several cards."""

    _fields_ = [("ctrl", ctypes.c_void_p * MAX_SHARDS),
                ("folds", ctypes.c_void_p), ("n", ctypes.c_int),
                ("spread", ctypes.c_int)]


_PARTIAL_ALONE = _FoldArgs()


@dataclass
class Lanes:
    """One batch's buffers on one device: the carry (updated in place),
    the inputs (``comb`` int32[B, V, W], ``degrees`` int32[B, V], ``k0``,
    ``max_steps``, ``reset`` int32[B]), the back buffer ``nxt`` int32[B,
    V], equal to the carry's ``packed`` between supersteps, the counters
    ``scratch`` int32[3, B] and the control block; the class window's
    plane count, the stall window and the slice's step budget
    (``INT32_MAX`` for a whole sweep); the speculation plane's optional
    ``spec``/``cancel`` int32[B] vectors (``arm_spec``; None: the plain
    slice); K14's ``compact_scratch`` (``new_compact_scratch``). A caller
    may keep them from slice to slice, writing new inputs into their
    tensors (``serve.engine``): the launch arguments are built once."""

    carry: list
    comb: torch.Tensor
    degrees: torch.Tensor
    k0: torch.Tensor
    max_steps: torch.Tensor
    reset: torch.Tensor
    nxt: torch.Tensor
    scratch: torch.Tensor
    ctrl: torch.Tensor
    planes: int
    stall_window: int
    budget: int
    spec: torch.Tensor | None = None
    cancel: torch.Tensor | None = None
    compact_scratch: torch.Tensor | None = None
    _args: object = field(default=None, repr=False)

    @property
    def b(self) -> int:
        return self.degrees.shape[0]

    @property
    def v(self) -> int:
        return self.degrees.shape[1]

    @property
    def a0(self) -> int:
        return self.carry[CARRY_IDX].shape[1]

    @property
    def device(self) -> torch.device:
        return self.degrees.device

    @property
    def armed(self) -> bool:
        """Whether the lanes carry the speculation vectors."""
        return self.spec is not None or self.cancel is not None

    def arm_spec(self, spec: torch.Tensor | None,
                 cancel: torch.Tensor | None) -> None:
        """Give K16 the speculation vectors (int32[B] tensors on the lanes'
        device, either None); the next launches read their contents."""
        self.spec, self.cancel = spec, cancel
        if self._args is not None:
            self._args.spec = 0 if spec is None else spec.data_ptr()
            self._args.cancel = 0 if cancel is None else cancel.data_ptr()

    def set_budget(self, budget: int) -> None:
        """The step budget of the next slice (K16 reads it)."""
        self.budget = int(min(budget, INT32_MAX))
        if self._args is not None:
            self._args.budget = self.budget


def new_compact_scratch(device) -> torch.Tensor:
    """K14's scratch for one batch's lanes on ``device``, zeroed once here
    and never again: int64[1 + the most blocks K14 launches there] on a
    card (the epoch, then a flag a block), int64[2] on the CPU, whose
    plain version keeps only the epoch."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        slots = _library().dgc_lane_compact_grid_max()
    if slots < 1:
        raise RuntimeError(f"lane_compact: no grid on {device}")
    return torch.zeros(1 + slots, dtype=torch.int64, device=device)


def new_lanes(carry, comb, degrees, k0, max_steps, reset, ctrl, *,
              planes: int, stall_window: int, budget: int) -> Lanes:
    """The ``Lanes`` of a batch: ``nxt`` a copy of the carry's
    ``packed``, ``scratch`` allocated (K16 fills it), ``ctrl`` a fresh
    control block of the class's ladder (``ladder_ctrl``), K14's scratch
    made (``new_compact_scratch``): a pool resize makes new lanes, and
    with them a new scratch."""
    b, _v = degrees.shape
    device = degrees.device
    return Lanes(carry=list(carry), comb=comb, degrees=degrees, k0=k0,
                 max_steps=max_steps, reset=reset,
                 nxt=carry[CARRY_PACKED].clone(),
                 scratch=torch.empty((3, b), dtype=torch.int32, device=device),
                 ctrl=ctrl, planes=int(planes),
                 stall_window=int(min(stall_window, INT32_MAX)),
                 budget=int(min(budget, INT32_MAX)),
                 compact_scratch=new_compact_scratch(device))


# ---- plain versions ---------------------------------------------------------

def _desired(ctrl: list, prev_active: torch.Tensor) -> torch.Tensor:
    """Each lane's deepest stage whose threshold covers its previous
    active count (``dgc_tpu.serve.batched:316-319``)."""
    desired = torch.zeros_like(prev_active)
    for s in range(1, ctrl[CTRL_NSTAGES]):
        desired = torch.where(prev_active <= ctrl[CTRL_THRESH0 + s - 1], s,
                              desired)
    return desired


def _route(L: Lanes, ctrl: list) -> tuple[int, bool]:
    """``(executed rung, any lane live)`` of the next superstep: the min
    over live lanes of max(rung, desired rung), the last stage if none."""
    c = L.carry
    live = c[CARRY_PHASE] < 2
    rung_now = torch.maximum(c[CARRY_RUNG], _desired(ctrl, c[CARRY_PREV_ACTIVE]))
    if not bool(live.any()):
        return ctrl[CTRL_NSTAGES] - 1, False
    return int(rung_now[live].min()), True


def lane_reset_reference(L: Lanes, timing: bool, partial: bool = False,
                         mesh: "MeshLanes | None" = None) -> None:
    """K16's plain version: ``_fresh_lanes`` for the flagged lanes and
    their ``nxt`` rows, the timing seed, the counters cleared and the
    control block's routing (``partial``: the shard's, the budget left to
    the fold; ``mesh``, the mesh of ``L``: the partial, then the fold's
    tail, ``mesh_tail_reference``)."""
    partial = partial or mesh is not None
    c, v = L.carry, L.v
    fresh = L.reset != 0
    wide = fresh[:, None]
    pk0 = (L.degrees != 0).to(torch.int32)
    c[CARRY_PACKED].copy_(torch.where(wide, pk0, c[CARRY_PACKED]))
    L.nxt.copy_(torch.where(wide, pk0, L.nxt))
    c[CARRY_P1].copy_(torch.where(wide, 0, c[CARRY_P1]))
    c[CARRY_P2].copy_(torch.where(wide, 0, c[CARRY_P2]))
    c[CARRY_IDX].copy_(torch.where(wide, v, c[CARRY_IDX]))
    scalars = {CARRY_PHASE: 0, CARRY_K: L.k0, CARRY_STEP: 1,
               CARRY_PREV_ACTIVE: v + 1, CARRY_STALL: 0, CARRY_S1: 0,
               CARRY_ST1: 0, CARRY_USED: 0, CARRY_S2: 0, CARRY_ST2: _FAILURE,
               T_US: 0, T_PREV: 0, CARRY_RUNG: 0, CARRY_NC: 0,
               CARRY_IDX_RUNG: 0, CARRY_SPEC: 0}
    for j, value in scalars.items():
        c[j].copy_(torch.where(fresh, value, c[j]))
    if L.armed:
        # the speculation plane (``_slice_kernel``): the tag seated on a
        # flagged lane, a cancelled spec-tagged lane killed unless flagged
        zeros = torch.zeros_like(L.k0)
        spec_in = zeros if L.spec is None else L.spec
        cancel_in = zeros if L.cancel is None else L.cancel
        spec_slot = torch.where(fresh, spec_in, c[CARRY_SPEC])
        killed = (cancel_in != 0) & (spec_slot != 0) & ~fresh
        c[CARRY_PHASE].copy_(torch.where(killed, 2, c[CARRY_PHASE]))
        c[CARRY_SPEC].copy_(spec_slot)
    if timing:
        ts0 = kernel_clock_us(L.device)
        seed = (c[CARRY_PHASE] < 2) & (c[T_PREV] == 0)
        c[T_PREV].copy_(torch.where(seed, ts0, c[T_PREV]))
    L.scratch[SCR_FAIL] = 0
    L.scratch[SCR_ACTIVE] = 0
    L.scratch[SCR_MAXC] = -1
    ctrl = L.ctrl.tolist()
    rexec, any_live = _route(L, ctrl)
    L.ctrl[CTRL_REXEC] = rexec
    L.ctrl[CTRL_LIVE] = int(any_live and (partial or L.budget > 0))
    L.ctrl[CTRL_STEPS] = 0
    L.ctrl[CTRL_BUDGET] = L.budget
    L.ctrl[CTRL_TICKET] = 0
    if mesh is not None:
        mesh_tail_reference(mesh, L)


def lane_compact_reference(L: Lanes) -> None:
    """K14's plain version: ``compact_idx`` of each rebuilding lane's
    active rows into its slot list, the dummy ``V`` past them; a launch
    that rebuilds a lane takes the next epoch (32 bits, never 0) into
    ``compact_scratch[0]`` where the lanes have one."""
    ctrl = L.ctrl.tolist()
    if not ctrl[CTRL_LIVE]:
        return
    s = ctrl[CTRL_REXEC]
    pad = ctrl[CTRL_PAD0 + s]
    if pad == 0:
        return
    c, v = L.carry, L.v
    need = (c[CARRY_PHASE] < 2) & (c[CARRY_IDX_RUNG] < s)
    lanes = torch.nonzero(need).flatten().tolist()
    if lanes and L.compact_scratch is not None:
        epoch = (int(L.compact_scratch[0]) + 1) & 0xFFFFFFFF
        L.compact_scratch[0] = epoch or 1
    for b in lanes:
        pk = c[CARRY_PACKED][b]
        c[CARRY_IDX][b].fill_(v)
        c[CARRY_IDX][b, :pad] = compact_idx((pk < 0) | ((pk & 1) == 1), pad, v)
        c[CARRY_IDX_RUNG][b] = s


def _walked_rows(L: Lanes, b: int, pad: int) -> torch.Tensor:
    """The rows K13 walks in lane ``b``: its rows (``pad`` 0) or its
    rung's real slots, less the confirmed rows (a confirmed row's rule
    returns its own word and counts nothing)."""
    v = L.v
    if pad == 0:
        rows = torch.arange(v, device=L.device)
    else:
        slots = L.carry[CARRY_IDX][b, :pad].to(torch.int64)
        rows = slots[slots < v]  # dummy slots are inert
    me = L.carry[CARRY_PACKED][b][rows]
    return rows[(me < 0) | ((me & 1) == 1)]


def check_lane_rows(L: Lanes, b: int, rows: torch.Tensor) -> None:
    """K13's table contract for ``rows`` of lane ``b``: a row's first
    ``degrees[b, row]`` entries are neighbors (< V) and the rest the
    sentinel (>= V), as ``csr_to_ell`` and ``pad_member`` lay them out.
    K13 walks a row only up to its degree, so a table that breaks it would
    give another result; raises ``ValueError``."""
    nbr = L.comb[b][rows] & NBR_MASK
    real = (torch.arange(nbr.shape[1], device=L.device)[None, :]
            < L.degrees[b][rows][:, None])
    if bool(((nbr >= L.v) & real).any()):
        raise ValueError(f"lane_superstep: lane {b} has a row whose entry "
                         f"before its degree is not a neighbor (>= {L.v})")
    if bool(((nbr < L.v) & ~real).any()):
        raise ValueError(f"lane_superstep: lane {b} has a row whose degree "
                         f"cuts off a real entry (< {L.v} at or past it)")


def lane_superstep_reference(L: Lanes) -> None:
    """K13's plain version: ``speculative_update_mc`` over each live
    lane's unconfirmed rows (rung 0) or its rung's unconfirmed real slots,
    into ``nxt``; the fail and active counts into ``scratch``. A confirmed
    row is not walked and its ``nxt`` word not written, which is exact
    because ``nxt`` equals ``packed`` at every entry (made as its copy;
    K15, K16 and the pool's resize keep it so): raises ``ValueError``
    where it does not, or where a walked row breaks the table contract
    (``check_lane_rows``)."""
    ctrl = L.ctrl.tolist()
    if not ctrl[CTRL_LIVE]:
        return
    c, v = L.carry, L.v
    if not torch.equal(L.nxt, c[CARRY_PACKED]):
        raise ValueError("lane_superstep: nxt differs from packed at entry")
    pad = ctrl[CTRL_PAD0 + ctrl[CTRL_REXEC]]
    sentinel = torch.full((1,), -1, dtype=torch.int32, device=L.device)
    for b in torch.nonzero(c[CARRY_PHASE] < 2).flatten().tolist():
        pk = c[CARRY_PACKED][b]
        rows = _walked_rows(L, b, pad)
        check_lane_rows(L, b, rows)
        nbr, beats = decode_combined(L.comb[b][rows])
        gathered = torch.cat([pk, sentinel])[nbr.clamp(max=v).to(torch.int64)]
        new, fail, active, _mc = speculative_update_mc(
            pk[rows], gathered, beats, int(c[CARRY_K][b]), L.planes)
        L.nxt[b, rows] = new
        L.scratch[SCR_FAIL, b] += fail.sum().to(torch.int32)
        L.scratch[SCR_ACTIVE, b] += active.sum().to(torch.int32)


def lane_finish_reference(L: Lanes, timing: bool, partial: bool = False,
                          mesh: "MeshLanes | None" = None) -> None:
    """K15's plain version: ``_superstep_body``'s transition and freeze
    (``dgc_tpu.serve.batched:363-466``) over the counters K13 left, the
    step adopted or reverted in ``packed`` and ``nxt``, the next routing
    (``partial`` and ``mesh`` as ``lane_reset_reference``'s; a round past
    the live word does nothing, so it does not fold)."""
    partial = partial or mesh is not None
    ctrl = L.ctrl.tolist()
    if not ctrl[CTRL_LIVE]:
        return
    c, v = L.carry, L.v
    fail_n, active = L.scratch[SCR_FAIL].clone(), L.scratch[SCR_ACTIVE].clone()
    live = c[CARRY_PHASE] < 2
    any_fail = fail_n > 0
    stall_new = torch.where(active < c[CARRY_PREV_ACTIVE], 0, c[CARRY_STALL] + 1)
    status_new = torch.where(
        any_fail, _FAILURE, torch.where(
            active == 0, _SUCCESS,
            torch.where(stall_new >= L.stall_window, _STALLED, _RUNNING)))
    step_new = c[CARRY_STEP] + 1
    fin = (status_new != _RUNNING) | (step_new >= L.max_steps)
    first = c[CARRY_PHASE] == 0
    store1, store2 = fin & first & live, fin & ~first & live
    rung_now = torch.maximum(c[CARRY_RUNG], _desired(ctrl, c[CARRY_PREV_ACTIVE]))

    # the wide part: each live lane's step state, adopted or reverted
    new_pk = torch.where(any_fail[:, None], c[CARRY_PACKED], L.nxt)
    colors = torch.where(new_pk >= 0, new_pk >> 1, -1)
    maxc = torch.cat([colors, torch.full_like(colors[:, :1], -1)], 1).amax(1)
    pk0 = (L.degrees != 0).to(torch.int32)
    c[CARRY_P1].copy_(torch.where(store1[:, None], new_pk, c[CARRY_P1]))
    c[CARRY_P2].copy_(torch.where(store2[:, None], new_pk, c[CARRY_P2]))
    state = torch.where((fin & live)[:, None], pk0,
                        torch.where(live[:, None], new_pk, c[CARRY_PACKED]))
    c[CARRY_PACKED].copy_(state)
    L.nxt.copy_(state)

    # the scalars of live lanes; dead lanes keep theirs
    used = torch.where(store1, maxc + 1, c[CARRY_USED])
    status_fin = torch.where((status_new == _RUNNING) & fin, _STALLED,
                             status_new)
    k2 = used - 1
    run2 = fin & first & (status_fin == _SUCCESS) & (k2 >= 1) \
        & (c[CARRY_SPEC] == 0)
    new = {
        CARRY_PHASE: torch.where(fin, torch.where(run2, 1, 2), c[CARRY_PHASE]),
        CARRY_K: torch.where(run2, k2, c[CARRY_K]),
        CARRY_STEP: torch.where(fin, 1, step_new),
        CARRY_PREV_ACTIVE: torch.where(fin, v + 1, active),
        CARRY_STALL: torch.where(fin, 0, stall_new),
        CARRY_S1: torch.where(store1, step_new, c[CARRY_S1]),
        CARRY_ST1: torch.where(store1, status_fin, c[CARRY_ST1]),
        CARRY_USED: used,
        CARRY_S2: torch.where(store2, step_new, c[CARRY_S2]),
        CARRY_ST2: torch.where(store2, status_fin, c[CARRY_ST2]),
        CARRY_RUNG: torch.where(fin, 0, rung_now),
        CARRY_NC: active,
        CARRY_IDX_RUNG: torch.where(fin, 0, c[CARRY_IDX_RUNG]),
    }
    if timing:
        ts = kernel_clock_us(L.device)
        prev = c[T_PREV]
        new[T_US] = torch.where(prev > 0, c[T_US] + ((ts - prev) & US_MASK),
                                c[T_US])
        new[T_PREV] = torch.full_like(prev, ts)
    for j, value in new.items():
        c[j].copy_(torch.where(live, value.to(torch.int32), c[j]))
    L.scratch[SCR_FAIL] = 0
    L.scratch[SCR_ACTIVE] = 0
    L.scratch[SCR_MAXC] = -1
    rexec, any_live = _route(L, ctrl)
    steps = ctrl[CTRL_STEPS] + 1
    L.ctrl[CTRL_STEPS] = steps
    L.ctrl[CTRL_REXEC] = rexec
    L.ctrl[CTRL_LIVE] = int(any_live and (partial or steps < ctrl[CTRL_BUDGET]))
    L.ctrl[CTRL_TICKET] = 0
    if mesh is not None:
        mesh_tail_reference(mesh, L)


def mesh_tail_reference(M: "MeshLanes", L: Lanes) -> None:
    """The plain partial K15/K16's tail on shard ``L`` of ``M``, which has
    just written its partial (``mesh_tail`` in ``csrc/serve.cu``, one
    device: the shards run in order): the last shard folds
    (``lane_mesh_fold_reference``) and counts the fold."""
    if L is M.shards[-1]:
        lane_mesh_fold_reference([S.ctrl for S in M.shards])
        _plain_folds[0] += 1


def lane_mesh_fold_reference(ctrls: list) -> None:
    """K26's plain version: the shards' partials folded (min rung, any
    live within the budget) into every control block."""
    rung = min(int(c[CTRL_REXEC]) for c in ctrls)
    steps, budget = int(ctrls[0][CTRL_STEPS]), int(ctrls[0][CTRL_BUDGET])
    live = int(any(int(c[CTRL_LIVE]) for c in ctrls) and steps < budget)
    for c in ctrls:
        c[CTRL_REXEC] = rung
        c[CTRL_LIVE] = live
        c[CTRL_STEPS] = steps
        c[CTRL_TICKET] = 0


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name, timed in (("dgc_lane_reset", True),
                            ("dgc_lane_superstep", False),
                            ("dgc_lane_finish", True)):
            fn = getattr(lib, name)
            fn.argtypes = [vp, ci, vp, vp] if timed else [vp, vp]
            fn.restype = ci
        lib.dgc_lane_compact.argtypes = [vp, vp, ci, vp]
        lib.dgc_lane_compact.restype = ci
        lib.dgc_lane_compact_grid_max.argtypes = []
        lib.dgc_lane_compact_grid_max.restype = ci
        lib.dgc_lane_superstep_plan.argtypes = [vp, ci, ci,
                                                ctypes.POINTER(ci)]
        lib.dgc_lane_superstep_plan.restype = ci
        lib.dgc_enable_peer_access.argtypes = [ci, ci]
        lib.dgc_enable_peer_access.restype = ci
        lib.dgc_max_shards.restype = ci
        lib.dgc_lane_args_size.restype = ci
        lib.dgc_fold_args_size.restype = ci
        if lib.dgc_lane_args_size() != ctypes.sizeof(_LaneArgs):
            raise RuntimeError("csrc/serve.cu's LaneArgs and _LaneArgs differ")
        if lib.dgc_fold_args_size() != ctypes.sizeof(_FoldArgs) or \
                lib.dgc_max_shards() != MAX_SHARDS:
            raise RuntimeError("csrc/serve.cu's FoldArgs and _FoldArgs differ")
        lib._dgc_bound = True
    return lib


def _args(L: Lanes) -> _LaneArgs:
    """The launch arguments of ``L``, checked and built once."""
    if L._args is not None:
        return L._args
    device = L.device
    if device.type != "cuda":
        raise ValueError(f"serve kernels: unsupported device {device}")
    b, v = L.b, L.v
    if len(L.carry) != CARRY_LEN:
        raise ValueError(f"the carry has {CARRY_LEN} slots, got {len(L.carry)}")
    for j, t in enumerate(L.carry):
        wide = j in (CARRY_PACKED, CARRY_P1, CARRY_P2, CARRY_IDX)
        _check_int32(f"carry[{j}]", t, device, 2 if wide else 1)
        if t.shape[0] != b or (wide and j != CARRY_IDX and t.shape[1] != v):
            raise ValueError(f"carry[{j}] has shape {tuple(t.shape)} for "
                             f"{b} lanes of {v} rows")
    for name, t, shape in (("comb", L.comb, (b, v, L.comb.shape[-1])),
                           ("degrees", L.degrees, (b, v)),
                           ("k0", L.k0, (b,)), ("max_steps", L.max_steps, (b,)),
                           ("reset", L.reset, (b,)), ("nxt", L.nxt, (b, v)),
                           ("scratch", L.scratch, (3, b)),
                           ("ctrl", L.ctrl, (CTRL_LEN,))):
        _check_int32(name, t, device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name in ("spec", "cancel"):
        t = getattr(L, name)
        if t is not None:
            _check_int32(name, t, device, 1)
            if tuple(t.shape) != (b,):
                raise ValueError(f"{name} must be ({b},), got "
                                 f"{tuple(t.shape)}")
    if not 1 <= L.planes <= 32 or 32 * L.planes < L.comb.shape[-1] + 1:
        raise ValueError(f"planes={L.planes} does not cover width "
                         f"{L.comb.shape[-1]}")
    if b > 65535 or v >= 1 << 30:
        raise ValueError(f"{b} lanes of {v} rows: too many")
    args = _LaneArgs()
    for j, t in enumerate(L.carry):
        args.slot[j] = t.data_ptr()
    for name in ("comb", "degrees", "k0", "max_steps", "reset", "nxt",
                 "scratch", "ctrl"):
        setattr(args, name, getattr(L, name).data_ptr())
    args.spec = 0 if L.spec is None else L.spec.data_ptr()
    args.cancel = 0 if L.cancel is None else L.cancel.data_ptr()
    args.b, args.v, args.w, args.a0 = b, v, int(L.comb.shape[-1]), L.a0
    args.planes, args.stall_window, args.budget = (L.planes, L.stall_window,
                                                   L.budget)
    L._args = args
    return args


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _fold_arg(L: Lanes, partial: bool, mesh):
    """The fold argument of a K15/K16 launch on ``L``: none (not partial),
    the partial alone, or ``mesh``'s fold (``_fold_args``), which on one
    card only the last shard's launch takes."""
    if mesh is not None and (mesh.spread or L is mesh.shards[-1]):
        return ctypes.byref(_fold_args(mesh))
    return ctypes.byref(_PARTIAL_ALONE) if partial else None


def _count(name: str, L: Lanes, timing: bool, partial: bool) -> None:
    launch_counts[name] += 1
    if timing:
        timing_launch_counts[name] += 1
    if L.armed:
        spec_launch_counts[name] += 1
    if partial:
        partial_launch_counts[name] += 1


def lane_reset(L: Lanes, timing: bool = False, partial: bool = False,
               mesh: "MeshLanes | None" = None) -> None:
    """K16 (its kTiming instance with ``timing``, its partial instance
    with ``partial``: a shard of a lane mesh; with ``mesh``, the mesh of
    ``L``, the partial instance whose tail is the fold; it reads
    ``L.spec`` and ``L.cancel`` when the lanes are armed). Runs on the
    current stream."""
    partial = partial or mesh is not None
    if L.device.type == "cpu":
        return lane_reset_reference(L, timing, partial, mesh)
    args = _args(L)
    rc = _library().dgc_lane_reset(ctypes.byref(args), int(bool(timing)),
                                   _fold_arg(L, partial, mesh),
                                   _stream(L.device))
    _raise_on(rc, "lane_reset")
    _count("lane_reset", L, timing, partial)


def lane_compact(L: Lanes) -> None:
    """K14, on the lanes' ``compact_scratch`` (one stream at a time). Runs
    on the current stream."""
    if L.device.type == "cpu":
        return lane_compact_reference(L)
    args = _args(L)
    t = L.compact_scratch
    if t is None or t.device != L.device or t.dtype != torch.int64 or \
            t.dim() != 1 or t.shape[0] < 2 or not t.is_contiguous():
        raise ValueError("lane_compact needs the lanes' int64[1 + blocks] "
                         "scratch on their card (new_compact_scratch)")
    _raise_on(_library().dgc_lane_compact(
        ctypes.byref(args), t.data_ptr(), int(t.shape[0]) - 1,
        _stream(L.device)), "lane_compact")
    launch_counts["lane_compact"] += 1


def lane_superstep(L: Lanes) -> None:
    """K13. Runs on the current stream."""
    if L.device.type == "cpu":
        return lane_superstep_reference(L)
    args = _args(L)
    _raise_on(_library().dgc_lane_superstep(ctypes.byref(args),
                                            _stream(L.device)),
              "lane_superstep")
    launch_counts["lane_superstep"] += 1


def superstep_plan(L: Lanes) -> dict:
    """How K13 would run on ``L`` as it stands (reads the control block
    and the lanes' phases: a host sync): its grid, and how many of its
    blocks gather the neighbors' words from the lane's state staged in
    shared memory (``shared``, classes of at most 32,768 rows where a
    block's share of the lane is long enough) or from device memory
    (``global``)."""
    args = _args(L)
    ctrl = L.ctrl.tolist()
    nlive = (int((L.carry[CARRY_PHASE] < 2).sum()) if ctrl[CTRL_LIVE]
             else 0)
    out = (ctypes.c_int * 3)()
    _raise_on(_library().dgc_lane_superstep_plan(
        ctypes.byref(args), nlive, ctrl[CTRL_PAD0 + ctrl[CTRL_REXEC]], out),
        "lane_superstep_plan")
    return {"grid": out[0], "shared": out[1], "global": out[2]}


def lane_finish(L: Lanes, timing: bool = False, partial: bool = False,
                mesh: "MeshLanes | None" = None) -> None:
    """K15 (its kTiming instance with ``timing``, its partial instance
    with ``partial`` or ``mesh``, as ``lane_reset``). Runs on the current
    stream."""
    partial = partial or mesh is not None
    if L.device.type == "cpu":
        return lane_finish_reference(L, timing, partial, mesh)
    args = _args(L)
    rc = _library().dgc_lane_finish(ctypes.byref(args), int(bool(timing)),
                                    _fold_arg(L, partial, mesh),
                                    _stream(L.device))
    _raise_on(rc, "lane_finish")
    _count("lane_finish", L, timing, partial)


# ---- the lane mesh ------------------------------------------------------------

def enable_peer_access(devices) -> None:
    """Let every card of ``devices`` (``torch.device``s, repeats allowed)
    read and write every other's memory, as the fold in the partial
    K15/K16's tail and the mesh instances of K18/K19 do; raises when a pair
    cannot (no quiet slower route)."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    if len(cards) < 2:
        return
    lib = _library()
    for a in cards:
        for b in cards:
            if a == b:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise ValueError(f"lane mesh: cuda:{a} cannot reach cuda:{b} "
                                 f"(no peer access)")
            _raise_on(lib.dgc_enable_peer_access(a, b), "enable_peer_access")


@dataclass
class MeshLanes:
    """The lanes of a lane-sharded batch: ``shards[i]`` holds lanes
    ``i * per .. (i + 1) * per`` (``per`` each, on its own device, with a
    control block of its own), launched in shard order. The fold (K26) is
    the tail of the last shard's partial K15/K16 to finish (on one device
    the last shard's; across devices the one that draws the last ticket),
    its counter on the first shard's device; with shards on several
    devices each round is ordered by events."""

    shards: list
    _fold: object = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return len(self.shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def ctrl(self) -> torch.Tensor:
        """The folded control block (every shard holds the same words)."""
        return self.shards[0].ctrl

    @property
    def carry(self) -> list:
        """Each shard's carry, in shard order."""
        return [L.carry for L in self.shards]

    @property
    def spread(self) -> bool:
        """Whether the shards sit on more than one device."""
        return len({str(L.device) for L in self.shards}) > 1

    def set_budget(self, budget: int) -> None:
        for L in self.shards:
            L.set_budget(budget)


def new_mesh_lanes(shards: list) -> MeshLanes:
    """A ``MeshLanes`` over per-shard ``Lanes`` of equal widths."""
    if not shards:
        raise ValueError("a lane mesh has at least one shard")
    if len({(L.b, L.v, L.a0) for L in shards}) != 1:
        raise ValueError("the shards of a lane mesh must have equal widths")
    return MeshLanes(shards=list(shards))


def _fold_args(M: MeshLanes) -> _FoldArgs:
    """The fold's arguments of ``M``, checked and built once: each shard's
    control block, the counter on the first shard's card, the count."""
    if M._fold is None:
        if M.n > MAX_SHARDS:
            raise ValueError(f"lane mesh: {M.n} shards, at most {MAX_SHARDS}")
        for L in M.shards:
            if L.device.type != "cuda":
                raise ValueError(f"lane mesh fold: unsupported device "
                                 f"{L.device}")
            _check_int32("ctrl", L.ctrl, L.device, 1)
        fold = _FoldArgs()
        for i, L in enumerate(M.shards):
            fold.ctrl[i] = L.ctrl.data_ptr()
        fold.folds = _fold_counter(M.device).data_ptr()
        fold.n = M.n
        fold.spread = int(M.spread)
        M._fold = fold
    return M._fold


def current_card(device):
    """A context in which the CUDA runtime's current device is ``device``
    (a launch goes to a stream of the current device, so a lane mesh over
    several cards launches each shard's kernels on its own card); nothing
    to do on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _join(M: MeshLanes) -> None:
    """Shards on other devices: the first shard's stream waits for each
    shard's last launch (one of them folded)."""
    if M.device.type == "cuda" and M.spread:
        home = torch.cuda.current_stream(M.device)
        for L in M.shards[1:]:
            if L.device != M.device:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(L.device))
                home.wait_event(ev)


def _fork(M: MeshLanes) -> None:
    """Shards on other devices: each shard's stream waits for the joined
    round, so for the fold."""
    if M.device.type == "cuda" and M.spread:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(M.device))
        for L in M.shards[1:]:
            if L.device != M.device:
                torch.cuda.current_stream(L.device).wait_event(ev)


def mesh_reset(M: MeshLanes, timing: bool = False) -> None:
    """The mesh's slice entry: each shard's partial K16, the last to
    finish folding."""
    for L in M.shards:
        with current_card(L.device):
            lane_reset(L, timing, mesh=M)
    _join(M)
    _fork(M)


def mesh_superstep(M: MeshLanes, staged: bool, timing: bool = False) -> None:
    """One batched superstep of the mesh: each shard's K14 (staged
    ladders), K13 and partial K15, the last K15 to finish folding."""
    for L in M.shards:
        with current_card(L.device):
            if staged:
                lane_compact(L)
            lane_superstep(L)
            lane_finish(L, timing, mesh=M)
    _join(M)
    _fork(M)
