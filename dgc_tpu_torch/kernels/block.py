"""Wrappers of the attempt block's kernels (``csrc/block.cu``), their plain
PyTorch versions, and the block record they share.

An attempt block (``CompactFrontierEngine.attempt_block``) chains up to A
k-attempts of the minimal-k loop on the card: the host drives each
attempt's stage ladder as ``attempt`` does, and where an attempt ends

- ``block_record`` (K9) records it: the color count ``used`` reduced over
  the current state buffer, the row ``[k, steps, status, used]``, the
  state copied into the best row on a success, and the stopping rule —
  the next budget (``k − 1`` strict, ``used − 1`` jump), ``done`` when the
  attempt did not succeed or that budget is below ``k_min``;
- ``block_start`` (K10) starts the next one unless the block is done or
  full: the state and live table from the prefix-resume ring slot whose
  ``(best, mc]`` bracket holds the budget (the highest such slot), or a
  fresh attempt's on a miss, and a reset control block. The ring's count
  and best candidate (control-block slots ``CTRL_REC_CNT`` and
  ``CTRL_REC_BEST``) pass through, so every attempt records into the same
  ring and a later one resumes from it.

Their recording variants (B11) carry the block's stacked trajectory
buffers ``tstack`` (int32[A, cap, cols], ``layout.BK_TRAJ``): each attempt
records into one scratch buffer ``traj`` (K6's recording variant); K9
copies it into the attempt's slot of the stack and K10 fills it with −1
for the next attempt.

The block record ``blk`` is int32[BLK_HEAD + A·BK_ATT_COLS]: the count of
attempts recorded, the next budget, the stop flag, K9's two cross-block
scratch slots (the running max color, −1 between launches, and its block
counter, 0 between launches), then one ``BKC_*`` row per attempt
(``dgc_tpu.layout``'s ``BK_ATT`` columns). ``new_block`` allocates the
control block and ``blk`` as views of one buffer, so the host reads both
with one copy.

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel (``rec_launch_counts`` those
of the recording variants): a wrapper adds one where it
launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.compact import (CTRL_CUR, CTRL_LEN,
                                           CTRL_PREV_ACTIVE, CTRL_REC_BEST,
                                           CTRL_REC_CNT, CTRL_STATUS,
                                           CTRL_STEP, LIVE_BA, LIVE_ROWS,
                                           META_COLS, REC_SLOTS, _check_cuda,
                                           _raise_on, extend_packed)
from dgc_tpu_torch.kernels.superstep import _check_int32, _stream

# per-attempt record row (dgc_tpu/layout.py BKC_*; kBkc* in csrc/block.cu)
BKC_K = 0          # the attempt's color budget
BKC_STEPS = 1      # supersteps executed
BKC_STATUS = 2     # AttemptStatus exit code
BKC_USED = 3       # colors used (max color + 1; the jump rule's source)
BK_ATT_COLS = 4

# the block record's head (kBlk* in csrc/block.cu)
BLK_N_ATT, BLK_K, BLK_DONE, BLK_USED, BLK_TICKET = range(5)
BLK_HEAD = 5

_RUNNING = int(AttemptStatus.RUNNING)
_SUCCESS = int(AttemptStatus.SUCCESS)
_STALLED = int(AttemptStatus.STALLED)

SOURCE = "block.cu"

launch_counts = {"block_record": 0, "block_start": 0}
# the recording variants' launches (B11), apart from the kernels above
rec_launch_counts = {"block_record_rec": 0, "block_start_rec": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, rec_launch_counts):
        for name in counts:
            counts[name] = 0


def new_block(k: int, attempts: int, rec: torch.Tensor):
    """``(buf, ctrl, blk)``: one int32 buffer holding a control block (the
    ring's count and best candidate taken from ``rec``, int32[2]; the rest
    K10 writes) and a block record for ``attempts`` attempts starting at
    budget ``k``, and the two views of it."""
    head = [0, int(k), 0, -1, 0] + [-1] * (attempts * BK_ATT_COLS)
    buf = torch.zeros(CTRL_LEN + len(head), dtype=torch.int32,
                      device=rec.device)
    buf[CTRL_LEN:] = torch.tensor(head, dtype=torch.int32)
    buf[CTRL_REC_CNT: CTRL_REC_BEST + 1] = rec
    return buf, buf[:CTRL_LEN], buf[CTRL_LEN:]


def block_attempts(blk: torch.Tensor) -> int:
    """A: the attempts a block record has rows for."""
    return (blk.shape[0] - BLK_HEAD) // BK_ATT_COLS


def block_open(b: list) -> bool:
    """Does a block whose record reads ``b`` (a list) run another attempt?"""
    a = (len(b) - BLK_HEAD) // BK_ATT_COLS
    return b[BLK_DONE] == 0 and b[BLK_N_ATT] < a


def attempt_rows(b: list) -> list[list[int]]:
    """The recorded ``[k, steps, status, used]`` rows of block record ``b``."""
    return [b[BLK_HEAD + i * BK_ATT_COLS: BLK_HEAD + (i + 1) * BK_ATT_COLS]
            for i in range(b[BLK_N_ATT])]


def final_status(c: list) -> int:
    """The status of an attempt whose ladder ended with control block ``c``:
    a RUNNING one had nothing left to do (SUCCESS) or ran out of steps
    (STALLED), the fixup at the end of ``_staged_pipeline``."""
    if c[CTRL_STATUS] != _RUNNING:
        return c[CTRL_STATUS]
    return _SUCCESS if c[CTRL_PREV_ACTIVE] == 0 else _STALLED


# ---- plain versions ---------------------------------------------------------

def block_record_reference(ctrl: torch.Tensor, state: torch.Tensor,
                           blk: torch.Tensor, best_pe: torch.Tensor,
                           k_min: int, strict: bool,
                           traj: torch.Tensor | None = None,
                           tstack: torch.Tensor | None = None) -> None:
    """K9's plain version: ``_block_kernel_body``'s epilogue, the
    attempt's trajectory into its slot of ``tstack`` when given."""
    b = blk.tolist()
    if not block_open(b):
        return
    if traj is not None:
        tstack[b[BLK_N_ATT]] = traj
    c = ctrl.tolist()
    v = state.shape[1] - 2
    pe = state[c[CTRL_CUR]]
    colors = torch.where(pe[:v] >= 0, pe[:v] >> 1, -1)
    used = (int(colors.max()) if v else -1) + 1
    status = final_status(c)
    k, ai = b[BLK_K], b[BLK_N_ATT]
    row = BLK_HEAD + ai * BK_ATT_COLS
    blk[row: row + BK_ATT_COLS] = torch.tensor(
        [k, c[CTRL_STEP], status, used], dtype=torch.int32)
    success = status == _SUCCESS
    if success:
        best_pe.copy_(pe)
    k_dec = k - 1 if strict else used - 1
    blk[BLK_N_ATT] = ai + 1
    blk[BLK_K] = k_dec if success else k
    blk[BLK_DONE] = int(not success or k_dec < k_min)


def block_start_reference(ctrl: torch.Tensor, blk: torch.Tensor,
                          state: torch.Tensor, live: torch.Tensor, ring,
                          degrees: torch.Tensor, init_ba: torch.Tensor,
                          traj: torch.Tensor | None = None) -> None:
    """K10's plain version: ``_default_init`` and ``restore_from_ring``
    (``first=False``) into the state buffers, the live table and the
    control block; ``traj`` (when given) emptied."""
    b = blk.tolist()
    if not block_open(b):
        return
    if traj is not None:
        traj.fill_(-1)
    k = b[BLK_K]
    c = ctrl.tolist()
    ring_pe, ring_ba, ring_meta = ring
    meta = ring_meta.tolist()
    hit = None
    for j in range(REC_SLOTS):  # the last slot whose bracket holds k wins
        if j < c[CTRL_REC_CNT] and meta[j][1] < k <= meta[j][2]:
            hit = j
    v = state.shape[1] - 2
    if hit is None:
        pe = extend_packed(torch.where(degrees == 0, 0, 1))
        ba = init_ba
        step, stall, prev_active = 1, 0, v + 1
    else:
        pe, ba = ring_pe[hit], ring_ba[hit]
        step, _, _, stall, prev_active = meta[hit]
    state[0] = pe
    state[1] = pe
    live.zero_()
    live[LIVE_BA] = ba
    ctrl.copy_(torch.tensor(
        [_RUNNING, step, prev_active, stall, 0, 0, 0, -1,
         c[CTRL_REC_CNT], c[CTRL_REC_BEST], 0], dtype=torch.int32))


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_block_record.argtypes = [vp, vp, ci, vp, ci, vp, ci, ci, vp,
                                         vp, ci, vp]
        lib.dgc_block_record.restype = ci
        lib.dgc_block_start.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp, vp, vp,
                                        vp, vp, vp, ci, vp]
        lib.dgc_block_start.restype = ci
        lib._dgc_bound = True
    return lib


def _check_block(ctrl, state, blk, device) -> None:
    _check_int32("ctrl", ctrl, device, 1)
    _check_int32("state", state, device, 2)
    _check_int32("blk", blk, device, 1)
    if ctrl.shape[0] != CTRL_LEN or state.shape[0] != 2 or state.shape[1] < 2:
        raise ValueError(f"ctrl must be [{CTRL_LEN}] and state [2, V+2]")
    if blk.shape[0] < BLK_HEAD + BK_ATT_COLS or \
            (blk.shape[0] - BLK_HEAD) % BK_ATT_COLS:
        raise ValueError(f"blk must be [{BLK_HEAD} + A·{BK_ATT_COLS}], A >= 1")


def _check_traj(traj, tstack, attempts: int, device) -> None:
    _check_int32("traj", traj, device, 2)
    if tstack is not None:
        _check_int32("tstack", tstack, device, 3)
        if tuple(tstack.shape) != (attempts, *traj.shape):
            raise ValueError(f"tstack must be [{attempts}, "
                             f"{traj.shape[0]}, {traj.shape[1]}]")


def block_record(ctrl: torch.Tensor, state: torch.Tensor, blk: torch.Tensor,
                 best_pe: torch.Tensor, k_min: int, strict: bool,
                 traj: torch.Tensor | None = None,
                 tstack: torch.Tensor | None = None) -> None:
    """K9: record the attempt that just ended into ``blk`` and apply the
    stopping rule; ``best_pe`` (int32[V+2]) takes the state on a success.
    Its recording variant when ``traj`` (int32[cap, cols]) and ``tstack``
    (int32[A, cap, cols]) are given. A no-op when the block is done or
    full. Runs on the current stream."""
    device = state.device
    if device.type == "cpu":
        return block_record_reference(
            ctrl, state, blk, best_pe, k_min, strict, traj=traj,
            tstack=tstack)
    _check_cuda("block_record", device)
    _check_block(ctrl, state, blk, device)
    _check_int32("best_pe", best_pe, device, 1)
    if best_pe.shape[0] != state.shape[1]:
        raise ValueError("best_pe must be [V+2]")
    name, counts, rec = "block_record", launch_counts, (None, None, 0)
    if traj is not None:
        _check_traj(traj, tstack, block_attempts(blk), device)
        name, counts = "block_record_rec", rec_launch_counts
        rec = (traj.data_ptr(), tstack.data_ptr(), int(traj.numel()))
    _raise_on(_library().dgc_block_record(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]),
        blk.data_ptr(), block_attempts(blk), best_pe.data_ptr(),
        max(-(1 << 31), min(int(k_min), (1 << 31) - 1)), int(bool(strict)),
        *rec, _stream(device)), name)
    counts[name] += 1


def block_start(ctrl: torch.Tensor, blk: torch.Tensor, state: torch.Tensor,
                live: torch.Tensor, ring, degrees: torch.Tensor,
                init_ba: torch.Tensor,
                traj: torch.Tensor | None = None) -> None:
    """K10: start the block's next attempt at ``blk``'s budget from the
    ring (``new_ring``'s triple) or fresh (``degrees`` int32[V], the live
    counts ``init_ba`` int32[nb]); its recording variant, which also
    empties ``traj``, when given. A no-op when the block is done or full.
    Runs on the current stream."""
    device = state.device
    if device.type == "cpu":
        return block_start_reference(
            ctrl, blk, state, live, ring, degrees, init_ba, traj=traj)
    _check_cuda("block_start", device)
    _check_block(ctrl, state, blk, device)
    ring_pe, ring_ba, ring_meta = ring
    for name, t, ndim in (("live", live, 2), ("ring_pe", ring_pe, 2),
                          ("ring_ba", ring_ba, 2), ("ring_meta", ring_meta, 2),
                          ("degrees", degrees, 1), ("init_ba", init_ba, 1)):
        _check_int32(name, t, device, ndim)
    words, nb = state.shape[1], live.shape[1]
    if live.shape[0] != LIVE_ROWS or tuple(ring_pe.shape) != (REC_SLOTS, words) \
            or tuple(ring_ba.shape) != (REC_SLOTS, nb) \
            or tuple(ring_meta.shape) != (REC_SLOTS, META_COLS) \
            or degrees.shape[0] != words - 2 or init_ba.shape[0] != nb:
        raise ValueError("live must be [5, nb], the ring [4, V+2], [4, nb] "
                         "and [4, 5], degrees [V] and init_ba [nb]")
    name, counts, rec = "block_start", launch_counts, (None, 0)
    if traj is not None:
        _check_traj(traj, None, block_attempts(blk), device)
        name, counts = "block_start_rec", rec_launch_counts
        rec = (traj.data_ptr(), int(traj.numel()))
    _raise_on(_library().dgc_block_start(
        ctrl.data_ptr(), blk.data_ptr(), block_attempts(blk),
        state.data_ptr(), int(words), live.data_ptr(), int(nb),
        ring_pe.data_ptr(), ring_ba.data_ptr(), ring_meta.data_ptr(),
        degrees.data_ptr(), init_ba.data_ptr(), *rec, _stream(device)), name)
    counts[name] += 1
