"""Wrappers of the ring-halo engine's kernels (``csrc/ring.cu``) and their
plain PyTorch versions.

- ``ring_stats`` (K23): one rotation's neighbor stats of the shard's rows
  against the block the rank holds, one thread per row, OR-folded into the
  accumulators: a flat rotation table (table row j is local row j) or one
  degree bucket's rows (``rows``, sentinel ``V_l`` skipped).
- ``ring_stats(..., wide=True)`` (K24, ``ring_stats_wide``): the same
  function, one warp per row, for the tables wider than ``WIDE_WIDTH``;
  ``ring_stats_reference`` is its plain version too.
- ``ring_apply`` (K25): ``apply_update_mc`` from the accumulated stats: the
  new words into ``back``, the fail (where ``fail_valid``), active and
  ``mc`` counters into the control block (``kernels.shard``'s, the slots
  K20 writes), the accumulators back to zero.

Every kernel returns at once unless the control block's status is
RUNNING. Layout (``csrc/ring.cu``): ``block`` int32[V_l + 1] with −1 at
slot V_l, ``packed`` int32[V_l], ``acc`` int32[2P + 1, V_l] (P planes of
forb_all, P of forb_old, the clash flags), tables of combined entries
(block-local neighbor id, beats bit at ``BEATS_BIT``).

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel: a wrapper adds one where it
launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.compact import _clamp_k, _raise_on
from dgc_tpu_torch.kernels.shard import _check_ctrl
from dgc_tpu_torch.kernels.superstep import (CTRL_ACTIVE, CTRL_FAIL, CTRL_MC,
                                             CTRL_STATUS, INT32_MAX,
                                             _check_int32, _stream)
from dgc_tpu_torch.ops.speculative import (apply_update_mc, decode_combined,
                                           neighbor_stats)

SOURCE = "ring.cu"
# a table wider than this goes to K24 (one warp a row), as the compact
# engine's hub region takes the buckets wider than its flat cap
WIDE_WIDTH = 256
_RUNNING = int(AttemptStatus.RUNNING)

launch_counts = {"ring_stats": 0, "ring_stats_wide": 0, "ring_apply": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def new_acc(planes: int, v_local: int, device) -> torch.Tensor:
    """The accumulators of a ``planes``-plane window, zero."""
    return torch.zeros((2 * planes + 1, v_local), dtype=torch.int32,
                       device=device)


def new_blocks(v_local: int, device) -> torch.Tensor:
    """The two block buffers int32[2, V_l + 1], −1 at slot V_l."""
    return torch.full((2, v_local + 1), -1, dtype=torch.int32, device=device)


# ---- plain versions ---------------------------------------------------------

def ring_stats_reference(ctrl: torch.Tensor, block: torch.Tensor,
                         packed: torch.Tensor, table: torch.Tensor, rows,
                         acc: torch.Tensor, planes: int, *,
                         wide: bool = False) -> None:
    """K23's (and K24's) plain version: ``ops.speculative.neighbor_stats``
    of the table's rows against ``block``, OR-merged into ``acc``
    (``wide`` changes nothing here)."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    vl = packed.shape[0]
    if rows is None:
        local = torch.arange(vl, device=packed.device)
    else:
        real = rows < vl
        local, table = rows[real].to(torch.int64), table[real]
    nb, beats = decode_combined(table)
    fa, fo, clash = neighbor_stats(block[nb.to(torch.int64)], beats,
                                   packed[local] >> 1, planes)
    acc[:planes, local] |= fa.T
    acc[planes: 2 * planes, local] |= fo.T
    acc[2 * planes, local] |= clash.to(torch.int32)


def ring_apply_reference(ctrl: torch.Tensor, packed: torch.Tensor,
                         acc: torch.Tensor, back: torch.Tensor, planes: int,
                         k: int, fail_valid: bool) -> None:
    """K25's plain version: ``ops.speculative.apply_update_mc``."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    new, fail_mask, active_mask, mc = apply_update_mc(
        packed, acc[:planes].T, acc[planes: 2 * planes].T,
        acc[2 * planes] != 0, _clamp_k(k))
    back.copy_(new)
    if fail_valid:
        ctrl[CTRL_FAIL] += fail_mask.sum().to(torch.int32)
    ctrl[CTRL_ACTIVE] += active_mask.sum().to(torch.int32)
    ctrl[CTRL_MC] = torch.maximum(ctrl[CTRL_MC], mc)
    acc.zero_()


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_ring_stats.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp,
                                       ci, ci, vp]
        lib.dgc_ring_stats.restype = ci
        lib.dgc_ring_apply.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.dgc_ring_apply.restype = ci
        lib._dgc_bound = True
    return lib


def _check_acc(acc: torch.Tensor, planes: int, vl: int, device) -> None:
    _check_int32("acc", acc, device, 2)
    if not 1 <= planes <= INT32_MAX // 64 or \
            tuple(acc.shape) != (2 * planes + 1, vl):
        raise ValueError(f"acc must be [2*{planes}+1, {vl}], got "
                         f"{tuple(acc.shape)}")


def ring_stats(ctrl: torch.Tensor, block: torch.Tensor, packed: torch.Tensor,
               table: torch.Tensor, rows, acc: torch.Tensor, planes: int, *,
               wide: bool = False) -> None:
    """K23 (K24 with ``wide``: one warp per row): ``table`` int32[rows, W]
    of combined entries; ``rows`` int32[rows] local row ids (sentinel V_l)
    or None (a flat table of V_l rows). The launch counts under
    ``ring_stats`` or ``ring_stats_wide``. Runs on the current stream,
    does not synchronize."""
    name = "ring_stats_wide" if wide else "ring_stats"
    device = packed.device
    if device.type == "cpu":
        return ring_stats_reference(ctrl, block, packed, table, rows, acc,
                                    planes)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    _check_ctrl(ctrl, device)
    _check_int32("block", block, device, 1)
    _check_int32("packed", packed, device, 1)
    _check_int32("table", table, device, 2)
    vl = packed.shape[0]
    nrows, width = table.shape
    if block.shape[0] != vl + 1 or vl < 1:
        raise ValueError(f"block must be [V_l + 1] for packed [{vl}]")
    if rows is None:
        if nrows != vl:
            raise ValueError(f"a flat table must have {vl} rows, got {nrows}")
    else:
        _check_int32("rows", rows, device, 1)
        if rows.shape[0] != nrows:
            raise ValueError(f"rows must be [{nrows}]")
    if nrows < 1 or width < 1:
        raise ValueError(f"bad table shape {tuple(table.shape)}")
    _check_acc(acc, planes, vl, device)
    _raise_on(_library().dgc_ring_stats(
        ctrl.data_ptr(), block.data_ptr(), packed.data_ptr(),
        table.data_ptr(), None if rows is None else rows.data_ptr(),
        int(nrows), int(width), int(vl), acc.data_ptr(), int(planes),
        int(bool(wide)), _stream(device)), name)
    launch_counts[name] += 1


def ring_apply(ctrl: torch.Tensor, packed: torch.Tensor, acc: torch.Tensor,
               back: torch.Tensor, planes: int, k: int,
               fail_valid: bool) -> None:
    """K25: ``packed`` the carry, ``back`` the new words (int32[V_l]
    each). Runs on the current stream, does not synchronize."""
    device = packed.device
    if device.type == "cpu":
        return ring_apply_reference(ctrl, packed, acc, back, planes, k,
                                    fail_valid)
    if device.type != "cuda":
        raise ValueError(f"ring_apply: unsupported device {device}")
    _check_ctrl(ctrl, device)
    _check_int32("packed", packed, device, 1)
    _check_int32("back", back, device, 1)
    vl = packed.shape[0]
    if back.shape[0] != vl or vl < 1:
        raise ValueError(f"packed and back must be [V_l >= 1], got {vl} and "
                         f"{back.shape[0]}")
    _check_acc(acc, planes, vl, device)
    _raise_on(_library().dgc_ring_apply(
        ctrl.data_ptr(), packed.data_ptr(), acc.data_ptr(), back.data_ptr(),
        int(vl), int(planes), _clamp_k(k), int(bool(fail_valid)),
        _stream(device)), "ring_apply")
    launch_counts["ring_apply"] += 1
