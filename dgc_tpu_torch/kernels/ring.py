"""Wrappers of the ring-halo engine's kernels (``csrc/ring.cu``) and their
plain PyTorch versions.

- ``ring_stats`` (K23): one rotation's neighbor stats of the shard's rows
  against the block the rank holds, OR-folded into the accumulators, over
  all of the rotation's tables of at most ``WIDE_WIDTH`` in one launch
  (``NarrowTables``: a flat rotation table, whose row j is local row j,
  or the degree buckets' rows, ``rows`` with sentinel ``V_l`` skipped): a
  team of ``team_lanes(width)`` lanes a row over its real entries.
- ``ring_stats_wide`` (K24): the same function over all of a rotation's
  tables wider than ``WIDE_WIDTH`` in one launch (``WideTables``): one
  block per item of a work list of (row, chunk of at most ``WIDE_CHUNK``
  real entries), so a hub row is split over the card by its real length.
- ``ring_apply`` (K25): ``apply_update_mc`` from the accumulated stats: the
  new words into ``back``, the fail (where ``fail_valid``), active and
  ``mc`` counters into the control block (``kernels.shard``'s, the slots
  K20 writes); it reads and zeroes only the planes the row's mask names,
  then the clash flag and the mask.

Every kernel returns at once unless the control block's status is
RUNNING. K23 and K24 skip a confirmed row (its word colored and not
fresh): its accumulators and mask stay 0, and K25 transitions it to itself
whatever they hold. Layout (``csrc/ring.cu``): ``block`` int32[V_l + 1]
with −1 at slot V_l, ``packed`` int32[V_l], ``acc`` int32[2P + 2, V_l]
(P planes of forb_all, P of forb_old, the clash flags, the touched-plane
masks: bit ``p // mask_group(P)`` of a row's mask set once plane p of its
forb_all or forb_old took a nonzero word), tables of combined entries
(block-local neighbor id, beats bit at ``BEATS_BIT``). The accumulators are zero
between supersteps; K25 takes a plane whose mask bit is clear as zero.

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel: a wrapper adds one where it
launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.compact import _clamp_k, _raise_on
from dgc_tpu_torch.kernels.shard import _check_ctrl
from dgc_tpu_torch.kernels.superstep import (CTRL_ACTIVE, CTRL_FAIL, CTRL_MC,
                                             CTRL_STATUS, INT32_MAX,
                                             _check_int32, _stream,
                                             check_plan, team_lanes)
from dgc_tpu_torch.ops.bitmask import _as_int32_bits
from dgc_tpu_torch.ops.speculative import (NBR_MASK, apply_update_mc,
                                           decode_combined, neighbor_stats)

SOURCE = "ring.cu"
# a table wider than this goes to K24, as the compact engine's hub region
# takes the buckets wider than its flat cap
WIDE_WIDTH = 256
# K24's chunk: the most real entries one block of 256 threads reads (one
# 16-byte load a thread; PERF.md §6 has the times by chunk size)
WIDE_CHUNK = 1024
# a descriptor row of the narrow layout (dJ0 ... dWarp0 in csrc/ring.cu)
NARROW_J0, NARROW_ROWS, NARROW_WIDTH, NARROW_OFF, NARROW_WARP0 = range(5)
_RUNNING = int(AttemptStatus.RUNNING)

launch_counts = {"ring_stats": 0, "ring_stats_wide": 0, "ring_apply": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mask_group(planes: int) -> int:
    """Planes a bit of the touched-plane mask: the least power of two
    that fits ``planes`` into 32 bits (1 up to 32 planes)."""
    group = 1
    while 32 * group < planes:
        group *= 2
    return group


def new_acc(planes: int, v_local: int, device) -> torch.Tensor:
    """The accumulators of a ``planes``-plane window, zero."""
    return torch.zeros((2 * planes + 2, v_local), dtype=torch.int32,
                       device=device)


def new_blocks(v_local: int, device) -> torch.Tensor:
    """The two block buffers int32[2, V_l + 1], −1 at slot V_l."""
    return torch.full((2, v_local + 1), -1, dtype=torch.int32, device=device)


def real_lengths(table: np.ndarray, vl: int) -> np.ndarray:
    """int64[rows]: each row of ``table`` one past its last entry that is
    not the sentinel ``vl`` (0 for a row of sentinels alone)."""
    real = (table & NBR_MASK) != vl
    return np.where(real.any(axis=1),
                    table.shape[1] - np.argmax(real[:, ::-1], axis=1), 0)


def narrow_teams(desc: np.ndarray, warps: int) -> np.ndarray:
    """The row of the concatenated row list (−1: none) that each team of
    K23's grid walks, in the kernel's order (warp, then the group within
    the warp; a warp's table the last whose first warp is at or before
    it), for the layout ``desc`` (int64[nseg, 5]) of ``warps`` warps."""
    out = []
    for gw in range(warps):
        s = int(np.searchsorted(desc[:, NARROW_WARP0], gw, side="right")) - 1
        j0, nrows, width, _, w0 = (int(x) for x in desc[s])
        lanes = team_lanes(width)
        for sub in range(32 // lanes):
            rs = (gw - w0) * (32 // lanes) + sub
            out.append(j0 + rs if rs < nrows else -1)
    return np.asarray(out, np.int64)


def wide_work_list(buckets, vl: int, chunk: int = WIDE_CHUNK) -> np.ndarray:
    """K24's work list over ``buckets`` (``(rows or None, table)`` NumPy
    pairs, the tables in order as ``WideTables`` concatenates them):
    int32[items, 4] of (local row, entry count, low and high word of the
    offset of the chunk's first entry in the concatenation). A row's real
    length runs to its last entry that is not the sentinel ``vl``; it is
    cut into chunks of ``chunk`` entries, the last shorter; a padding row
    (``rows`` at ``vl``) or a row with no real entry has none."""
    out = []
    base = 0
    for rows, table in buckets:
        n_rows, width = table.shape
        length = real_lengths(table, vl)
        local = (np.arange(n_rows, dtype=np.int64) if rows is None
                 else np.asarray(rows, np.int64))
        j = np.flatnonzero((local < vl) & (length > 0))
        count = -(-length[j] // chunk)
        first = np.cumsum(count) - count
        item_row = np.repeat(j, count)
        e0 = (np.arange(int(count.sum()), dtype=np.int64)
              - np.repeat(first, count)) * chunk
        off = base + item_row * width + e0
        out.append(np.stack([local[item_row],
                             np.minimum(chunk, length[item_row] - e0),
                             off & 0xFFFFFFFF, off >> 32], axis=1))
        base += n_rows * width
    work = np.concatenate(out) if out else np.zeros((0, 4), np.int64)
    return work.astype(np.uint32).view(np.int32)


class WideTables:
    """One rotation's tables wider than ``WIDE_WIDTH`` as K24 takes them:
    ``entries`` int32[Σ rows·W], the tables concatenated; ``buckets`` the
    ``(rows or None, table)`` pairs, each table a view of ``entries``;
    ``work`` int32[items, 4], ``wide_work_list``'s, built once here."""

    def __init__(self, buckets, vl: int, device, chunk: int = WIDE_CHUNK):
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(
                device)

        tables = [np.asarray(table, np.int32) for _, table in buckets]
        self.vl, self.chunk = int(vl), int(chunk)
        self.entries = t(np.concatenate([tb.ravel() for tb in tables]))
        self.work = t(wide_work_list(buckets, vl, chunk))
        views, base = [], 0
        for (rows, _), tb in zip(buckets, tables):
            views.append((None if rows is None else t(rows),
                          self.entries[base: base + tb.size].view(tb.shape)))
            base += tb.size
        self.buckets = tuple(views)


class NarrowTables:
    """One rotation's tables of at most ``WIDE_WIDTH`` as K23 takes them,
    built once: ``entries`` int32[Σ rows·W], the tables concatenated;
    ``rows`` int32[Σ rows], their row lists (a flat table's ``0 .. V_l −
    1``); ``lens`` int32[Σ rows], each table row's real length
    (``real_lengths``); ``desc`` int64[nseg, 5] a table (its first row in
    ``rows``, rows, width, offset in ``entries``, first warp: its rows at
    ``32 / team_lanes(width)`` a warp); ``warps`` the grid's warps;
    ``buckets`` the ``(rows or None, table, lens)`` views, a table's
    ``rows`` None where it came without a list."""

    def __init__(self, buckets, vl: int, device):
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(
                device)

        tables = [np.asarray(table, np.int32) for _, table in buckets]
        self.vl = int(vl)
        lists = [np.arange(tb.shape[0], dtype=np.int32) if rows is None
                 else np.asarray(rows, np.int32)
                 for (rows, _), tb in zip(buckets, tables)]
        lens = [real_lengths(tb, vl) for tb in tables]
        desc, j0, off, warp0 = [], 0, 0, 0
        for tb in tables:
            n, w = tb.shape
            desc.append((j0, n, w, off, warp0))
            j0, off = j0 + n, off + tb.size
            warp0 += -(-n * team_lanes(w) // 32)
        self.warps = warp0
        self.desc = torch.tensor(desc, dtype=torch.int64,
                                 device=device).reshape(len(desc), 5)
        self.entries = t(np.concatenate([tb.ravel() for tb in tables]))
        self.rows = t(np.concatenate(lists))
        self.lens = t(np.concatenate(lens))
        views = []
        for (rows, _), tb, (j, n, w, o, _w0) in zip(buckets, tables, desc):
            views.append((None if rows is None else self.rows[j: j + n],
                          self.entries[o: o + tb.size].view(n, w),
                          self.lens[j: j + n]))
        self.buckets = tuple(views)


# ---- plain versions ---------------------------------------------------------

def _touched(fa: torch.Tensor, fo: torch.Tensor, planes: int) -> torch.Tensor:
    """int32[rows] masks: bit b set where a plane of group b of the row's
    ``fa`` or ``fo`` (int32[rows, P]) is nonzero."""
    group = mask_group(planes)
    ngroups = -(-planes // group)
    nz = (fa | fo) != 0
    pad = ngroups * group - planes
    if pad:
        nz = torch.cat([nz, nz.new_zeros((nz.shape[0], pad))], dim=1)
    any_g = nz.reshape(nz.shape[0], ngroups, group).any(dim=2)
    bit = torch.ones(ngroups, dtype=torch.int64, device=fa.device) << \
        torch.arange(ngroups, dtype=torch.int64, device=fa.device)
    return _as_int32_bits((any_g.to(torch.int64) * bit).sum(dim=1))


def _or_stats(acc, local, fa, fo, clash, planes: int) -> None:
    """OR stats into the accumulators of ``local`` (distinct rows)."""
    acc[:planes, local] |= fa.T
    acc[planes: 2 * planes, local] |= fo.T
    acc[2 * planes, local] |= clash.to(torch.int32)
    acc[2 * planes + 1, local] |= _touched(fa, fo, planes)


def table_stats(block: torch.Tensor, packed: torch.Tensor,
                table: torch.Tensor, rows, acc: torch.Tensor,
                planes: int) -> None:
    """``ops.speculative.neighbor_stats`` of one table's rows (``rows``
    local ids, sentinel V_l, or None: table row j is local row j) that
    are not confirmed against ``block``, OR-merged into ``acc``."""
    vl = packed.shape[0]
    local = (torch.arange(table.shape[0], device=packed.device)
             if rows is None else rows.to(torch.int64))
    real = local < vl
    word = packed[torch.where(real, local, 0)]
    keep = real & ~((word >= 0) & ((word & 1) == 0))
    local, table = local[keep], table[keep]
    nb, beats = decode_combined(table)
    fa, fo, clash = neighbor_stats(block[nb.to(torch.int64)], beats,
                                   packed[local] >> 1, planes)
    _or_stats(acc, local, fa, fo, clash, planes)


def ring_stats_reference(ctrl: torch.Tensor, block: torch.Tensor,
                         packed: torch.Tensor, narrow: NarrowTables,
                         acc: torch.Tensor, planes: int) -> None:
    """K23's plain version: ``table_stats`` over each of ``narrow``'s
    tables, read up to its longest real row (``lens``, checked against
    the table: every entry past a row's length must be the sentinel)."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    vl = packed.shape[0]
    for rows, table, lens in narrow.buckets:
        check_plan(table, lens, vl)
        width = max(1, int(lens.max())) if lens.shape[0] else 1
        table_stats(block, packed, table[:, :width], rows, acc, planes)


def ring_stats_wide_reference(ctrl: torch.Tensor, block: torch.Tensor,
                              packed: torch.Tensor, wide: WideTables,
                              acc: torch.Tensor, planes: int) -> None:
    """K24's plain version: ``table_stats`` over each of ``wide``'s
    tables (OR is order-free, so the chunks of a row need not be seen;
    the work list is not read)."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    for rows, table in wide.buckets:
        table_stats(block, packed, table, rows, acc, planes)


def ring_apply_reference(ctrl: torch.Tensor, packed: torch.Tensor,
                         acc: torch.Tensor, back: torch.Tensor, planes: int,
                         k: int, fail_valid: bool) -> None:
    """K25's plain version: ``ops.speculative.apply_update_mc`` over the
    planes the masks name (the others taken as zero); those planes, the
    clash flags and the masks back to zero."""
    if int(ctrl[CTRL_STATUS]) != _RUNNING:
        return
    group = torch.arange(planes, device=acc.device) // mask_group(planes)
    mask = acc[2 * planes + 1].to(torch.int64) & 0xFFFFFFFF
    touched = ((mask[None, :] >> group[:, None]) & 1) == 1  # [P, V_l]
    fa = torch.where(touched, acc[:planes], 0)
    fo = torch.where(touched, acc[planes: 2 * planes], 0)
    new, fail_mask, active_mask, mc = apply_update_mc(
        packed, fa.T, fo.T, acc[2 * planes] != 0, _clamp_k(k))
    back.copy_(new)
    if fail_valid:
        ctrl[CTRL_FAIL] += fail_mask.sum().to(torch.int32)
    ctrl[CTRL_ACTIVE] += active_mask.sum().to(torch.int32)
    ctrl[CTRL_MC] = torch.maximum(ctrl[CTRL_MC], mc)
    acc[: 2 * planes].masked_fill_(torch.cat([touched, touched]), 0)
    acc[2 * planes:].zero_()


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_ring_stats.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                       ci, vp, ci, vp]
        lib.dgc_ring_stats.restype = ci
        lib.dgc_ring_stats_wide.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp,
                                            ci, vp]
        lib.dgc_ring_stats_wide.restype = ci
        lib.dgc_ring_apply.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.dgc_ring_apply.restype = ci
        lib._dgc_bound = True
    return lib


def _check_acc(acc: torch.Tensor, planes: int, vl: int, device) -> None:
    _check_int32("acc", acc, device, 2)
    if not 1 <= planes <= INT32_MAX // 64 or \
            tuple(acc.shape) != (2 * planes + 2, vl):
        raise ValueError(f"acc must be [2*{planes}+2, {vl}], got "
                         f"{tuple(acc.shape)}")


def _check_state(ctrl, block, packed, device) -> int:
    _check_ctrl(ctrl, device)
    _check_int32("block", block, device, 1)
    _check_int32("packed", packed, device, 1)
    vl = packed.shape[0]
    if block.shape[0] != vl + 1 or vl < 1:
        raise ValueError(f"block must be [V_l + 1] for packed [{vl}]")
    return vl


def ring_stats(ctrl: torch.Tensor, block: torch.Tensor, packed: torch.Tensor,
               narrow: NarrowTables, acc: torch.Tensor, planes: int) -> None:
    """K23 over ``narrow`` (a rotation's tables of at most ``WIDE_WIDTH``).
    Runs on the current stream, does not synchronize."""
    device = packed.device
    if device.type == "cpu":
        return ring_stats_reference(ctrl, block, packed, narrow, acc, planes)
    if device.type != "cuda":
        raise ValueError(f"ring_stats: unsupported device {device}")
    vl = _check_state(ctrl, block, packed, device)
    for name in ("entries", "rows", "lens"):
        _check_int32(name, getattr(narrow, name), device, 1)
    desc = narrow.desc
    if desc.device != device or desc.dtype != torch.int64 or \
            desc.dim() != 2 or desc.shape[1] != 5 or \
            not desc.is_contiguous() or desc.shape[0] < 1:
        raise ValueError("desc must be a contiguous int64[nseg >= 1, 5] on "
                         "the card")
    if narrow.vl != vl or narrow.warps < 1:
        raise ValueError(f"a narrow layout for V_l {vl} expected, got "
                         f"{narrow.vl} ({narrow.warps} warps)")
    _check_acc(acc, planes, vl, device)
    _raise_on(_library().dgc_ring_stats(
        ctrl.data_ptr(), block.data_ptr(), packed.data_ptr(),
        narrow.entries.data_ptr(), narrow.rows.data_ptr(),
        narrow.lens.data_ptr(), desc.data_ptr(), int(desc.shape[0]),
        int(narrow.warps), int(vl), acc.data_ptr(), int(planes),
        _stream(device)), "ring_stats")
    launch_counts["ring_stats"] += 1


def ring_stats_wide(ctrl: torch.Tensor, block: torch.Tensor,
                    packed: torch.Tensor, wide: WideTables,
                    acc: torch.Tensor, planes: int) -> None:
    """K24 over ``wide``'s work list (a rotation's wide tables). Runs on
    the current stream, does not synchronize; a list with no item
    launches nothing."""
    device = packed.device
    if device.type == "cpu":
        return ring_stats_wide_reference(ctrl, block, packed, wide, acc,
                                         planes)
    if device.type != "cuda":
        raise ValueError(f"ring_stats_wide: unsupported device {device}")
    vl = _check_state(ctrl, block, packed, device)
    _check_int32("entries", wide.entries, device, 1)
    _check_int32("work", wide.work, device, 2)
    if wide.vl != vl or wide.work.shape[1] != 4 or \
            wide.work.data_ptr() % 16:
        raise ValueError(f"a work list of [items, 4] (16-byte aligned) for "
                         f"V_l {vl} expected, got {tuple(wide.work.shape)} "
                         f"for {wide.vl}")
    _check_acc(acc, planes, vl, device)
    items = wide.work.shape[0]
    if items == 0:
        return
    _raise_on(_library().dgc_ring_stats_wide(
        ctrl.data_ptr(), block.data_ptr(), packed.data_ptr(),
        wide.entries.data_ptr(), wide.work.data_ptr(), int(items), int(vl),
        acc.data_ptr(), int(planes), _stream(device)), "ring_stats_wide")
    launch_counts["ring_stats_wide"] += 1


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
