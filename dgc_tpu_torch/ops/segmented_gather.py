"""Segmented-gather superstep plan — the plain PyTorch version.

Port of ``dgc_tpu.ops.segmented_gather``. A **plan** is a static tuple of
:class:`Seg` descriptors: contiguous row spans, each with its clip width,
bitmask plane count and offset into one flat concatenated table layout
(row-major within each segment, segments in row order). One superstep over
a plan is one neighbor gather over the whole flat layout plus the update
rule per segment, each segment at its own plane window and fail gate.

The segmented superstep kernel (``kernels.compact``, ``csrc/compact.cu``
K5) evaluates each row at its segment's own plane count with the
per-segment :func:`fail_gate`; these functions are what it is held
against.

Exactness of the collapsed path (one ``apply_update_mc`` at the plan's
maximum plane count): a segment whose window covers its width + 1 colors
computes the same per-row outcome at any plane count at or above its own —
a row has at most ``width`` forbidden colors, so its first-fit candidate
lands inside its window, and the padded planes only add free bits above a
free bit. Capped segments do not satisfy this, so :func:`plan_collapsible`
gates the collapsed path and the other branch runs one update per segment.
Both branches are kept so the tests can show they agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dgc_tpu_torch.ops.speculative import (apply_update_mc, decode_combined,
                                           neighbor_stats)


class Seg(NamedTuple):
    """One static segment of a segmented-gather plan.

    Rows ``[row0, row0 + rows)`` of the plan's row space are gathered at
    ``width`` columns and reduced with ``planes`` bitmask planes;
    ``flat0`` is the segment's offset into the flat concatenated layout.
    """

    row0: int
    rows: int
    width: int
    planes: int
    flat0: int


def plan_from_ranges(ranges) -> tuple:
    """Plan from stage width-ranges ``((r0, r1, width, planes), ...)``
    (``engine.compact.stage_slot_ranges`` layout: contiguous, covering
    ``[0, a_pad)``)."""
    segs = []
    flat0 = 0
    for r0, r1, w, p in ranges:
        segs.append(Seg(int(r0), int(r1) - int(r0), int(w), int(p), flat0))
        flat0 += (int(r1) - int(r0)) * int(w)
    _check_plan(tuple(segs))
    return tuple(segs)


def plan_from_parts(sizes, widths, planes) -> tuple:
    """Plan over a run of contiguous table parts (flat buckets): part i
    owns rows ``[Σ sizes[:i], Σ sizes[:i+1])``."""
    segs = []
    row0 = flat0 = 0
    for sz, w, p in zip(sizes, widths, planes):
        segs.append(Seg(row0, int(sz), int(w), int(p), flat0))
        row0 += int(sz)
        flat0 += int(sz) * int(w)
    _check_plan(tuple(segs))
    return tuple(segs)


def _check_plan(plan: tuple) -> None:
    row = flat = 0
    for s in plan:
        if s.row0 != row or s.flat0 != flat:
            raise ValueError(f"non-contiguous segmented plan: {plan}")
        if s.rows < 0 or s.width < 1 or s.planes < 1:
            raise ValueError(f"degenerate segment {s} in plan {plan}")
        row = s.row0 + s.rows
        flat = s.flat0 + s.rows * s.width


def plan_rows(plan: tuple) -> int:
    """Total rows covered by the plan."""
    return sum(s.rows for s in plan)


def plan_size(plan: tuple) -> int:
    """Total flat entries: the plan's per-superstep gather volume."""
    return sum(s.rows * s.width for s in plan)


def plan_max_planes(plan: tuple) -> int:
    return max(s.planes for s in plan)


def fail_gate(width: int, planes: int, k) -> bool:
    """A window covering the segment's width asserts failure exactly; a
    capped window must not unless k fits inside it (the bucketed engines'
    capped-window failure contract)."""
    fail_exact = 32 * planes >= width + 1
    return bool(fail_exact or int(k) <= 32 * planes)


def plan_collapsible(plan: tuple) -> bool:
    """True when every segment's window covers its width: the collapsed
    single-``apply_update_mc`` path is then exact (module docstring)."""
    return all(32 * s.planes >= s.width + 1 for s in plan)


def segmented_gather(pe_src: torch.Tensor, seg_comb: torch.Tensor):
    """The one gather of every segment's neighbor state. ``seg_comb`` is
    the flat combined (neighbor id | beats bit) layout. Returns
    ``(np_flat, beats_flat)``."""
    nb, beats = decode_combined(seg_comb)
    return pe_src[nb.to(torch.int64)], beats


def _seg_stats(np_flat, beats_flat, plan: tuple, mycol) -> list:
    """Per-segment ``neighbor_stats`` on slices of the one gathered vector,
    each segment at its own plane count."""
    out = []
    for s in plan:
        span = slice(s.flat0, s.flat0 + s.rows * s.width)
        blk = np_flat[span].reshape(s.rows, s.width)
        bts = beats_flat[span].reshape(s.rows, s.width)
        out.append(neighbor_stats(blk, bts, mycol[s.row0: s.row0 + s.rows],
                                  s.planes))
    return out


def _pad_planes(planes_arr: torch.Tensor, p: int) -> torch.Tensor:
    have = planes_arr.shape[-1]
    if have == p:
        return planes_arr
    pad = torch.zeros(planes_arr.shape[:-1] + (p - have,),
                      dtype=planes_arr.dtype, device=planes_arr.device)
    return torch.cat([planes_arr, pad], dim=-1)


def unconf_counts(comb: torch.Tensor, np_: torch.Tensor, v: int):
    """Per-entry unconfirmed-neighbor flags (int32) of combined-table
    entries ``comb`` whose gathered states are ``np_``: the entry is real
    (its id below the pad sentinel ``v``) and its state is not confirmed."""
    nb, _ = decode_combined(comb)
    return ((nb < v) & ~((np_ >= 0) & ((np_ & 1) == 0))).to(torch.int32)


def plan_unconf_max(pe_src: torch.Tensor, seg_comb: torch.Tensor,
                    plan: tuple, pk_rows: torch.Tensor, v: int) -> int:
    """The max count of unconfirmed neighbors over the plan's active rows
    (inactive rows count 0), for the telemetry columns: port of
    ``dgc_tpu.ops.segmented_gather.plan_unconf_max``."""
    np_flat, _ = segmented_gather(pe_src, seg_comb)
    flags = unconf_counts(seg_comb, np_flat, v)
    act = (pk_rows < 0) | ((pk_rows & 1) == 1)
    out = 0
    for s in plan:
        cnt = flags[s.flat0: s.flat0 + s.rows * s.width].reshape(
            s.rows, s.width).sum(dim=1)
        live = torch.where(act[s.row0: s.row0 + s.rows], cnt, 0)
        out = max(out, int(live.max()) if s.rows else 0)
    return out


def segmented_update(pe_src: torch.Tensor, seg_comb: torch.Tensor,
                     plan: tuple, pk_rows: torch.Tensor, k):
    """One whole-plan superstep: one gather, then the rule over the rows.

    ``pk_rows`` is the packed state of the plan's rows (contiguous).
    Returns ``(new_rows, fail_count, act_count, mc)``, the counts and
    ``mc`` as int32 scalar tensors: the collapsed single
    ``apply_update_mc`` when :func:`plan_collapsible` holds, else the
    per-segment updates of :func:`segmented_update_parts`.
    """
    np_flat, beats_flat = segmented_gather(pe_src, seg_comb)
    stats = _seg_stats(np_flat, beats_flat, plan, pk_rows >> 1)
    if plan_collapsible(plan):
        p = plan_max_planes(plan)
        forb_all = torch.cat([_pad_planes(fa, p) for fa, _, _ in stats])
        forb_old = torch.cat([_pad_planes(fo, p) for _, fo, _ in stats])
        clash = torch.cat([c for _, _, c in stats])
        new_rows, fail_mask, act_mask, mc = apply_update_mc(
            pk_rows, forb_all, forb_old, clash, k)
        return (new_rows, fail_mask.sum().to(torch.int32),
                act_mask.sum().to(torch.int32), mc)
    parts = segmented_update_parts(pe_src, seg_comb, plan, pk_rows, k,
                                   stats=stats)
    new_rows = torch.cat([p_[0] for p_ in parts])
    fail = torch.stack([p_[1] for p_ in parts]).sum().to(torch.int32)
    act = torch.stack([p_[2] for p_ in parts]).sum().to(torch.int32)
    mc = torch.stack([p_[3] for p_ in parts]).max()
    return new_rows, fail, act, mc


def segmented_update_parts(pe_src: torch.Tensor, seg_comb: torch.Tensor,
                           plan: tuple, pk_rows: torch.Tensor, k,
                           stats=None) -> list:
    """Per-segment superstep results from one shared gather: a list of
    ``(new_seg, fail_count, act_count, mc)`` per segment, the fail count
    gated per segment by :func:`fail_gate`."""
    if stats is None:
        np_flat, beats_flat = segmented_gather(pe_src, seg_comb)
        stats = _seg_stats(np_flat, beats_flat, plan, pk_rows >> 1)
    out = []
    for s, (forb_all, forb_old, clash) in zip(plan, stats):
        pk_b = pk_rows[s.row0: s.row0 + s.rows]
        new_b, fail_mask, act_mask, mc = apply_update_mc(
            pk_b, forb_all, forb_old, clash, k)
        fv = int(fail_gate(s.width, s.planes, k))
        out.append((new_b, fail_mask.sum().to(torch.int32) * fv,
                    act_mask.sum().to(torch.int32), mc))
    return out
