"""Frontier-compacted engine (port of ``dgc_tpu.engine.compact``).

The superstep is gather-bound, and most rows go inert (confirmed, with
confirmed neighbors) long before an attempt ends, so the engine runs the
update rule over fewer rows as the frontier (uncolored ∪ fresh) shrinks:

1. **Full-table phase**: every bucket in one segmented superstep (K5 over
   the plan of all buckets, each at its own color window) while the
   frontier exceeds the first threshold.
2. **Compaction stages** at static thresholds: at stage entry the active
   rows are compacted, in relabeled order, into a slot list padded to
   ``pow2(scale)`` (K3), their rows of the flat ``[V+1, W_flat]`` combined
   table are gathered once into the stage's flat layout, each width range
   clipped to its own width (K4), and the stage's supersteps run K5 over
   those slots only.

Compaction is exact: a confirmed vertex never becomes active again, so
every row that can change is in the slot list; colors, supersteps and
statuses equal ``BucketedELLEngine``'s and the JAX engine's.

``sweep`` is the fused jump-mode pair: attempt k0 records the pre-state of
every superstep that sets a new divergence candidate (``mc``) record into a
ring of four (K6), and the confirm attempt at ``used − 1`` resumes from the
entry whose ``(best, mc]`` bracket contains the budget — the run at that
budget is identical up to that step — or starts over on a miss. Its step
counter continues from the entry, so its result equals a scratch run.

Buckets wider than ``flat_cap`` (or past the flat table's budget) form
the **hub region** (``engine.hub``; the hubs of a power-law graph): every
superstep each hub bucket takes a branch of its ladder by its live count
and prune tier — skip an inert bucket, all rows, only the active rows, or
only the rows' captured unconfirmed neighbors — chosen on the card by K7
and run by K8 (``kernels.hub``). The flat region (the rest) is what the
full-table phase's K5 and the compaction stages cover; its table
``flat_ext`` holds rows ``[flat_row0, V)`` only.

The host drives the schedule: per stage it launches K3 and K4, then
enqueues chunks of ``STAGE_CHUNK`` supersteps (K5, K7, K8 and K6 each) and
syncs once per chunk.

``attempt_block`` chains up to A attempts of the minimal-k loop with the
stopping rule on the card (``kernels.block``): every attempt records into
and resumes from one ring carried across attempts and blocks, K9 records
each attempt where it ends and K10 starts the next, and the host reads
one small buffer per attempt instead of the colors row.

With ``record_trajectory`` on, the recording variants of K5, K8 and K6
(and of K9 and K10 in a block) run instead (``obs.kernel``): K5 and K8
take each bucket's max unconfirmed-neighbor count into the unconf vector,
K6 writes the superstep's trajectory row (and its clock when
``record_timing`` is on). An attempt's buffer comes home with its colors
row in one copy, a block's stack with the block's last row; a
prefix-resumed confirm records only its rows after the resume, so its
``first_step`` is the resume step, as in ``dgc_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.engine.base import (AttemptResult, AttemptStatus,
                                       BlockAttemptResult, BlockOutcome,
                                       finish_sweep_pair)
from dgc_tpu_torch.engine.bucketed import (MAX_WINDOW_PLANES, STALL_WINDOW,
                                           BucketedELLEngine,
                                           build_combined_rows,
                                           build_degree_buckets)
from dgc_tpu_torch.engine.hub import (HUB_UNCOND_ENTRIES, hub_prune_cfg,
                                      pow2_ceil)
from dgc_tpu_torch.kernels import block as kb
from dgc_tpu_torch.kernels import compact as kc
from dgc_tpu_torch.kernels import hub as kh
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.obs.kernel import (decode_block_trajectories,
                                      decode_trajectory, read_home,
                                      traj_cap_for, traj_empty)
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.ops.segmented_gather import plan_from_parts, plan_from_ranges

_RUNNING = int(AttemptStatus.RUNNING)


def default_stages(v: int, heavy_tail: bool = False) -> tuple:
    """((scale, run_down_to_threshold), ...); scale None = full-table
    phase. A compaction stage's pad is ``pow2(scale)`` rows. Below 2^14
    vertices there is no compaction at all; bounded-degree graphs get the
    v/4 → v/16 → v/256 ladder, heavy-tailed ones two more rungs."""
    if v <= 1 << 14:
        return ((None, 0),)
    if not heavy_tail:
        return (
            (None, v // 4),
            (v // 4, v // 16),
            (v // 16, v // 256),
            (v // 256, 0),
        )
    return (
        (None, v // 4),
        (v // 4, v // 16),
        (v // 16, v // 64),
        (v // 64, v // 256),
        (v // 256, v // 1024),
        (v // 1024, 0),
    )


def stage_slot_ranges(flat_sizes, flat_widths, a_pad: int,
                      max_ranges: int = 6,
                      coalesce_pct: int = 10) -> tuple:
    """Static width ranges ``((start, stop, width, planes), …)`` covering a
    compaction stage's padded slot list ``[0, a_pad)``.

    Slots fill in degree-descending relabeled order, so the row at slot i
    belongs to a bucket at least as narrow as the one whose cumulative
    size first covers i; each range keeps that width. Adjacent ranges
    merge (taking the wider width) while the volume overhead stays under
    ``coalesce_pct``, then down to ``max_ranges`` (cheapest merges first).
    Planes are uncapped (``num_planes_for(w + 1)``)."""
    if max_ranges < 1:
        raise ValueError(f"max_ranges must be >= 1, got {max_ranges}")
    if not 0 <= coalesce_pct <= 100:
        raise ValueError(
            f"coalesce_pct must be in [0, 100], got {coalesce_pct}")
    exact = []
    q = cum = 0
    for sz, w in zip(flat_sizes, flat_widths):
        cum += int(sz)
        q1 = min(cum, a_pad)
        if q1 > q:
            exact.append((q, q1, int(w)))
            q = q1
        if q == a_pad:
            break
    if q < a_pad:
        w = int(flat_widths[-1]) if len(flat_widths) else 1
        exact.append((q, a_pad, w))

    exact_vol = sum((r1 - r0) * w for r0, r1, w in exact)
    budget = exact_vol * coalesce_pct // 100
    ranges = []
    for r0, r1, w in exact:
        if ranges:
            p0, p1, pw = ranges[-1]
            extra = (pw - w) * (r1 - r0)  # widths are non-increasing
            if extra <= budget:
                budget -= extra
                ranges[-1] = (p0, r1, pw)
                continue
        ranges.append((r0, r1, w))
    while len(ranges) > max_ranges:
        costs = [(ranges[i][2] - ranges[i + 1][2])
                 * (ranges[i + 1][1] - ranges[i + 1][0])
                 for i in range(len(ranges) - 1)]
        i = costs.index(min(costs))
        ranges[i] = (ranges[i][0], ranges[i + 1][1], ranges[i][2])
        del ranges[i + 1]
    return tuple((r0, r1, w, num_planes_for(w + 1)) for r0, r1, w in ranges)


DEFAULT_FLAT_CAP = 256
DEFAULT_FLAT_BUDGET = 1 << 29  # table entries (×4 B = 2 GiB)


def derive_schedule(sizes, widths, v: int, max_degree: int, *,
                    stages: tuple | None = None,
                    flat_cap: int | None = None,
                    flat_budget: int | None = None,
                    max_ranges: int = 6,
                    range_coalesce_pct: int = 10,
                    hub_uncond_entries: int | None = None,
                    prune_u_min: int = 128, prune_u_div: int = 4,
                    prune_p_div: int = 2,
                    prune_p2_min: int = 32, prune_p2_div: int = 8,
                    hub_prune_overrides: dict | None = None) -> dict:
    """The staged engine's static schedule from the bucket layout
    (``sizes``/``widths`` in degree-descending order) and the knobs: stage
    ladder, hub/flat split, per-hub-bucket prune/uncond configs, and
    per-stage width ranges. Knob validation raises ``ValueError``.

    Returns ``dict(stages, row0s, hub_buckets, hub_prune, hub_uncond,
    stage_ranges)``; ``stage_ranges`` is ``()`` when the ladder has no
    compaction stage."""
    cap = DEFAULT_FLAT_CAP if flat_cap is None else flat_cap
    budget = DEFAULT_FLAT_BUDGET if flat_budget is None else flat_budget
    uncond = (HUB_UNCOND_ENTRIES if hub_uncond_entries is None
              else hub_uncond_entries)
    for name, val, lo in (("flat_cap", cap, 1), ("flat_budget", budget, 1),
                          ("max_ranges", max_ranges, 1),
                          ("hub_uncond_entries", uncond, 0),
                          ("prune_u_min", prune_u_min, 1),
                          ("prune_p2_min", prune_p2_min, 1)):
        if not isinstance(val, int) or isinstance(val, bool) or val < lo:
            raise ValueError(f"{name} must be an int >= {lo}, got {val!r}")
    if not isinstance(range_coalesce_pct, int) \
            or isinstance(range_coalesce_pct, bool) \
            or not 0 <= range_coalesce_pct <= 100:
        raise ValueError(
            f"range_coalesce_pct must be an int in [0, 100], "
            f"got {range_coalesce_pct!r}")
    if stages is None:
        stages = default_stages(v, heavy_tail=max_degree > cap)
    _check_stage_ladder(stages, v)

    row0s = tuple(int(x) for x in
                  np.concatenate([[0], np.cumsum(sizes[:-1])]))
    # hub/flat split along the (width-descending) bucket order
    hub = 0
    while hub < len(widths):
        w_flat = widths[hub]
        rows = v - row0s[hub]
        if w_flat <= cap and rows * w_flat <= budget:
            break
        hub += 1
    overrides = hub_prune_overrides or {}
    ovr_keys = {"u_min", "u_div", "p_div", "p2_min", "p2_div"}
    for bi, ovr in overrides.items():
        if not isinstance(bi, int) or isinstance(bi, bool) or bi < 0:
            raise ValueError(
                f"hub_prune_overrides key must be a bucket index >= 0, "
                f"got {bi!r}")
        if not isinstance(ovr, dict) or set(ovr) - ovr_keys:
            raise ValueError(
                f"hub_prune_overrides[{bi}] must be a dict with keys from "
                f"{sorted(ovr_keys)}, got {ovr!r}")
        for k2, v2 in ovr.items():
            if not isinstance(v2, int) or isinstance(v2, bool) or v2 < 1:
                raise ValueError(
                    f"hub_prune_overrides[{bi}][{k2!r}] must be an int "
                    f">= 1, got {v2!r}")

    def _prune_for(bi: int):
        kw = dict(u_min=prune_u_min, u_div=prune_u_div,
                  p2_min=prune_p2_min, p_div=prune_p_div,
                  p2_div=prune_p2_div)
        kw.update(overrides.get(bi, {}))
        return hub_prune_cfg(sizes[bi], widths[bi],
                             uncond_entries=uncond, **kw)

    hub_prune = tuple(_prune_for(bi) for bi in range(hub))
    hub_uncond = tuple(
        sizes[bi] * widths[bi] <= uncond for bi in range(hub)
    )
    if all(scale is None for scale, _ in stages):
        stage_ranges = ()
    else:
        flat_sizes = sizes[hub:]
        flat_widths = widths[hub:]
        stage_ranges = tuple(
            None if scale is None else
            stage_slot_ranges(flat_sizes, flat_widths, pow2_ceil(scale),
                              max_ranges=max_ranges,
                              coalesce_pct=range_coalesce_pct)
            for scale, _ in stages
        )
    return dict(stages=stages, row0s=row0s, hub_buckets=hub,
                hub_prune=hub_prune, hub_uncond=hub_uncond,
                stage_ranges=stage_ranges)


def _check_stage_ladder(stages: tuple, v: int) -> None:
    """A compaction stage's scale must bound the frontier at entry (the
    previous stage's exit threshold, or V at the start), and thresholds
    must be non-increasing; a malformed ladder raises ``ValueError``."""
    if not stages:
        raise ValueError("stage ladder is empty; need at least one stage")
    bound = v
    for scale, thresh in stages:
        if scale is not None:
            if not isinstance(scale, int) or isinstance(scale, bool):
                raise ValueError(
                    f"stage scale must be int or None, got {scale!r}; "
                    f"stages={stages}")
            if scale < 1:
                raise ValueError(
                    f"stage scale must be >= 1, got {scale}; "
                    f"stages={stages}")
            if scale > v:
                raise ValueError(
                    f"stage scale {scale} > num_vertices {v} (a rung "
                    f"above V pads past the graph); stages={stages}")
            if scale < min(bound, v):
                raise ValueError(
                    f"stage scale {scale} < possible frontier "
                    f"{min(bound, v)}; stages={stages}")
        if not isinstance(thresh, int) or isinstance(thresh, bool):
            raise ValueError(
                f"stage threshold must be int, got {thresh!r}; "
                f"stages={stages}")
        if thresh < 0:
            raise ValueError(
                f"stage threshold must be >= 0, got {thresh}; "
                f"stages={stages}")
        if thresh > bound:
            raise ValueError(
                f"stage thresholds must be non-increasing, got {thresh} "
                f"after {bound}; stages={stages}")
        bound = thresh


def serve_stage_rungs(v: int) -> tuple:
    """Default stage ladder of the batched serve kernels (port of
    ``dgc_tpu.engine.compact.serve_stage_rungs``): denser at the top than
    ``default_stages``, because a serve stage superstep gathers its
    compacted rows from the class table every superstep (a rung's volume
    is ``pad × W`` against the full table's ``V × W``) and compaction is a
    stage-entry event. The same full-table floor (v ≤ 2^14)."""
    if v <= 1 << 14:
        return ((None, 0),)
    return ((None, v // 2), (v // 2, v // 4), (v // 4, v // 16),
            (v // 16, v // 64), (v // 64, v // 256), (v // 256, 0))


def class_stage_schedule(v_pad: int, w_pad: int, *,
                         stages: tuple | None = None) -> dict:
    """Stage schedule of a batched-serve shape class (port of
    ``dgc_tpu.engine.compact.class_stage_schedule``): ``derive_schedule``
    on one flat bucket of ``v_pad`` rows × ``w_pad`` columns, so the serve
    ladder and the single-graph ladder share one validity rule. Returns
    ``dict(stages, pads)``; ``pads[s]`` is stage ``s``'s compaction pad
    (``pow2(scale)``), None for a full-table stage."""
    sched = derive_schedule((v_pad,), (w_pad,), v_pad, w_pad,
                            stages=(serve_stage_rungs(v_pad)
                                    if stages is None else stages),
                            flat_cap=max(int(w_pad), DEFAULT_FLAT_CAP))
    st = sched["stages"]
    pads = tuple(None if s is None else pow2_ceil(s) for s, _ in st)
    return dict(stages=st, pads=pads)


class CompactFrontierEngine(BucketedELLEngine):
    """Staged frontier-compacted engine (single device), any bucket layout.

    Inherits the bucketed relabeling, tables and per-bucket color windows;
    colors, supersteps and statuses equal ``BucketedELLEngine``'s. The
    schedule knobs are ``dgc_tpu``'s, with its names and defaults
    (``derive_schedule``); they move work, never results.
    """

    FLAT_CAP = DEFAULT_FLAT_CAP
    FLAT_BUDGET = DEFAULT_FLAT_BUDGET
    STAGE_CHUNK = 16  # supersteps enqueued per host sync within a stage

    def __init__(self, arrays: GraphArrays, max_steps: int | None = None,
                 min_width: int = 4, stages: tuple | None = None,
                 max_window_planes: int = MAX_WINDOW_PLANES,
                 flat_cap: int | None = None,
                 prune_u_min: int = 128, prune_u_div: int = 4,
                 prune_p2_min: int = 32,
                 hub_uncond_entries: int | None = None,
                 max_ranges: int = 6, range_coalesce_pct: int = 10,
                 prune_p_div: int = 2, prune_p2_div: int = 8,
                 hub_prune_overrides: dict | None = None, device="cuda"):
        v = arrays.num_vertices
        b = build_degree_buckets(arrays, min_width=min_width)
        sizes = [cb.shape[0] for cb in b.combined]
        widths = [cb.shape[1] for cb in b.combined]
        sched = derive_schedule(
            sizes, widths, v, int(arrays.max_degree), stages=stages,
            flat_cap=flat_cap if flat_cap is not None else self.FLAT_CAP,
            flat_budget=self.FLAT_BUDGET, max_ranges=max_ranges,
            range_coalesce_pct=range_coalesce_pct,
            hub_uncond_entries=hub_uncond_entries,
            prune_u_min=prune_u_min, prune_u_div=prune_u_div,
            prune_p_div=prune_p_div, prune_p2_min=prune_p2_min,
            prune_p2_div=prune_p2_div,
            hub_prune_overrides=hub_prune_overrides)
        hub = sched["hub_buckets"]
        flat_ext = None
        if sched["stage_ranges"]:
            # the flat table: the relabeled CSR's rows [flat_row0, V)
            w_flat = max(widths[hub:]) if hub < len(widths) else 1
            f0 = sched["row0s"][hub] if hub < len(widths) else v
            flat_ext = np.concatenate([
                build_combined_rows(b.indptr, b.indices, b.degrees, f0, v,
                                    w_flat, v,
                                    native=len(b.indices) >= 1_000_000),
                np.full((1, w_flat), v, np.int32)])
        self._setup(b.perm, b.degrees, b.row0, b.combined, None,
                    max_window_planes, device, max_steps=max_steps,
                    stages=sched["stages"],
                    stage_ranges=sched["stage_ranges"], hub_buckets=hub,
                    flat_ext=flat_ext, hub_prune=sched["hub_prune"],
                    hub_uncond=sched["hub_uncond"])

    def _setup(self, perm, degrees, row0s, combined_list, planes,
               max_window_planes, device, max_steps=None, *, stages,
               stage_ranges, hub_buckets, flat_ext, hub_prune=(),
               hub_uncond=()):
        # also the build from given tables (convert.compact_engine_from_tables)
        super()._setup(perm, degrees, row0s, combined_list, planes,
                       max_window_planes, device, max_steps=max_steps)
        v = self.num_vertices
        # every bucket's table concatenated once, hub buckets first: the
        # hub kernels read them at their offsets, the full-table phase the
        # flat buckets' part; the buckets become views into it
        self.seg_flat = torch.cat([cb.reshape(-1) for cb in self.combined_buckets])
        views, off = [], 0
        for cb in self.combined_buckets:
            views.append(self.seg_flat[off: off + cb.numel()].view(cb.shape))
            off += cb.numel()
        self.combined_buckets = tuple(views)
        self.stages = tuple(stages)
        self.stage_ranges = tuple(stage_ranges)
        self.hub_buckets = hub = int(hub_buckets)
        self.hub_prune = tuple(hub_prune)
        self.hub_uncond = tuple(hub_uncond)
        has_flat = hub < len(self.combined_buckets)
        self.flat_row0 = self.row0[hub] if has_flat else v
        # the live counts ba: per hub bucket, then the flat region's total
        deg = self.degrees.cpu().numpy()
        sizes = [cb.shape[0] for cb in self.combined_buckets]
        init = [int(np.count_nonzero(deg[r0: r0 + vb] > 0))
                for r0, vb in zip(self.row0[:hub], sizes[:hub])]
        if has_flat:
            init.append(int(np.count_nonzero(deg[self.flat_row0:] > 0)))
        self.init_bucket_active = tuple(init)
        self.flat_ext = None
        self.flat_planes = 0
        if flat_ext is not None:
            self.flat_ext = torch.from_numpy(
                np.array(flat_ext, dtype=np.int32)).to(self.device)
            self.flat_planes = num_planes_for(self.flat_ext.shape[1] + 1)
        self._stage_plans = {}
        for si, (scale, _) in enumerate(self.stages):
            if scale is None or not has_flat:
                continue
            ranges = (self.stage_ranges[si] if si < len(self.stage_ranges)
                      and self.stage_ranges[si] else
                      ((0, pow2_ceil(scale), self.flat_ext.shape[1],
                        self.flat_planes),))
            plan = plan_from_ranges(ranges)
            self._stage_plans[si] = (plan, kc.plan_desc(plan, self.device))
        # K3's epoch and flags, made once for every stage entry (none on
        # the CPU)
        self._slots_scratch = (kc.new_slots_scratch(self.device)
                               if self._stage_plans else None)
        self._init_ba = self._ba(self.init_bucket_active)
        self._build_full_plan()
        self.resumed_from_step = None  # the last sweep's confirm (None: scratch)
        self.d2h_bytes = 0  # bytes copied home (with host_syncs)
        # in-kernel telemetry switches: the recording kernels write each
        # superstep's trajectory row; record_timing adds the clock column
        # (no-op without record_trajectory)
        self.record_trajectory = False
        self.record_timing = False
        # the gather-call count of a superstep (the trajectory's col 3):
        # a constant plus one per live weighted bucket — every conditioned
        # hub bucket; the flat region counts once in the full-table phase
        # and while it has live rows in a compaction stage
        uncond = [bi < len(self.hub_uncond) and bool(self.hub_uncond[bi])
                  for bi in range(hub)]
        cond_w = [0 if u else 1 for u in uncond]
        self._gc = {
            full: (torch.tensor(cond_w + ([0 if full else 1] if has_flat
                                          else []), dtype=torch.int32,
                                device=self.device),
                   int(any(uncond)) + int(full and has_flat))
            for full in (True, False)}

    def _build_full_plan(self) -> None:
        """The full-table phase's plan (every flat bucket at its window) and
        the hub plan (every hub bucket at its window); the pool's
        ``[P, planes]`` captures follow the windows."""
        hub = self.hub_buckets
        cbs = self.combined_buckets
        self._full_plan = None
        if hub < len(cbs):
            plan = plan_from_parts([cb.shape[0] for cb in cbs[hub:]],
                                   [cb.shape[1] for cb in cbs[hub:]],
                                   self.planes[hub:])
            off = sum(cb.numel() for cb in cbs[:hub])
            self._full_plan = (plan, kc.plan_desc(plan, self.device),
                               self.seg_flat[off:])
        self._hub_plan = self._hub_pool = None
        if hub:
            self._hub_plan = kh.hub_plan(
                self.row0[:hub], [cb.shape[0] for cb in cbs[:hub]],
                [cb.shape[1] for cb in cbs[:hub]], self.planes[:hub],
                self.hub_prune, self.hub_uncond, self.device,
                table=self.seg_flat, v=self.num_vertices)
            self._hub_pool = kh.new_pool(self._hub_plan, self.device)

    def _maybe_widen_windows(self) -> bool:
        widened = super()._maybe_widen_windows()
        if widened:
            self._build_full_plan()
        return widened

    # ---- the staged pipeline -------------------------------------------

    def _fresh(self):
        """(state, ctrl, ba) of a fresh attempt: the round-1 outcome."""
        packed0 = torch.where(self.degrees == 0, 0, 1).to(torch.int32)
        return (kc.new_state(kc.extend_packed(packed0)),
                kc.new_ctrl(step=1, prev_active=self.num_vertices + 1,
                            device=self.device),
                self._init_ba.clone())

    def _ba(self, values) -> torch.Tensor:
        # a live table has at least one column (``_empty_rec``'s max(nb, 1))
        return torch.tensor(list(values) or [0], dtype=torch.int32,
                            device=self.device)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """``t`` copied home: one host sync and its bytes."""
        self.host_syncs += 1
        self.d2h_bytes += t.numel() * t.element_size()
        return t.cpu().numpy()

    def _read_with(self, t: torch.Tensor, traj: torch.Tensor | None):
        """``t`` copied home with the trajectory buffer ``traj`` (or None)
        in the same copy: ``(t, traj)`` as numpy arrays."""
        if traj is None:
            return self._read(t), None
        self.host_syncs += 1
        self.d2h_bytes += (t.numel() + traj.numel()) * t.element_size()
        return tuple(read_home(t, traj))

    def _telemetry(self):
        """A fresh ``kernels.compact.Telemetry`` for one attempt (the
        full-table phase's gather-call weights), or None when not
        recording."""
        if not self.record_trajectory:
            return None
        nt = len(self.init_bucket_active)
        gc_w, gc_const = self._gc[True]
        return kc.Telemetry(
            traj_empty(traj_cap_for(self.max_steps), nt, unconf_b=True,
                       device=self.device),
            torch.zeros(nt, dtype=torch.int32, device=self.device),
            gc_w, gc_const, bool(self.record_timing))

    def _run(self, k: int, start=None, ring=None):
        """One k-attempt through the stage ladder from ``start`` (a
        ``(state, ctrl, ba)`` triple; fresh when None), pushing into
        ``ring`` when given, recording its trajectory when the engine
        does. Returns ``(state, c, status, tel)``, ``c`` the final control
        block as a list, ``tel`` the ``Telemetry`` or None."""
        state, ctrl, ba = self._fresh() if start is None else start
        live = kc.new_live(ba)  # the prune state is fresh in every run
        tel = self._telemetry()
        c = self._ladder(k, state, ctrl, live, ring,
                         self._read(ctrl).tolist(), tel)
        return state, c, AttemptStatus(kb.final_status(c)), tel

    def _ladder(self, k: int, state, ctrl, live, ring, c: list,
                tel=None) -> list:
        """Drive the stage ladder of one k-attempt whose control block
        reads ``c``, pushing into ``ring`` when given and recording into
        ``tel`` (a ``kernels.compact.Telemetry``) when given; returns the
        control block read at the attempt's last chunk."""
        record = ring is not None
        v = self.num_vertices
        hub = self.hub_buckets
        umax = None if tel is None else tel.umax
        for si, (scale, thresh) in enumerate(self.stages):
            if c[kc.CTRL_STATUS] != _RUNNING:
                break
            if not kc.stage_live(c, thresh, self.max_steps):
                continue  # the frontier is already below this stage's exit
            gc_w, gc_const = self._gc[scale is None]
            stage_tel = None if tel is None else tel._replace(
                gc_w=gc_w, gc_const=gc_const)
            flat = None
            if self._full_plan is not None and scale is None:
                plan, desc, seg = self._full_plan
                flat = (seg, plan, desc, None)
            elif self._full_plan is not None:
                plan, desc = self._stage_plans[si]
                idx = kc.compact_slots(ctrl, state, self.flat_row0,
                                       pow2_ceil(scale), self._slots_scratch)
                seg, gidx = kc.stage_rows(self.flat_ext, idx, plan, desc,
                                          self.flat_row0, v)
                flat = (seg, plan, desc, gidx)
            while kc.stage_live(c, thresh, self.max_steps):
                for _ in range(self.STAGE_CHUNK):
                    if flat is not None:
                        seg, plan, desc, gidx = flat
                        kc.segmented_superstep(
                            ctrl, state, seg, plan, desc, k, thresh,
                            self.max_steps, gidx=gidx, row_base=self.flat_row0,
                            umax=umax, ucol=hub)
                    if hub:
                        kh.hub_slots(ctrl, state, live, self._hub_plan,
                                     self._hub_pool, thresh, self.max_steps)
                        kh.hub_superstep(ctrl, state, self.seg_flat, live,
                                         self._hub_plan, self._hub_pool, k,
                                         thresh, self.max_steps, umax=umax)
                    kc.stage_finish(ctrl, state, ring, live, hub, thresh,
                                    self.max_steps, STALL_WINDOW, record,
                                    tel=stage_tel)
                c = self._read(ctrl).tolist()
        return c

    def _result(self, state, c, status, tel, k: int) -> AttemptResult:
        """The attempt's result: its colors row, and its trajectory in the
        same copy when it recorded one."""
        packed, traj_h = self._read_with(
            state[c[kc.CTRL_CUR], : self.num_vertices],
            None if tel is None else tel.traj)
        res = self._finish(packed, status, c[kc.CTRL_STEP], int(k))
        if traj_h is not None:
            res.trajectory = decode_trajectory(traj_h, res.supersteps,
                                               unconf_b=True)
        return res

    def attempt(self, k: int) -> AttemptResult:
        if k < 1:
            return self._finish(np.full(self.num_vertices, -1, np.int32),
                                AttemptStatus.FAILURE, 0, k)
        while True:  # window-cap retry loop (STALLED + capped windows)
            state, c, status, tel = self._run(k)
            if status == AttemptStatus.STALLED and self._maybe_widen_windows():
                continue
            break
        return self._result(state, c, status, tel, k)

    def _resume_point(self, ring, c, k: int):
        """The ring entry whose ``(best, mc]`` bracket contains ``k``, as a
        ``(state, ctrl, ba)`` start, or None on a miss (the latest matching
        slot wins, as in ``dgc_tpu.engine.compact.restore_from_ring``)."""
        ring_pe, ring_ba, ring_meta = ring
        meta = self._read(ring_meta).tolist()
        hit = None
        for j in range(kc.REC_SLOTS):
            if j < c[kc.CTRL_REC_CNT] and meta[j][1] < k <= meta[j][2]:
                hit = j
        if hit is None:
            return None
        step, _, _, stall, prev_active = meta[hit]
        self.resumed_from_step = step
        return (kc.new_state(ring_pe[hit]),
                kc.new_ctrl(step=step, prev_active=prev_active,
                            device=self.device, stall=stall),
                ring_ba[hit].clone())

    def sweep(self, k0: int) -> tuple[AttemptResult, AttemptResult | None]:
        """Fused jump-mode pair: attempt(k0), recording into the ring, then
        the confirm attempt at ``colors_used − 1``, resumed from the ring.
        Returns ``(first, second)``; ``second`` is None when attempt 1 did
        not succeed. Equal to calling ``attempt`` twice."""
        v = self.num_vertices
        self.resumed_from_step = None
        if k0 < 1:
            return self.attempt(k0), None
        while True:  # window-cap retry loop (STALLED + capped windows)
            ring = kc.new_ring(v, max(len(self.init_bucket_active), 1),
                               self.device)
            state, c, status1, tel = self._run(k0, ring=ring)
            if status1 == AttemptStatus.STALLED and self._maybe_widen_windows():
                continue
            break
        first = self._result(state, c, status1, tel, k0)
        used = first.colors_used
        k2 = used - 1
        status2, second = AttemptStatus.FAILURE, None
        if status1 == AttemptStatus.SUCCESS and k2 >= 1:
            second = self._run(k2, start=self._resume_point(ring, c, k2))
            status2 = second[2]

        def finish_second(k: int) -> AttemptResult:
            return self._result(*second, k)

        return finish_sweep_pair(first, used, status2, finish_second, v,
                                 self.attempt)

    # ---- the attempt block ---------------------------------------------

    def _fresh_block_carry(self):
        """The attempt block's card-resident carry: the best packed row
        (int32[V+2]), the prefix-resume ring (``new_ring``'s triple) and
        the ring's count and best candidate (int32[2]). The next block
        updates it in place, so it needs no donated twin."""
        v = self.num_vertices
        return (torch.zeros(v + 2, dtype=torch.int32, device=self.device),
                kc.new_ring(v, self._init_ba.shape[0], self.device),
                torch.tensor([0, -1], dtype=torch.int32, device=self.device))

    def attempt_block(self, k: int, attempts: int, *,
                      strict_decrement: bool = False, carry=None,
                      k_min: int = 1, want_best: bool = False) -> BlockOutcome:
        """Up to ``attempts`` chained k-attempts with the stopping rule on
        the card (port of ``dgc_tpu.engine.compact.CompactFrontierEngine.
        attempt_block``); drive it with ``engine.minimal_k.
        find_minimal_coloring(..., attempts_per_dispatch=A)``.

        The host drives each attempt's stage ladder as ``attempt`` does,
        recording into the carried ring; at the chunk sync where an
        attempt ends it launches K9 (its record, the best row, the next
        budget: ``k − 1`` strict, ``used − 1`` jump) and K10 (the next
        attempt's start from the ring, or fresh), and reads the control
        block and the block record in one copy. No colors row comes home
        between attempts: the final attempt's row once per block, the best
        row only at ``want_best``, at ``done`` or before a carry reset.
        Always pass the *returned* carry to the next call.

        A STALLED attempt ends the block: its budget re-runs through
        ``attempt`` (which owns the widen-and-retry loop) and the next
        block starts from a fresh carry. The attempt sequence (budgets,
        statuses, supersteps, colors used) equals the sequential driver's
        in strict and jump mode: an entry recorded at any larger budget
        whose bracket holds the budget is the state a scratch run reaches.
        """
        v = self.num_vertices
        if k < 1:
            res = self._finish(np.full(v, -1, np.int32),
                               AttemptStatus.FAILURE, 0, k)
            return BlockOutcome([res], int(k), True, None, None)
        if carry is None:
            carry = self._fresh_block_carry()
        best_pe, ring, rec = carry
        strict = bool(strict_decrement)
        a = max(1, int(attempts))
        buf, ctrl, blk = kb.new_block(k, a, rec)
        state = torch.empty((2, v + 2), dtype=torch.int32, device=self.device)
        live = torch.empty((kc.LIVE_ROWS, self._init_ba.shape[0]),
                           dtype=torch.int32, device=self.device)
        # recording: each attempt's ladder writes into tel.traj, K9 copies
        # it into the attempt's slot of the stack, K10 empties it
        tel = self._telemetry()
        traj = None if tel is None else tel.traj
        tstack = None if tel is None else torch.full(
            (a, *traj.shape), -1, dtype=torch.int32, device=self.device)

        def start_next() -> list:
            kb.block_start(ctrl, blk, state, live, ring, self.degrees,
                           self._init_ba, traj=traj)
            return self._read(buf).tolist()

        b = start_next()
        while kb.block_open(b[kc.CTRL_LEN:]):
            self._ladder(b[kc.CTRL_LEN + kb.BLK_K], state, ctrl, live, ring,
                         b[: kc.CTRL_LEN], tel)
            kb.block_record(ctrl, state, blk, best_pe, k_min, strict,
                            traj=traj, tstack=tstack)
            b = start_next()
        c, rows = b[: kc.CTRL_LEN], kb.attempt_rows(b[kc.CTRL_LEN:])
        k_next = b[kc.CTRL_LEN + kb.BLK_K]
        done = bool(b[kc.CTRL_LEN + kb.BLK_DONE])

        stalled_tail = bool(rows) and \
            rows[-1][kb.BKC_STATUS] == int(AttemptStatus.STALLED)
        results = [BlockAttemptResult(
            AttemptStatus(r[kb.BKC_STATUS]), None, r[kb.BKC_STEPS],
            r[kb.BKC_K], used=r[kb.BKC_USED])
            for r in (rows[:-1] if stalled_tail else rows)]
        stack_h = None
        if results and not stalled_tail:
            # the final attempt's colors always come home: a failing row is
            # the --compat-failed-output row, a sweep-ending success the
            # result row; intermediate successes stay scalar-only
            packed, stack_h = self._read_with(state[c[kc.CTRL_CUR], :v],
                                              tstack)
            results[-1].colors = self._decode_colors(packed)
        best_colors = None
        carry_out = (best_pe, ring, buf[kc.CTRL_REC_CNT: kc.CTRL_REC_BEST + 1])
        if stalled_tail:
            # the best row dies with the carry: bring it home first
            best_row, stack_h = self._read_with(best_pe[:v], tstack)
            best_colors = self._decode_colors(best_row)
            k_st = rows[-1][kb.BKC_K]
            res_st = self.attempt(k_st)  # owns the widen-and-retry loop
            results.append(res_st)
            if res_st.success:
                k_next = k_st - 1 if strict else res_st.colors_used - 1
                done = k_next < k_min
            else:
                k_next, done = k_st, True
            carry_out = None
        elif want_best or done:
            best_colors = self._decode_colors(self._read(best_pe[:v]))
        if stack_h is not None:
            n_dec = len(rows) - int(stalled_tail)
            for res, t in zip(results, decode_block_trajectories(
                    stack_h, [r[kb.BKC_STEPS] for r in rows], n_dec,
                    unconf_b=True)):
                res.trajectory = t
        return BlockOutcome(results, k_next, done, carry_out, best_colors)
