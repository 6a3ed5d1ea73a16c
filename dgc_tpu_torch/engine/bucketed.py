"""Degree-bucketed ELL engine (port of ``dgc_tpu.engine.bucketed``).

Vertices are relabeled in (degree desc, id asc) order and split into width
buckets (``_bucket_widths``); each bucket's combined table packs the
relabeled neighbor id with the precomputed priority bit at ``BEATS_BIT``.
A superstep is one launch of the superstep kernel per bucket, each with
its own color window of ``planes[b]`` bitmask planes (``bucket_planes``),
then one launch of the loop-control kernel; every bucket reads the
pre-step state buffer and writes the other one, which becomes current
only after the last bucket (BSP). The host enqueues 64 supersteps at a
time (``CHUNK_STEPS``) and syncs once per chunk, checking ``max_steps``
at chunk boundaries as the JAX engine does.

The host table builds take the C++ paths of ``dgc_tpu_torch.native``
(the degree relabel and the one-pass combined table) at the JAX package's
size thresholds, and its NumPy paths below them or where the library
cannot be built; the two give the same tables. The status rule
(``status_step``) lives with the loop control in ``kernels.superstep``,
beside the kernel that applies it on the card.

With ``record_trajectory`` on, K2's recording variant writes each
superstep's row of the attempt's trajectory buffer (``obs.kernel``: the
active count, the fail flag and the gather calls, one per bucket, as the
JAX engine records them); the buffer comes home with the colors row in
one copy, and a widened retry starts a fresh one.

Round-1 specialization (as in the JAX engine): the first superstep's
outcome is known without a gather — isolated vertices confirm color 0,
everything else speculatively takes color 0 — so the initial state *is*
that outcome and the loop starts at superstep 2 (step counter 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.base import AttemptResult, AttemptStatus
from dgc_tpu_torch.kernels.superstep import (
    CTRL_CUR,
    CTRL_STATUS,
    CTRL_STEP,
    INT32_MAX,
    new_ctrl,
    new_state,
    row_plan,
    run_supersteps,
)
from dgc_tpu_torch.models.arrays import GraphArrays, csr_to_ell
from dgc_tpu_torch.obs.kernel import (decode_trajectory, read_home,
                                      traj_cap_for, traj_empty)
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.ops.speculative import BEATS_BIT, beats_rule, encode_combined

STALL_WINDOW = 64
MAX_WINDOW_PLANES = 32  # 1024 colors per window — see bucket_planes


def _bucket_widths(max_degree: int, min_width: int = 4,
                   linear_until: int = 64) -> list[int]:
    """Width ladder: linear ``min_width`` steps up to ``linear_until``, then
    doubling (few pad slots where the vertex mass sits, O(log Δ) buckets
    on power-law graphs)."""
    widths = []
    w = min_width
    while w < max_degree and w < linear_until:
        widths.append(w)
        w += min_width
    while w < max_degree:
        widths.append(w)
        w *= 2
    widths.append(max(w, 1))
    return widths


def build_combined_rows(indptr, indices, degrees, row0: int, end: int,
                        width: int, v: int, native: bool = False) -> np.ndarray:
    """Combined (neighbor id | beats bit) ELL table for relabeled CSR rows
    [row0, end). ``native=True`` takes the C++ one-pass table build (the same
    table, without the full-table temporaries), falling back to the NumPy
    chain where the library is unavailable."""
    if native:
        from dgc_tpu_torch.native.bindings import build_combined_native

        out = build_combined_native(indptr, indices, degrees, row0,
                                    end - row0, width, v)
        if out is not None:
            return out
    sub_indptr = indptr[row0: end + 1] - indptr[row0]
    sub_indices = indices[indptr[row0]: indptr[end]]
    nb, _ = csr_to_ell(sub_indptr, sub_indices, width=width, sentinel=v)
    deg_pad = np.concatenate([degrees, np.array([-1], np.int32)])
    n_deg = deg_pad[nb]
    my_deg = degrees[row0: end, None]
    my_ids = np.arange(row0, end, dtype=np.int32)[:, None]
    beats = beats_rule(n_deg, nb, my_deg, my_ids)
    return encode_combined(nb, beats)


@dataclass
class DegreeBuckets:
    """Degree-descending relabeled graph split into width buckets.

    ``perm[new_id] = old_id``; bucket b owns relabeled rows
    ``[row0[b], row0[b] + combined[b].shape[0])``.
    """

    perm: np.ndarray                 # int64[V]: new → old
    degrees: np.ndarray              # int32[V] (relabeled, non-increasing)
    indptr: np.ndarray               # int64[V+1] relabeled CSR
    indices: np.ndarray              # int32[E2] relabeled CSR
    row0: list[int]                  # bucket start rows
    combined: list[np.ndarray]       # int32[Vb, Wb]


def build_degree_buckets(arrays: GraphArrays, min_width: int = 4,
                         native: bool | None = None) -> DegreeBuckets:
    """The relabeled graph and its bucket tables. ``native=None`` takes the
    C++ relabel and table build at 1M directed edges and more (the JAX
    package's threshold), ``True`` at any size, ``False`` never."""
    v = arrays.num_vertices
    if v >= 1 << BEATS_BIT:
        raise ValueError(f"V={v} exceeds combined-table id capacity 2^{BEATS_BIT}")
    degrees_old = arrays.degrees
    widths = _bucket_widths(arrays.max_degree, min_width=min_width)
    # stable degree-descending order → big-width buckets first
    perm = np.lexsort((np.arange(v), -degrees_old)).astype(np.int64)
    inv = np.empty(v, dtype=np.int32)
    inv[perm] = np.arange(v, dtype=np.int32)

    deg_new = degrees_old[perm].astype(np.int32)
    new_indptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(deg_new, out=new_indptr[1:])
    if native is None:
        native = len(arrays.indices) >= 1_000_000
    relabeled = None
    if native:
        from dgc_tpu_torch.native.bindings import relabel_csr_native

        relabeled = relabel_csr_native(arrays.indptr, arrays.indices, perm)
    if relabeled is not None:
        new_indices = relabeled[1]
    else:
        # relabeled CSR, entries keyed by (new_row, new_col)
        rows_old = np.repeat(np.arange(v, dtype=np.int64), degrees_old)
        new_row = inv[rows_old].astype(np.int64)
        new_col = inv[arrays.indices].astype(np.int64)
        order = np.argsort(new_row * v + new_col, kind="stable")
        new_indices = new_col[order].astype(np.int32)

    # split rows into buckets by width (descending degrees → contiguous)
    widths_desc = sorted(widths, reverse=True)
    row0s, combined_list = [], []
    row = 0
    for wi, width in enumerate(widths_desc):
        lo = 0 if wi + 1 >= len(widths_desc) else widths_desc[wi + 1]
        # deg_new is non-increasing: rows with degree > lo come first
        end = int(np.searchsorted(-deg_new, -lo, side="left"))
        if wi + 1 >= len(widths_desc):
            end = v  # last bucket takes the rest (incl. isolated)
        if end > row:
            row0s.append(row)
            combined_list.append(build_combined_rows(
                new_indptr, new_indices, deg_new, row, end, width, v,
                native=native))
        row = end
    if row != v:
        raise AssertionError(f"buckets cover {row} of {v} rows")
    return DegreeBuckets(
        perm=perm, degrees=deg_new, indptr=new_indptr, indices=new_indices,
        row0=row0s, combined=combined_list,
    )


def bucket_planes(combined_buckets, max_planes: int = MAX_WINDOW_PLANES) -> tuple:
    """Per-bucket bitmask plane counts — the color-window trick: a vertex of
    degree d always first-fits within [0, d+1), so bucket b of width W_b
    needs ``ceil((W_b+1)/32)`` planes, capped at ``max_planes`` for hub
    buckets (see ``dgc_tpu.engine.bucketed.bucket_planes``)."""
    return tuple(min(num_planes_for(cb.shape[1] + 1), max_planes)
                 for cb in combined_buckets)


def fail_valid(width: int, planes: int, k: int) -> bool:
    """Does this bucket's window assert failure exactly at budget k? A window
    that covers the bucket's degrees, or the whole budget, does; a capped
    hub window must not (``bucketed_superstep``)."""
    return 32 * planes >= width + 1 or k <= 32 * planes


class BucketedELLEngine:
    """Degree-sorted, width-bucketed speculative engine (single device)."""

    def __init__(self, arrays: GraphArrays,
                 max_window_planes: int = MAX_WINDOW_PLANES, device="cuda",
                 max_steps: int | None = None):
        b = build_degree_buckets(arrays)
        self._setup(b.perm, b.degrees, b.row0, b.combined, None,
                    max_window_planes, device, max_steps=max_steps)

    def _setup(self, perm, degrees, row0s, combined_list, planes,
               max_window_planes, device, max_steps=None):
        # also the build from given tables (convert.bucketed_engine_from_tables)
        self.device = resolve_device(device)
        v = len(perm)
        self.num_vertices = v
        self.perm = perm
        self.row0 = list(row0s)
        self.combined_buckets = tuple(
            torch.from_numpy(np.array(cb, dtype=np.int32)).to(self.device)
            for cb in combined_list)
        # K1's plans: each row's real length and its team, taken once
        self.plans = tuple(row_plan(cb, v) for cb in self.combined_buckets)
        self._window_cap = max_window_planes
        self.planes = (tuple(planes) if planes is not None else
                       bucket_planes(self.combined_buckets, max_planes=max_window_planes))
        self.degrees = torch.from_numpy(np.array(degrees, np.int32)).to(self.device)
        self.max_steps = max_steps if max_steps is not None else 2 * v + 4
        self.host_syncs = 0
        # in-kernel telemetry switch (K2's recording variant)
        self.record_trajectory = False

    def _maybe_widen_windows(self) -> bool:
        """After a STALLED attempt: if any bucket's window is capped below its
        width, double the cap and rebuild the planes. Returns True iff
        something widened — the caller retries the attempt."""
        capped = any(32 * p < cb.shape[1] + 1
                     for cb, p in zip(self.combined_buckets, self.planes))
        if not capped:
            return False
        self._window_cap *= 2
        self.planes = bucket_planes(self.combined_buckets,
                                    max_planes=self._window_cap)
        return True

    def _decode_colors(self, packed: np.ndarray) -> np.ndarray:
        colors_new = np.where(packed >= 0, packed >> 1, -1).astype(np.int32)
        colors = np.empty_like(colors_new)
        colors[self.perm] = colors_new  # back to original ids
        return colors

    def _finish(self, packed: np.ndarray, status, steps: int, k: int) -> AttemptResult:
        return AttemptResult(status, self._decode_colors(packed), steps, int(k))

    def attempt(self, k: int) -> AttemptResult:
        v = self.num_vertices
        if k < 1:
            # round-1 specialization presumes color 0 is in budget; an empty
            # budget fails outright with all vertices uncolored
            return self._finish(np.full(v, -1, np.int32),
                                AttemptStatus.FAILURE, 0, k)
        while True:  # window-cap retry loop (STALLED + capped hub buckets)
            packed0 = torch.where(self.degrees == 0, 0, 1).to(torch.int32)
            state = new_state(packed0)
            ctrl = new_ctrl(step=1, prev_active=v + 1, device=self.device)
            parts = [(r0, cb, plan, p, fail_valid(cb.shape[1], p, k))
                     for r0, cb, plan, p in zip(self.row0,
                                                self.combined_buckets,
                                                self.plans, self.planes)]
            traj = (traj_empty(traj_cap_for(self.max_steps),
                               device=self.device)
                    if self.record_trajectory else None)
            while True:  # chunked superstep loop, one host sync per chunk
                c = run_supersteps(ctrl, state, parts, k,
                                   max_steps=INT32_MAX,
                                   stall_window=STALL_WINDOW, traj=traj,
                                   gcalls=len(parts))
                self.host_syncs += 1
                status = AttemptStatus(c[CTRL_STATUS])
                steps = c[CTRL_STEP]
                if status != AttemptStatus.RUNNING or steps >= self.max_steps:
                    if status == AttemptStatus.RUNNING:
                        status = AttemptStatus.STALLED
                    break
            if status == AttemptStatus.STALLED and self._maybe_widen_windows():
                continue
            break
        row = state[c[CTRL_CUR], :v]
        if traj is None:
            packed = row.cpu().numpy()
        else:
            packed, traj_h = read_home(row, traj)
        self.host_syncs += 1
        res = self._finish(packed, status, steps, int(k))
        if traj is not None:
            res.trajectory = decode_trajectory(traj_h, steps)
        return res
