"""Pure-Python BSP replica of the reference engines' semantics — the
port's copy of ``dgc_tpu.engine.reference_sim``.

This is the behavioral contract the TPU engines are tested against — a
faithful, Spark-free reimplementation of one k-attempt
(``graph_coloring``) in both reference variants:

- ``variant='optimized'`` (reference ``coloring_optimized.py:70-146``,
  the semantics the TPU engines adopt):
  superstep = snapshot colors → per-uncolored-vertex first-fit candidate
  (*no colored neighbor → candidate 0*, ``coloring_optimized.py:159-160``) →
  group by candidate color → greedy independent set per color class in
  **degree-descending** order (``coloring_optimized.py:170-172,190``) →
  apply kept.
- ``variant='baseline'`` (``coloring.py:73-132``): candidates *defer*
  (sentinel −2) when no neighbor is colored (``coloring.py:48-49``), and the
  per-class greedy IS keeps **degree-ascending** (``coloring.py:64``). The
  baseline deadlocks on graphs with a component not containing the seed
  (SURVEY.md §2.4.1); here the unbounded stall becomes ``STALLED`` after the
  stall guard fires with no possible progress.

Both variants keep the reference's reset pass (isolated vertices → color 0,
rest → −1, ``coloring.py:12-17``), max-degree seeding (``coloring.py:19-35``;
ties broken by lowest id — Spark's reduce order is nondeterministic), and the
failure sentinel (no free color within k → attempt fails,
``coloring.py:53,104-108``). Greedy-IS insertion order ties (equal degree) are
broken by ascending id, matching a single-partition Spark run's id order.

Two implementations, bit-identical by construction and by test
(``tests/test_reference_sim_vectorized.py`` and, for this copy,
``tests/test_torch_host_engines.py``):

- ``impl='loop'`` — the per-vertex Python form, semantics-by-construction
  (each statement maps onto a cited reference line); the cross-check.
- ``impl='vectorized'`` (default) — the same superstep in NumPy array
  passes, making 100k-vertex parity ensembles routine: first-fit via sorted unique (vertex, color) pairs (no k-wide
  scratch), and the greedy IS as a fixpoint over the priority DAG —
  a vertex is kept iff none of its same-class higher-priority neighbors
  is kept, which is exactly the recurrence the sequential greedy
  computes, so the fixpoint reproduces it decision-for-decision.
"""

from __future__ import annotations

import numpy as np

from dgc_tpu_torch.engine.base import AttemptResult, AttemptStatus, SuperstepTrace
from dgc_tpu_torch.models.arrays import GraphArrays


class ReferenceSimEngine:
    def __init__(self, arrays: GraphArrays, variant: str = "optimized",
                 max_supersteps: int | None = None, impl: str = "vectorized"):
        if variant not in ("optimized", "baseline"):
            raise ValueError(f"unknown variant: {variant!r}")
        if impl not in ("loop", "vectorized"):
            raise ValueError(f"unknown impl: {impl!r}")
        self.arrays = arrays
        self.variant = variant
        self.max_supersteps = max_supersteps
        self.impl = impl
        self.trace = SuperstepTrace()

    def attempt(self, k: int) -> AttemptResult:
        if self.impl == "vectorized":
            return self._attempt_vectorized(k)
        return self._attempt_loop(k)

    def _attempt_loop(self, k: int) -> AttemptResult:
        arrays = self.arrays
        v = arrays.num_vertices
        indptr, indices = arrays.indptr, arrays.indices
        degrees = arrays.degrees
        nbrs = [indices[indptr[u]: indptr[u + 1]] for u in range(v)]

        # reset pass: isolated → 0, rest → −1 (coloring.py:12-17)
        colors = np.where(degrees == 0, 0, -1).astype(np.int32)

        # seed: max-degree uncolored vertex → color 0 (coloring.py:19-35,76)
        uncolored_ids = np.where(colors < 0)[0]
        if len(uncolored_ids):
            seed = uncolored_ids[np.argmax(degrees[uncolored_ids])]
            colors[seed] = 0

        max_steps = self.max_supersteps if self.max_supersteps is not None else 2 * v + 10
        prev_uncolored = -1
        stalled_once = False
        steps = 0
        while True:
            steps += 1
            if steps > max_steps:
                return AttemptResult(AttemptStatus.STALLED, colors, steps - 1, k)
            snapshot = colors.copy()  # broadcast_colors analog (coloring.py:135-137)
            uncolored = np.where(snapshot < 0)[0]
            self.trace.record(len(uncolored))
            if len(uncolored) == 0:
                return AttemptResult(AttemptStatus.SUCCESS, colors, steps, k)
            # stall guard (coloring.py:93-95): re-propagate + continue. For
            # the baseline variant a second consecutive stall with deferral
            # semantics means no progress is possible → STALLED.
            if len(uncolored) == prev_uncolored:
                if self.variant == "baseline" and stalled_once:
                    return AttemptResult(AttemptStatus.STALLED, colors, steps, k)
                stalled_once = True
                prev_uncolored = len(uncolored)
                continue
            prev_uncolored = len(uncolored)

            # candidate assignment (determine_color_key / assign_color)
            candidates: dict[int, list[int]] = {}
            failed = False
            for u in uncolored:
                used = {int(c) for c in snapshot[nbrs[u]] if c >= 0}
                if not used:
                    if self.variant == "baseline":
                        continue  # defer (sentinel −2, coloring.py:48-49)
                    cand = 0  # eager (coloring_optimized.py:159-160)
                else:
                    cand = next((c for c in range(k) if c not in used), None)
                    if cand is None:
                        failed = True  # sentinel −3 (coloring.py:53)
                        break
                candidates.setdefault(cand, []).append(int(u))
            if failed:
                return AttemptResult(AttemptStatus.FAILURE, colors, steps, k)

            # conflict resolution: greedy IS per candidate-color class
            descending = self.variant == "optimized"
            for cand, members in candidates.items():
                members.sort(key=lambda u: (-degrees[u], u) if descending else (degrees[u], u))
                kept: set[int] = set()
                for u in members:
                    if not any(int(w) in kept for w in nbrs[u]):
                        kept.add(u)
                        colors[u] = cand

    def _attempt_vectorized(self, k: int) -> AttemptResult:
        """Array-pass form of the superstep; decisions identical to
        ``_attempt_loop`` (tested bit-for-bit). One superstep:

        1. first-fit candidates from sorted unique (vertex, color) pairs —
           for a vertex whose distinct neighbor colors, ascending, are
           c0<c1<…, the first fit is the first position i with ci != i
           (else the count); no colored neighbor → position 0 → the
           optimized variant's eager candidate 0 falls out naturally
           (``coloring_optimized.py:159-160``), the baseline defers;
        2. greedy IS: priority rank = (degree desc, id asc) for optimized
           (``coloring_optimized.py:170-172``), (degree asc, id asc) for
           baseline (``coloring.py:64``). Blocker edges u→w (same
           candidate class, rank[w] < rank[u]) form a DAG; iterate
           "decide every vertex whose blockers are all decided; keep it
           iff none of them was kept" — the sequential greedy's own
           recurrence evaluated in topological rounds. A round cap guards
           the pathological long-chain case with a sequential finish.
        """
        arrays = self.arrays
        v = arrays.num_vertices
        indptr, indices = arrays.indptr, arrays.indices
        degrees = arrays.degrees
        baseline = self.variant == "baseline"

        # global priority rank (degrees are attempt-invariant): rank[u] <
        # rank[w]  ⇔  u is processed before w within any shared class
        if baseline:
            order = np.lexsort((np.arange(v), degrees))
        else:
            order = np.lexsort((np.arange(v), -degrees.astype(np.int64)))
        rank = np.empty(v, dtype=np.int64)
        rank[order] = np.arange(v)

        colors = np.where(degrees == 0, 0, -1).astype(np.int32)
        uncolored_ids = np.where(colors < 0)[0]
        if len(uncolored_ids):
            seed = uncolored_ids[np.argmax(degrees[uncolored_ids])]
            colors[seed] = 0

        max_steps = self.max_supersteps if self.max_supersteps is not None else 2 * v + 10
        prev_uncolored = -1
        stalled_once = False
        steps = 0
        while True:
            steps += 1
            if steps > max_steps:
                return AttemptResult(AttemptStatus.STALLED, colors, steps - 1, k)
            snapshot = colors.copy()
            uncolored = np.where(snapshot < 0)[0]
            self.trace.record(len(uncolored))
            if len(uncolored) == 0:
                return AttemptResult(AttemptStatus.SUCCESS, colors, steps, k)
            if len(uncolored) == prev_uncolored:
                if baseline and stalled_once:
                    return AttemptResult(AttemptStatus.STALLED, colors, steps, k)
                stalled_once = True
                prev_uncolored = len(uncolored)
                continue
            prev_uncolored = len(uncolored)

            # --- candidate pass -----------------------------------------
            # edge list restricted to uncolored sources with colored targets
            deg_u = (indptr[uncolored + 1] - indptr[uncolored]).astype(np.int64)
            rows = np.repeat(np.arange(len(uncolored), dtype=np.int64), deg_u)
            # gather each uncolored vertex's CSR range (concatenated)
            gather = _concat_ranges(indptr, uncolored, deg_u)
            ncol = snapshot[indices[gather]].astype(np.int64)
            colored_mask = ncol >= 0
            rows_c, cols_c = rows[colored_mask], ncol[colored_mask]
            # unique (row, color) pairs, sorted — key fits int64: color < k ≤ V
            key = np.unique(rows_c * np.int64(k + 1) + cols_c)
            r2, c2 = key // (k + 1), key % (k + 1)
            counts = np.bincount(r2, minlength=len(uncolored))
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            pos = np.arange(len(r2)) - starts[r2]
            # first mismatch position per row = the first-fit color
            bad_pos = np.where(c2 != pos, pos, np.int64(v + k + 2))
            first_fit = counts.astype(np.int64).copy()  # all-contiguous rows
            np.minimum.at(first_fit, r2, bad_pos)
            if (first_fit >= k).any():
                # some vertex has colors 0..k−1 all forbidden (sentinel −3,
                # coloring.py:53,104-108); colors unchanged, like the loop
                return AttemptResult(AttemptStatus.FAILURE, colors, steps, k)

            cand_mask = np.ones(len(uncolored), dtype=bool)
            if baseline:
                cand_mask = counts > 0  # defer: no colored neighbor (−2)
            cand_ids = uncolored[cand_mask]
            if len(cand_ids) == 0:
                continue  # nothing to decide this superstep (stall guard next)
            cand_of = np.full(v, -1, dtype=np.int64)
            cand_of[cand_ids] = first_fit[cand_mask]

            # --- greedy-IS pass over the priority DAG -------------------
            deg_c = (indptr[cand_ids + 1] - indptr[cand_ids]).astype(np.int64)
            src = np.repeat(cand_ids, deg_c)
            dst = indices[_concat_ranges(indptr, cand_ids, deg_c)]
            blocker = (cand_of[dst] == cand_of[src]) & (rank[dst] < rank[src])
            bu, bw = src[blocker], dst[blocker]
            # candidate-local indices
            local = np.full(v, -1, dtype=np.int64)
            local[cand_ids] = np.arange(len(cand_ids))
            bu_l, bw_l = local[bu], local[bw]

            m = len(cand_ids)
            nblock = np.bincount(bu_l, minlength=m)
            decided = nblock == 0
            kept = decided.copy()  # no higher-priority classmate → kept
            rounds = 0
            while not decided.all():
                rounds += 1
                if rounds > 64:
                    _sequential_finish(indptr, indices, cand_ids, cand_of,
                                       rank, decided, kept, local)
                    break
                dec_w = decided[bw_l]
                cnt_dec = np.bincount(bu_l, weights=dec_w, minlength=m)
                kept_w = kept[bw_l] & dec_w
                any_kept = np.bincount(bu_l, weights=kept_w, minlength=m) > 0
                ready = ~decided & (cnt_dec == nblock)
                kept[ready] = ~any_kept[ready]
                decided |= ready
            win = cand_ids[kept]
            colors[win] = cand_of[win].astype(np.int32)


def _concat_ranges(indptr: np.ndarray, ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices into ``indices`` for the concatenated CSR rows of ``ids``
    (lens = their degrees): vectorized equivalent of
    ``np.concatenate([np.arange(indptr[u], indptr[u+1]) for u in ids])``.

    Requires every row non-empty — duplicate ``row_starts`` positions from
    zero-length rows would silently corrupt the offsets below. Both call
    sites satisfy this (isolated vertices are pre-colored at reset, so
    uncolored/candidate vertices always have degree ≥ 1). A real raise,
    not an ``assert``: under ``python -O`` an assert vanishes and a
    zero-length row would silently corrupt gather offsets.
    """
    if not (lens > 0).all():
        raise ValueError("zero-length CSR row passed to _concat_ranges")
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    row_starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    out[row_starts] = indptr[ids].astype(np.int64)
    out[row_starts[1:]] -= indptr[ids[:-1]].astype(np.int64) + lens[:-1] - 1
    return np.cumsum(out)


def _sequential_finish(indptr, indices, cand_ids, cand_of, rank,
                       decided, kept, local) -> None:
    """Finish the IS for still-undecided candidates in rank order — the
    literal sequential greedy, entered only when the DAG fixpoint exceeds
    its round cap (adversarially long priority chains)."""
    todo = np.where(~decided)[0]
    for i in todo[np.argsort(rank[cand_ids[todo]], kind="stable")]:
        u = cand_ids[i]
        nbrs = indices[indptr[u]: indptr[u + 1]]
        li = local[nbrs]
        same = (li >= 0) & (cand_of[nbrs] == cand_of[u]) & (rank[nbrs] < rank[u])
        kept[i] = not kept[li[same]].any()
        decided[i] = True
