"""Color-count reduction post-pass (top-class elimination + Kempe swaps) —
the port's copy of the Python paths of ``dgc_tpu.ops.reduce_colors``.

Each function equals its ``dgc_tpu`` original called with ``native=False``,
at the same budgets. The C++ walks (a 20x larger Kempe budget, and the
greedy resweep above 200k vertices) are still to be ported (ROADMAP).

Greedy engines occasionally finish one class above what the reference's
shuffle-ordered greedy reaches (README: rare +2 gaps on heavy-tail draws vs
``reference_sim``'s count; the contract is one-sided, count ≤ reference+1 —
BASELINE.md round-4 amendment). This pass
tries to *eliminate the top color class* of a valid coloring after the
sweep, and iterates while classes keep falling:

1. Members of one color class form an independent set (validity), so each
   member only needs a free color below the class index in its own
   neighborhood — recolor first-fit when one exists.
2. A *stubborn* member (every lower color present among its neighbors) gets
   Kempe-chain moves: pick lower colors (a, b); the connected components of
   the {a, b}-induced subgraph that contain the member's a-colored
   neighbors are swapped a↔b wholesale (validity-preserving — a component
   swap flips a proper 2-coloring). If none of those components contains a
   b-colored neighbor of the member, the member now sees no a at all and
   moves to a.

The pass is validity-preserving and can only lower the count, so it is
safe to run unconditionally after any successful sweep. It runs on the
host over CSR: the top class of a greedy coloring is small (the few
hardest vertices), Kempe chains are bounded by the two classes they touch,
and the per-vertex pair budget bounds the stubborn-vertex work.

Reference analog: none — the reference reports the last successful k
directly (reference ``coloring.py:226-231``). The pass can land the
count *below* the reference's — a strictly better coloring, which the
one-sided contract welcomes (measured ensembles in README "Correctness
model").
"""

from __future__ import annotations

import numpy as np


def _kempe_free_color(indptr: np.ndarray, indices: np.ndarray,
                      colors: np.ndarray, v: int, a: int, b: int,
                      chain_cap: int) -> tuple[bool, int]:
    """Try to free color ``a`` at vertex ``v`` by swapping the {a,b}
    components containing v's a-colored neighbors. On success the swap is
    applied to ``colors`` in place. Returns ``(moved, vertices_visited)``;
    on failure ``colors`` is untouched.
    """
    nbrs = indices[indptr[v]:indptr[v + 1]]
    ncol = colors[nbrs]
    a_nbrs = nbrs[ncol == a]
    b_nbrs = set(int(x) for x in nbrs[ncol == b])

    comp: list[int] = []
    seen: set[int] = set()
    stack = [int(x) for x in a_nbrs]
    while stack:
        u = stack.pop()
        if u in seen:
            continue
        seen.add(u)
        cu = colors[u]
        if cu == b and u in b_nbrs:
            # this component holds a b-colored neighbor of v: swapping it
            # would hand v a fresh a-colored neighbor — abort
            return False, len(seen)
        comp.append(u)
        if len(comp) > chain_cap:
            return False, len(seen)
        for w in indices[indptr[u]:indptr[u + 1]]:
            w = int(w)
            cw = colors[w]
            if (cw == a or cw == b) and w not in seen:
                stack.append(w)

    # comp is a union of COMPLETE {a,b} components (exploration never stops
    # early on the success path), so the swap stays a proper coloring
    comp_arr = np.fromiter(comp, dtype=np.int64, count=len(comp))
    cvals = colors[comp_arr]
    colors[comp_arr] = np.where(cvals == a, b, a)
    return True, len(seen)


class _WorkBudget:
    """Global bound on Kempe BFS vertex visits across the whole pass: the
    host-side Python walk must stay a rounding error next to the device
    sweep, even on adversarial 4M-vertex heavy-tail shapes (the budget
    makes the pass best-effort, never a runtime hazard)."""

    def __init__(self, limit: int):
        self.remaining = limit

    def spend(self, n: int) -> None:
        self.remaining -= n

    @property
    def exhausted(self) -> bool:
        return self.remaining <= 0


def _first_fit_members(indptr: np.ndarray, indices: np.ndarray,
                       colors: np.ndarray, members: np.ndarray,
                       c: int) -> np.ndarray:
    """Vectorized first-fit below ``c`` for every member at once.

    Returns int64[m]: the first color < c absent from each member's
    neighborhood, or −1 (stubborn). Because one color class is an
    independent set, members' recolorings cannot interact, so the
    simultaneous result equals sequential processing in any order.
    """
    deg = (indptr[members + 1] - indptr[members]).astype(np.int64)
    total = int(deg.sum())
    m = members.shape[0]
    if total == 0:
        return np.zeros(m, dtype=np.int64)
    seg = np.concatenate(([0], np.cumsum(deg)))[:-1]       # segment starts
    pos = np.arange(total, dtype=np.int64)
    src = np.repeat(indptr[members].astype(np.int64) - seg, deg) + pos
    ncol = colors[indices[src]].astype(np.int64)
    lower = (ncol >= 0) & (ncol < c)

    words = (c + 63) // 64
    first = np.full(m, -1, dtype=np.int64)
    nonempty = deg > 0
    for w in range(words):
        contrib = np.where(lower & ((ncol >> 6) == w),
                           np.uint64(1) << (ncol & 63).astype(np.uint64),
                           np.uint64(0))
        used = np.zeros(m, dtype=np.uint64)
        # reduceat over nonempty segments only; deg==0 members keep 0
        if nonempty.any():
            used[nonempty] = np.bitwise_or.reduceat(contrib, seg[nonempty])
        free = ~used
        if w == words - 1 and c % 64:
            free &= (np.uint64(1) << np.uint64(c % 64)) - np.uint64(1)
        low = free & (~free + np.uint64(1))                 # lowest set bit
        bit = np.full(m, -1, dtype=np.int64)
        nz = low > 0
        # 2^k is exact in float64 for all k<64, so log2 is exact here
        bit[nz] = np.log2(low[nz].astype(np.float64)).astype(np.int64)
        cand = np.where(bit >= 0, w * 64 + bit, -1)
        first = np.where((first < 0) & (cand >= 0) & (cand < c), cand, first)
    return first


# the same budgets as the JAX package's Python path
# _MAX_PAIR_TRIES 64 → 512 in round 5: the 50k-scale parity ensemble found
# draws where the sole stubborn top-class member is freed only by a pair
# beyond the first 64 (seed 2: 48 → 47 colors at 512 tries, measured
# ~4.4k extra visits — noise against the budgets below).
_MAX_PAIR_TRIES = 512
_CHAIN_CAP = 1 << 14
_KEMPE_MAX_CLASS = 1024


def eliminate_top_class(indptr: np.ndarray, indices: np.ndarray,
                        colors: np.ndarray, max_pair_tries: int = _MAX_PAIR_TRIES,
                        chain_cap: int = _CHAIN_CAP,
                        kempe_max_class: int = _KEMPE_MAX_CLASS,
                        budget: _WorkBudget | None = None) -> np.ndarray | None:
    """Try to empty the top color class (first-fit, then Kempe moves).

    Returns the improved coloring (count reduced by ≥1), or None if some
    member resists (or the work budget ran dry). Input is not modified.

    Kempe moves only run when the class has ≤ ``kempe_max_class`` members:
    heavy-tail top classes are tiny (the few hub vertices that actually
    need the extra color) and the chains pay off there; a big top class
    (uniform graphs) means the count is tight for thousands of vertices at
    once — chain moves churn for seconds and then fail (measured 167 s on
    a 1M-uniform coloring before this gate), so such a class fails fast on
    its first stubborn member instead.
    """
    c = int(colors.max())
    if c < 1:
        return None
    out = colors.copy()
    members = np.flatnonzero(out == c)
    kempe_ok = members.shape[0] <= kempe_max_class

    # vectorized first-fit for the whole class at once (equivalent to any
    # sequential order — class members are pairwise non-adjacent, so their
    # moves cannot interact); Kempe handles only the stubborn residue
    first = _first_fit_members(indptr, indices, out, members, c)
    stubborn = members[first < 0]
    if stubborn.shape[0] > 0 and not kempe_ok:
        return None
    out[members] = np.where(first >= 0, first, c)

    for v in stubborn:
        v = int(v)
        nbrs = indices[indptr[v]:indptr[v + 1]]
        ncol = out[nbrs]
        lower = ncol[(ncol >= 0) & (ncol < c)]
        # prior Kempe swaps may have freed a color here since the scan
        used = np.zeros(c, dtype=bool)
        used[lower] = True
        free = np.flatnonzero(~used)
        if free.shape[0] > 0:
            out[v] = free[0]  # first-fit, matching the engines' candidate rule
            continue
        if budget is not None and budget.exhausted:
            return None
        # stubborn: every lower color is present in the neighborhood.
        # Try (a, b) pairs cheapest-first — fewest a-neighbors means the
        # smallest set of components to swap and the best odds
        counts = np.bincount(lower, minlength=c)
        order = np.argsort(counts, kind="stable")
        moved = False
        tries = 0
        for a in order:
            for b in order:
                if b == a:
                    continue
                tries += 1
                if tries > max_pair_tries:
                    break
                moved, visited = _kempe_free_color(
                    indptr, indices, out, v, int(a), int(b), chain_cap)
                if budget is not None:
                    budget.spend(visited)
                if moved:
                    out[v] = a
                    break
                if budget is not None and budget.exhausted:
                    return None
            if moved or tries > max_pair_tries:
                break
        if not moved:
            return None
    return out


# visits/second of the Python BFS is ~100-200k (per-neighbor Python
# iteration); 100k + one chain_cap overshoot bounds the Kempe share of the
# pass to well under a second
_DEFAULT_WORK_LIMIT = 100_000


def _kempe_reduce(indptr: np.ndarray, indices: np.ndarray,
                  colors: np.ndarray,
                  work_limit: int | None = None) -> np.ndarray:
    """The Kempe tier: iteratively eliminate top color classes while every
    member can move. Always returns a valid coloring using ≤ the input's
    count."""
    colors = np.asarray(colors)
    budget = _WorkBudget(work_limit if work_limit is not None
                         else _DEFAULT_WORK_LIMIT)
    while True:
        nxt = eliminate_top_class(indptr, indices, colors, budget=budget)
        if nxt is None:
            return colors
        colors = nxt


# Python greedy above this V is too slow to be a post-pass
_GREEDY_PY_MAX_V = 200_000


def _greedy_seq(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray | None:
    """Sequential first-fit greedy in (degree desc, id asc) order — the
    optimized reference's conflict priority applied globally
    (``coloring_optimized.py:170-172``); None above ``_GREEDY_PY_MAX_V``."""
    v = int(indptr.shape[0]) - 1
    if v > _GREEDY_PY_MAX_V:
        return None
    degrees = np.diff(indptr)
    order = np.lexsort((np.arange(v), -degrees.astype(np.int64)))
    colors = np.full(v, -1, dtype=np.int32)
    stamp = np.full(v + 1, -1, dtype=np.int64)
    for i, u in enumerate(order):
        nc = colors[indices[indptr[u]: indptr[u + 1]]]
        stamp[nc[nc >= 0]] = i
        c = 0
        while stamp[c] == i:
            c += 1
        colors[u] = c
    return colors


def reduce_color_count(indptr: np.ndarray, indices: np.ndarray,
                       colors: np.ndarray,
                       work_limit: int | None = None,
                       greedy_resweep: bool = True) -> np.ndarray:
    """Color-count reduction: Kempe tier + greedy-resweep tier.

    Always returns a valid coloring using ≤ the input's color count (the
    input itself when nothing improves). ``work_limit`` bounds Kempe-walk
    vertex visits per tier. The greedy-resweep tier recolors from scratch
    in the reference's priority order, Kempe-reduces that, and keeps
    whichever coloring uses fewer colors (see the JAX module's docstring
    for why it exists).
    """
    out = _kempe_reduce(indptr, indices, colors, work_limit)
    if not greedy_resweep:
        return out
    base = int(out.max()) + 1
    seq = _greedy_seq(indptr, indices)
    if seq is not None and int(seq.max()) + 1 <= base:
        seq = _kempe_reduce(indptr, indices, seq, work_limit)
        if int(seq.max()) + 1 < base:
            return seq
    return out
