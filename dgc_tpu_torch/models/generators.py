"""Random-graph generators (the port's copy of
``dgc_tpu.models.generators``).

``generate_random_graph`` reproduces the reference generator's semantics
(reference ``graph.py:30-43``): visit vertices in id order, draw a target
degree ``~ U{0..max_degree}`` (inclusive), then rejection-sample partners
uniformly over all vertices, skipping self-loops, duplicates, and partners
already at the ``max_degree`` cap; edges are added symmetrically. Two fixes over
the reference: a retry bound (the reference's ``while`` can spin forever when
the candidate pool saturates — SURVEY.md §2.1 hazard (a)) and an explicit seed.

``generate_random_graph_fast`` is the vectorized path for large V (uniform edge
sampling, Poisson-like degrees, optional degree cap) — the 1M-vertex configs.
``generate_rmat_graph`` is the power-law RMAT generator.

Each takes ``native``: ``None`` (the default) picks the C++ generator of
``dgc_tpu_torch.native`` at ``node_count >= 50_000`` (same semantics,
another RNG stream), ``True`` asks for it at any size and ``False`` keeps
the NumPy path. Both are the JAX package's own, at its thresholds, so a
draw here equals ``dgc_tpu``'s at the same arguments. Where the C++
library cannot be built (no toolchain), the NumPy path runs.
"""

from __future__ import annotations

import random

import numpy as np

from dgc_tpu_torch.models.arrays import GraphArrays


def _native():
    """The C++ generator module, or None (import deferred to avoid cycles)."""
    from dgc_tpu_torch.native import bindings

    return bindings if bindings.native_available() else None


def generate_random_graph(
    node_count: int,
    max_degree: int,
    seed: int | None = None,
    max_retries_per_vertex: int | None = None,
    native: bool | None = None,
) -> GraphArrays:
    """Reference-semantics generator (bounded retries).

    ``native=None`` auto-selects the C++ implementation for large V (same
    semantics, different RNG stream); ``native=False`` forces the Python
    path (deterministic under ``random.Random(seed)``).
    """
    if native is None:
        native = node_count >= 50_000
    if native:
        nb = _native()
        if nb is not None:
            out = nb.generate_reference_native(
                node_count, max_degree, seed=seed,
                max_retries_per_vertex=max_retries_per_vertex,
            )
            if out is not None:
                return out
    rng = random.Random(seed)
    neighbors: list[set[int]] = [set() for _ in range(node_count)]
    if max_retries_per_vertex is None:
        max_retries_per_vertex = 50 * max(max_degree, 1)
    for v in range(node_count):
        target = rng.randint(0, max_degree)
        tries = 0
        while len(neighbors[v]) < target and tries < max_retries_per_vertex:
            tries += 1
            u = rng.randrange(node_count)
            if u == v or u in neighbors[v] or len(neighbors[u]) >= max_degree:
                continue
            neighbors[v].add(u)
            neighbors[u].add(v)
    lists = [sorted(ns) for ns in neighbors]
    return GraphArrays.from_neighbor_lists(lists)


def generate_random_graph_fast(
    node_count: int,
    avg_degree: float,
    seed: int | None = None,
    max_degree: int | None = None,
    native: bool | None = None,
) -> GraphArrays:
    """Vectorized uniform edge sampling for large graphs.

    Draws ``node_count * avg_degree / 2`` candidate edges uniformly, removes
    self loops and duplicates, and (optionally) drops edges at vertices that
    exceed ``max_degree`` (processed in sampled order, like the reference cap).
    ``native=None`` auto-selects the C++ implementation for large V.
    """
    if native is None:
        native = node_count >= 50_000
    if native:
        nb = _native()
        if nb is not None:
            out = nb.generate_fast_native(
                node_count, avg_degree, seed=seed, max_degree=max_degree
            )
            if out is not None:
                return out
    rng = np.random.default_rng(seed)
    m = int(node_count * avg_degree / 2)
    src = rng.integers(0, node_count, size=m, dtype=np.int64)
    dst = rng.integers(0, node_count, size=m, dtype=np.int64)
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    key = lo * node_count + hi
    _, uniq_idx = np.unique(key, return_index=True)
    uniq_idx.sort()
    edges = edges[uniq_idx]
    if max_degree is not None:
        edges = _cap_degrees(node_count, edges, max_degree)
    return GraphArrays.from_edge_list(node_count, edges)


def generate_rmat_graph(
    node_count: int,
    avg_degree: float,
    seed: int | None = None,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    max_degree: int | None = None,
    native: bool | None = None,
) -> GraphArrays:
    """R-MAT power-law generator (Chakrabarti et al.): recursive quadrant
    sampling, vectorized over all edges at once. ``node_count`` is rounded up
    to a power of two internally; vertices beyond ``node_count`` are remapped
    by modulo so the returned graph has exactly ``node_count`` vertices.
    ``native=None`` auto-selects the C++ implementation for large V.
    """
    if native is None:
        native = node_count >= 50_000
    if native:
        nb = _native()
        if nb is not None:
            out = nb.generate_rmat_native(
                node_count, avg_degree, seed=seed, a=a, b=b, c=c,
                max_degree=max_degree,
            )
            if out is not None:
                return out
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(node_count, 2)))))
    m = int(node_count * avg_degree / 2)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for _ in range(scale):
        r = rng.random(m)
        src = src * 2 + (r >= ab)
        # within the chosen row half, pick the column half
        right_given_top = b / ab
        right_given_bottom = (1 - abc) / (1 - ab) if (1 - ab) > 0 else 0.5
        r2 = rng.random(m)
        p_right = np.where(r >= ab, right_given_bottom, right_given_top)
        dst = dst * 2 + (r2 < p_right)
    src %= node_count
    dst %= node_count
    edges = np.stack([src, dst], axis=1)
    if max_degree is not None:
        edges = edges[src != dst]
        edges = _cap_degrees(node_count, edges, max_degree)
    return GraphArrays.from_edge_list(node_count, edges)


def _cap_degrees(node_count: int, edges: np.ndarray, max_degree: int) -> np.ndarray:
    """Vectorized degree cap: keep an edge iff its rank (in sampled order)
    among *all* edges touching each endpoint is below ``max_degree``.

    This is a one-pass, fully-vectorized variant of the reference's partner
    cap (``graph.py:38``). It is slightly stricter than a sequential greedy
    cap — an edge rejected at one endpoint still counts against ranks at the
    other — so degrees come out ≤ max_degree, marginally under-filled when
    overflow is common. The native C++ generator (``dgc_tpu_torch.native``)
    implements the exact sequential greedy cap for the large-graph paths.
    """
    m = len(edges)
    if m == 0:
        return edges
    # every vertex occurrence (both endpoint roles), ranked within its vertex
    # group in edge order so both roles count toward the same degree budget
    ep = np.concatenate([edges[:, 0], edges[:, 1]])
    occ = np.tile(np.arange(m, dtype=np.int64), 2)
    order = np.lexsort((occ, ep))
    sorted_ep = ep[order]
    group_start = np.concatenate([[0], np.flatnonzero(np.diff(sorted_ep)) + 1])
    starts = np.zeros(len(ep), dtype=np.int64)
    starts[group_start] = group_start
    np.maximum.accumulate(starts, out=starts)
    r = np.arange(len(ep), dtype=np.int64) - starts
    ranks = np.empty_like(r)
    ranks[order] = r
    keep = (ranks[:m] < max_degree) & (ranks[m:] < max_degree)
    return edges[keep]
