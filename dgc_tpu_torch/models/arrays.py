"""Array-native graph forms: CSR and padded ELL.

The port's own copy of ``dgc_tpu.models.arrays`` (host NumPy; the port
imports nothing of ``dgc_tpu``). The engines never touch Python objects;
the graph is numeric arrays
(replacing the reference's pickled object-pointer RDDs, ``graph.py:20-27``):

- **CSR**: ``indptr:int32[V+1]``, ``indices:int32[E2]`` where ``E2 = 2|E|``
  (both directions of every undirected edge, matching the reference's
  symmetric neighbor lists, ``graph.py:39-41``).
- **ELL**: ``nbrs:int32[V, W]`` padded with the sentinel ``V`` (one past the
  last vertex id), ``degrees:int32[V]``. ELL gives the fixed row width the
  superstep kernel gathers over; the sentinel row maps to a padded color slot holding −1 so
  padding never forbids a color and never wins a conflict.

``W`` (ELL width) is the max degree, optionally rounded up to a lane multiple.
For heavy-tailed (RMAT) graphs ELL explodes; ``engine.sharded`` and the
bucketed path handle those (SURVEY.md §7.3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class GraphValidationError(ValueError):
    """Malformed CSR input; ``problems`` is the structured defect list
    (each ``{"code", "message", "count"}``) from :meth:`GraphArrays.validate`."""

    def __init__(self, problems: list[dict]):
        self.problems = problems
        super().__init__(
            "; ".join(f"[{p['code']}] {p['message']}" for p in problems))


@dataclass
class GraphArrays:
    """CSR + derived stats for an undirected graph on [0, V).

    ``indices[indptr[v]:indptr[v+1]]`` are v's neighbors. Symmetric: u in
    N(v) iff v in N(u). No self loops, no duplicates (generator contract,
    reference ``graph.py:35-38``). The generators guarantee this by
    construction; externally loaded graphs should go through
    :meth:`validate` — the engines themselves assume a well-formed CSR and
    produce garbage colorings (not errors) on a malformed one.
    """

    indptr: np.ndarray   # int32[V+1]
    indices: np.ndarray  # int32[E2]

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int32)
        self.indices = np.asarray(self.indices, dtype=np.int32)

    def validate(self) -> list[dict]:
        """Structural check of the CSR invariants the engines rely on.

        Returns a list of problems (empty = valid), each a structured
        ``{"code", "message", "count"}`` record. Row-level checks are
        skipped when the indptr structure itself is broken (their indexing
        would be meaningless). Cost is a few vectorized passes over the
        edge array — gate with ``--skip-graph-validation`` for huge
        trusted inputs."""
        problems: list[dict] = []

        def bad(code: str, message: str, count: int = 1) -> None:
            problems.append({"code": code, "message": message,
                             "count": int(count)})

        v = self.num_vertices
        indptr = self.indptr.astype(np.int64)
        indices = self.indices.astype(np.int64)
        if len(self.indptr) < 1:
            bad("indptr_empty", "indptr is empty (want length V+1 >= 1)")
            return problems
        if indptr[0] != 0:
            bad("indptr_start", f"indptr[0] = {indptr[0]} (want 0)")
        steps = np.diff(indptr)
        n_dec = int((steps < 0).sum())
        if n_dec:
            first = int(np.argmax(steps < 0))
            bad("indptr_nonmonotonic",
                f"indptr decreases at {n_dec} position(s), first at row {first}",
                n_dec)
        if indptr[-1] != len(indices):
            bad("indptr_end",
                f"indptr[-1] = {indptr[-1]} != len(indices) = {len(indices)}")
        out_of_range = (indices < 0) | (indices >= v)
        n_oob = int(out_of_range.sum())
        if n_oob:
            example = int(indices[np.argmax(out_of_range)])
            bad("indices_out_of_range",
                f"{n_oob} neighbor id(s) outside [0, {v}), e.g. {example}",
                n_oob)
        if problems:
            return problems  # row/edge checks need a sound structure

        rows = np.repeat(np.arange(v, dtype=np.int64), steps)
        self_loops = rows == indices
        n_loops = int(self_loops.sum())
        if n_loops:
            example = int(rows[np.argmax(self_loops)])
            bad("self_loops",
                f"{n_loops} self loop(s), e.g. vertex {example}", n_loops)
        key = rows * v + indices
        uniq, counts = np.unique(key, return_counts=True)
        n_dup = int(len(key) - len(uniq))
        if n_dup:
            example = int(uniq[np.argmax(counts > 1)])
            bad("duplicate_edges",
                f"{n_dup} duplicate neighbor entr(ies), e.g. edge "
                f"({example // v}, {example % v})", n_dup)
        # symmetry: the directed edge multiset must equal its transpose
        rev = np.sort(indices * v + rows)
        fwd = np.sort(key)
        if len(fwd) != len(rev) or not np.array_equal(fwd, rev):
            asym = np.setdiff1d(fwd, rev, assume_unique=False)
            n_asym = int(len(asym)) or 1
            example = int(asym[0]) if len(asym) else int(fwd[0])
            bad("asymmetric_edges",
                f"{n_asym} directed edge(s) missing their reverse, e.g. "
                f"({example // v}, {example % v})", n_asym)
        return problems

    def validate_or_raise(self) -> "GraphArrays":
        problems = self.validate()
        if problems:
            raise GraphValidationError(problems)
        return self

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_directed_edges(self) -> int:
        return len(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)

    @property
    def max_degree(self) -> int:
        if self.num_vertices == 0:
            return 0
        return int(self.degrees.max())

    def to_ell(self, width: int | None = None, pad_to: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Padded ELL form: (nbrs int32[V, W] sentinel-padded with V, degrees int32[V])."""
        return csr_to_ell(self.indptr, self.indices, width=width, pad_to=pad_to)

    def to_dense(self) -> np.ndarray:
        """Dense bool[V, V] adjacency (small graphs / MXU engine only)."""
        v = self.num_vertices
        a = np.zeros((v, v), dtype=bool)
        rows = np.repeat(np.arange(v, dtype=np.int64), self.degrees)
        a[rows, self.indices] = True
        return a

    @classmethod
    def from_edge_list(cls, num_vertices: int, edges: np.ndarray) -> "GraphArrays":
        """Build symmetric CSR from an undirected edge list int[?, 2] (dedup, no self loops)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        edges = edges[edges[:, 0] != edges[:, 1]]
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * num_vertices + hi
        _, uniq = np.unique(key, return_index=True)
        lo, hi = lo[uniq], hi[uniq]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        counts = np.bincount(src, minlength=num_vertices)
        indptr = np.zeros(num_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # one sort by (row, neighbor) yields grouped + sorted neighbor lists
        order = np.argsort(src * (num_vertices + 1) + dst, kind="stable")
        indices = dst[order]
        return cls(indptr=indptr.astype(np.int32), indices=indices.astype(np.int32))

    @classmethod
    def from_neighbor_lists(cls, neighbor_lists: list[list[int]]) -> "GraphArrays":
        v = len(neighbor_lists)
        degrees = np.array([len(ns) for ns in neighbor_lists], dtype=np.int64)
        indptr = np.zeros(v + 1, dtype=np.int64)
        np.cumsum(degrees, out=indptr[1:])
        if v and indptr[-1]:
            indices = np.concatenate([np.asarray(ns, dtype=np.int32) for ns in neighbor_lists if ns])
        else:
            indices = np.zeros(0, dtype=np.int32)
        return cls(indptr=indptr.astype(np.int32), indices=indices)

    def to_neighbor_lists(self) -> list[list[int]]:
        return [
            self.indices[self.indptr[v]: self.indptr[v + 1]].tolist()
            for v in range(self.num_vertices)
        ]


def csr_to_ell(
    indptr: np.ndarray, indices: np.ndarray, width: int | None = None,
    pad_to: int = 1, sentinel: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Convert CSR to sentinel-padded ELL.

    Returns ``(nbrs int32[V, W], degrees int32[V])`` with pad slots set to
    ``sentinel`` (default: ``V``, the one-past-the-end vertex). ``W =
    max(width or max_degree, 1)`` rounded up to a multiple of ``pad_to``.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    v = len(indptr) - 1
    degrees = (indptr[1:] - indptr[:-1]).astype(np.int32)
    maxd = int(degrees.max()) if v else 0
    w = max(width if width is not None else maxd, 1)
    if w < maxd:
        raise ValueError(f"ELL width {w} < max degree {maxd}")
    w = -(-w // pad_to) * pad_to
    nbrs = np.full((v, w), v if sentinel is None else sentinel, dtype=np.int32)
    # vectorized fill: position of each index within its row
    if len(indices):
        rows = np.repeat(np.arange(v, dtype=np.int64), degrees)
        offsets = np.arange(len(indices), dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64), degrees)
        nbrs[rows, offsets] = indices
    return nbrs, degrees


def ell_to_csr(nbrs: np.ndarray, degrees: np.ndarray) -> GraphArrays:
    v = nbrs.shape[0]
    degrees = np.asarray(degrees, dtype=np.int64)
    indptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    mask = np.arange(nbrs.shape[1])[None, :] < degrees[:, None]
    indices = nbrs[mask].astype(np.int32)
    return GraphArrays(indptr=indptr.astype(np.int32), indices=indices)
