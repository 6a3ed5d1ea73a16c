"""Ring-halo sharded engine (port of ``dgc_tpu.engine.ring``).

The all-gather engines (``engine.sharded``, ``engine.sharded_bucketed``)
replicate the packed state on every rank each superstep: int32[V] per
device. This engine keeps the exchange streaming instead: each rank owns
the block ``[s·V/n, (s+1)·V/n)`` of the padded vertex axis, and within a
superstep the blocks travel around the ring of ranks, one rotation at a
time (``parallel.mesh.VertexMesh.rotate``: rank i sends to ``i + 1`` by
``torch.distributed`` point-to-point), each rank consuming the block it
holds through a per-rotation neighbor table. Per-rank memory is
O(V/n + tables): no rank holds an int32[V] state.

Neighbor tables are grouped by *relative owner offset*
(``build_rotation_tables``, ``dgc_tpu``'s host code verbatim): table r
holds, for each local row, the block-local ids of its neighbors owned by
shard ``(me − r) mod n`` (sentinel ``V_l``), which is the block held
after r rotations. Its beats bit rides at ``BEATS_BIT`` of each entry.
On heavy tails the flat layout (every row padded to the rotation's max
width) is replaced by degree buckets per rotation
(``build_bucketed_rotation_tables``), chosen by the flat layout's waste
ratio as ``dgc_tpu`` chooses it.

One superstep on every rank (``kernels.ring``):

1. block 0 ← the rank's words, −1 at slot ``V_l``;
2. for each rotation r: K23 (one launch over all the tables of at most
   ``kernels.ring.WIDE_WIDTH``, a team of lanes a row by its table's
   width, ``kernels.ring.NarrowTables``) and K24 (one launch over all the
   tables wider, a block a chunk of a row's real entries,
   ``kernels.ring.WideTables``) OR the neighbor stats of table r's rows
   against the held block into the accumulators and their touched-plane
   masks; then, except after the last, the held block to the next rank
   and the previous rank's into the other buffer;
3. K25: ``apply_update_mc`` from the accumulators' touched planes into
   ``back``, the counters into the control block.

The loop around it is the all-gather engines' (``engine.fused``): the
SUM/MAX reductions, K21 and the fused pair with K22, with the rank's
carry ``packed_l``, no live table and no gather-call count
(``gc_const = −1``), so the colors equal ``ELLEngine``'s at every mesh
size. Every rank enqueues the same n − 1 rotations every superstep,
including the chunked supersteps past the attempt's end (where every
kernel returns at once), so the ranks never wait on a rotation their
peer skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.engine.fused import ShardEngine
from dgc_tpu_torch.engine.sharded import ShardedELLEngine
from dgc_tpu_torch.kernels import ring as kr
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.ops.speculative import beats_rule, encode_combined
from dgc_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple

# the host functions below (build_rotation_tables, flat_rotation_entries)
# are dgc_tpu's, verbatim, and build_bucketed_rotation_tables is too, bar
# its import of this package's engine.bucketed (tests/test_torch_import.py)


def build_rotation_tables(arrays: GraphArrays, n: int):
    """Group each vertex's neighbors by relative owner offset.

    Returns ``(v_pad, vl, tables, beats)`` where ``tables[r]`` is
    int32[v_pad, W_r] of *block-local* neighbor ids owned by shard
    ``(owner(i) − r) mod n`` (sentinel = vl), and ``beats[r]`` the matching
    precomputed (degree desc, id asc) priority masks.
    """
    v = arrays.num_vertices
    v_pad = pad_to_multiple(max(v, n), n)
    vl = v_pad // n
    degrees = np.zeros(v_pad, dtype=np.int32)
    degrees[:v] = arrays.degrees

    src = np.repeat(np.arange(v, dtype=np.int64), arrays.degrees)
    dst = arrays.indices.astype(np.int64)
    rel = ((src // vl) - (dst // vl)) % n
    gloc = (dst % vl).astype(np.int32)

    # rank of each entry within its (vertex, rel) group, preserving CSR order
    key = src * n + rel
    order = np.argsort(key, kind="stable")
    sk = key[order]
    group_start = np.concatenate([[0], np.flatnonzero(np.diff(sk)) + 1]) \
        if len(sk) else np.zeros(0, np.int64)
    gs = np.zeros(len(sk), dtype=np.int64)
    gs[group_start] = group_start
    np.maximum.accumulate(gs, out=gs)
    rank_sorted = np.arange(len(sk), dtype=np.int64) - gs
    rank = np.empty_like(rank_sorted)
    rank[order] = rank_sorted

    n_beats = beats_rule(degrees[dst], dst, degrees[src], src)

    tables, beats = [], []
    for r in range(n):
        sel = rel == r
        w_r = int(rank[sel].max()) + 1 if sel.any() else 1
        t = np.full((v_pad, w_r), vl, dtype=np.int32)
        b = np.zeros((v_pad, w_r), dtype=bool)
        t[src[sel], rank[sel]] = gloc[sel]
        b[src[sel], rank[sel]] = n_beats[sel]
        tables.append(t)
        beats.append(b)
    return v_pad, vl, tables, beats


def flat_rotation_entries(arrays: GraphArrays, n: int) -> int:
    """Exact entry count of the FLAT rotation tables without building them:
    ``v_pad · Σ_r max_v(rotation-degree_r(v))``. Cheap (one O(E) pass); the
    auto-select between table layouts must use this rather than
    ``v_pad · Δ``, which is only a lower bound — n different vertices can
    each concentrate a near-Δ neighborhood into a distinct rotation,
    making Σ_r W_r approach n·Δ."""
    v = arrays.num_vertices
    v_pad = pad_to_multiple(max(v, n), n)
    vl = v_pad // n
    if arrays.num_directed_edges == 0:
        return v_pad * n
    src = np.repeat(np.arange(v, dtype=np.int64), arrays.degrees)
    dst = arrays.indices.astype(np.int64)
    rel = ((src // vl) - (dst // vl)) % n
    key, counts = np.unique(src * n + rel, return_counts=True)
    wmax = np.ones(n, np.int64)
    np.maximum.at(wmax, key % n, counts)
    return int(v_pad * wmax.sum())


def build_bucketed_rotation_tables(arrays: GraphArrays, n: int,
                                   min_width: int = 4):
    """Degree-bucketed rotation tables: memory ∝ Σ deg, any Δ.

    The flat ``build_rotation_tables`` pads every local row to the
    rotation's max width, so one hub vertex makes every rotation table
    Δ/n wide — O(V·Δ) total on power-law graphs (the doc/design gap
    VERDICT r2 flagged). Here, for each rotation r, each shard's rows
    with ≥1 neighbor toward offset r are grouped into power-of-two-ish
    width buckets (``engine.bucketed._bucket_widths`` ladder over the
    *rotation* degrees); rows with none are dropped outright (most rows,
    for most rotations, on any graph). Because a ``shard_map`` program is
    SPMD, the bucket structure must be shape-uniform across shards: each
    (rotation, bucket) row count is padded to the max over shards and the
    row lists ride as *sharded operands* (int32[n·P_rb] row ids into the
    local block, sentinel = vl) instead of static constants.

    Returns ``(v_pad, vl, rot_buckets)`` with ``rot_buckets[r]`` a list of
    ``(rows, combined)`` arrays: ``rows`` int32[n, P_rb] (shard-major),
    ``combined`` int32[n, P_rb, W_rb] block-local neighbor ids with the
    priority bit at ``BEATS_BIT`` (``engine.bucketed.encode_combined``;
    block-local ids < vl < 2^30). Priorities stay in original id space —
    colors are bit-identical to the flat ring engine by construction.
    """
    from dgc_tpu_torch.engine.bucketed import _bucket_widths, encode_combined

    v = arrays.num_vertices
    v_pad = pad_to_multiple(max(v, n), n)
    vl = v_pad // n
    degrees = np.zeros(v_pad, dtype=np.int32)
    degrees[:v] = arrays.degrees

    src = np.repeat(np.arange(v, dtype=np.int64), arrays.degrees)
    dst = arrays.indices.astype(np.int64)
    rel = ((src // vl) - (dst // vl)) % n
    gloc = (dst % vl).astype(np.int32)
    n_beats = beats_rule(degrees[dst], dst, degrees[src], src)
    comb_e = encode_combined(gloc, n_beats)

    # ONE lexsort by (rel, src) and contiguous slices per rotation — not a
    # full-edge mask + sort per rotation, which is O(n·E) and grows the
    # host build linearly with shard count at this engine's target scale
    g_order = np.argsort(rel * np.int64(v_pad) + src, kind="stable")
    rel_sorted = rel[g_order]
    seg = np.searchsorted(rel_sorted, np.arange(n + 1, dtype=np.int64))
    src_sorted, comb_sorted = src[g_order], comb_e[g_order]

    rot_buckets = []
    for r in range(n):
        sr_o = src_sorted[seg[r]: seg[r + 1]]
        er_o = comb_sorted[seg[r]: seg[r + 1]]
        # rotation-degree per vertex; bucket rows by it
        rdeg = np.bincount(sr_o, minlength=v_pad).astype(np.int64)
        starts = np.zeros(v_pad + 1, np.int64)
        np.cumsum(rdeg, out=starts[1:])
        max_rdeg = int(rdeg.max()) if len(sr_o) else 0
        widths = _bucket_widths(max(max_rdeg, 1), min_width=min_width)
        buckets = []
        e_arange = np.arange(len(sr_o), dtype=np.int64)
        e_col = e_arange - starts[sr_o]          # edge offset within its row
        slot_of_row = np.zeros(v_pad, np.int64)  # within-shard bucket slot
        for wi, w in enumerate(widths):
            lo = widths[wi - 1] if wi else 0
            in_b = (rdeg > lo) & (rdeg <= w)
            rows_w = np.flatnonzero(in_b)
            if len(rows_w) == 0:
                continue
            shard_of = rows_w // vl              # rows_w ascending → stable
            per_shard = np.bincount(shard_of, minlength=n)
            p_rb = int(per_shard.max())
            first = np.zeros(n, np.int64)
            np.cumsum(per_shard[:-1], out=first[1:])
            rank = np.arange(len(rows_w), dtype=np.int64) - first[shard_of]
            slot_of_row[rows_w] = rank
            rows = np.full((n, p_rb), vl, np.int32)
            rows[shard_of, rank] = (rows_w % vl).astype(np.int32)
            comb = np.full((n, p_rb, w), vl, np.int32)
            e_in = in_b[sr_o]
            se = sr_o[e_in]
            comb[se // vl, slot_of_row[se], e_col[e_in]] = er_o[e_in]
            buckets.append((rows, comb))
        rot_buckets.append(buckets)
    return v_pad, vl, rot_buckets


class RingHaloEngine(ShardEngine):
    """Vertex-sharded engine with the ring-halo exchange.

    The first-fit window is capped at ``max_window_planes`` (default 32
    planes, 1024 colors) and widened on STALLED, as the flat all-gather
    engine's; a capped window never asserts a wrong FAILURE. The table
    layout is chosen by ``flat_rotation_entries`` against
    ``BUCKET_WASTE_RATIO`` unless ``bucket_tables`` says which.
    """

    # flat rotation tables pad every row to the rotation's max width; on
    # heavy tails that is O(V·Δ): the bucketed layout once the flat one
    # would waste ≥8× the edges (dgc_tpu's rule)
    BUCKET_WASTE_RATIO = 8

    def __init__(self, arrays: GraphArrays, num_shards: int | None = None,
                 max_steps: int | None = None, mesh=None,
                 max_window_planes: int = 32,
                 bucket_tables: bool | None = None, device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(num_shards,
                                                            device)
        n, s = self.mesh.size, self.mesh.rank
        if bucket_tables is None:
            bucket_tables = flat_rotation_entries(arrays, n) > (
                self.BUCKET_WASTE_RATIO * max(arrays.num_directed_edges, 1))
        if bucket_tables:
            v_pad, vl, rot_buckets = build_bucketed_rotation_tables(arrays, n)
            rot = [[(rows[s], comb[s]) for rows, comb in bl]
                   for bl in rot_buckets]
        else:
            v_pad, vl, tables, beats = build_rotation_tables(arrays, n)
            blk = slice(s * vl, (s + 1) * vl)
            rot = [[(None, encode_combined(t[blk], b[blk]))]
                   for t, b in zip(tables, beats)]
        deg_p = np.zeros(v_pad, dtype=np.int32)
        deg_p[: arrays.num_vertices] = arrays.degrees
        self._setup(rot, deg_p[s * vl: (s + 1) * vl], arrays.num_vertices,
                    v_pad, int(arrays.max_degree), bool(bucket_tables),
                    max_steps, max_window_planes)

    def _setup(self, rot, deg_l, v_true: int, v_pad: int, max_degree: int,
               bucket_tables: bool, max_steps, max_window_planes: int) -> None:
        # also the build from given tables (convert.ring_engine_from_tables):
        # ``rot[r]`` this rank's launches of rotation r, (rows or None,
        # combined table) each
        dev = self.mesh.device
        vl = len(deg_l)
        self.bucket_tables = bucket_tables
        self.num_vertices = int(v_true)
        self.max_degree = max_degree
        self.num_planes = min(num_planes_for(max_degree + 1),
                              max_window_planes)
        self.max_steps = max_steps if max_steps is not None else 2 * v_pad + 4

        def t(x):
            return torch.from_numpy(np.array(x, np.int32, order="C")).to(dev)

        # a rotation's tables of at most WIDE_WIDTH as K23's one launch,
        # and those wider as K24's (None where there is none)
        self.rot = tuple(
            kr.NarrowTables(narrow, vl, dev) if narrow else None
            for narrow in ([(rows, table) for rows, table in launches
                            if table.shape[1] <= kr.WIDE_WIDTH]
                           for launches in rot))
        self.wide = tuple(
            kr.WideTables(wide, vl, dev) if wide else None
            for wide in ([(rows, table) for rows, table in launches
                          if table.shape[1] > kr.WIDE_WIDTH]
                         for launches in rot))
        self.deg_l = t(deg_l)
        self.packed_l = torch.empty(vl, dtype=torch.int32, device=dev)
        self.back = torch.empty_like(self.packed_l)
        self.p1 = torch.empty_like(self.packed_l)
        self.blocks = kr.new_blocks(vl, dev)
        self.acc = kr.new_acc(self.num_planes, vl, dev)
        # no live table, no gather-call count (the flat sharded engine's)
        self.live, self.nh, self.init_ba, self.gc_const = None, 0, None, -1
        # the reset pass: isolated vertices confirm 0, the rest uncolored
        self.init_word, self.init_step, self.init_prev = -1, 0, v_pad + 1

    def _exchange(self) -> None:
        """Nothing before the rule kernels: the rotations run inside
        ``_superstep``."""

    def _start(self, k: int) -> torch.Tensor:
        if self.acc.shape[0] != 2 * self.num_planes + 2:  # a widened window
            self.acc = kr.new_acc(self.num_planes, self.packed_l.shape[0],
                                  self.packed_l.device)
        return ShardedELLEngine._start(self, k)

    def _superstep(self, ctrl, k: int) -> None:
        window = 32 * self.num_planes
        fail_valid = window >= self.max_degree + 1 or k <= window
        vl = self.packed_l.shape[0]
        cur = 0
        self.blocks[0, :vl].copy_(self.packed_l)
        for r, (narrow, wide) in enumerate(zip(self.rot, self.wide)):
            block = self.blocks[cur]
            if narrow is not None:
                kr.ring_stats(ctrl, block, self.packed_l, narrow, self.acc,
                              self.num_planes)
            if wide is not None:
                kr.ring_stats_wide(ctrl, block, self.packed_l, wide,
                                   self.acc, self.num_planes)
            if r + 1 < len(self.rot):
                self.mesh.rotate(self.blocks[1 - cur, :vl], block[:vl])
                cur = 1 - cur
        kr.ring_apply(ctrl, self.packed_l, self.acc, self.back,
                      self.num_planes, k, fail_valid)

    # the flat all-gather engine's budget clamp, window retry and colors
    _budget = ShardedELLEngine._budget
    _widen = ShardedELLEngine._widen
    _colors = ShardedELLEngine._colors
