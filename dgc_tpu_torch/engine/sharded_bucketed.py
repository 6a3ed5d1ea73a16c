"""Degree-bucketed sharded engine: power-law graphs on a vertex mesh (port
of ``dgc_tpu.engine.sharded_bucketed``).

The single-device bucketing design (``engine.bucketed``) on the
all-gather path:

- **Global degree-descending relabeling** (``build_degree_buckets``) splits
  the vertices into width buckets with combined (neighbor id | beats bit)
  tables and per-bucket color windows (``bucket_planes``): memory ∝ Σ deg
  and bounded plane counts at any Δ.
- **Per-shard bucket slices** (``build_sharded_buckets``, the JAX
  package's host code verbatim): each bucket's rows are dealt in
  contiguous slices across the ranks, and a second relabeling makes each
  rank's rows (its slice of every bucket, in bucket order) the contiguous
  block ``[s·V/n, (s+1)·V/n)`` of the state, so the all-gather reassembles
  the global state in table-id order.
- **The superstep** on each rank, against the all-gathered state (buffer 0
  of ``kernels.shard.new_shard_state``), each slice gated on its live
  count as ``dgc_tpu``'s ``_gated_superstep`` gates it: the unconditioned
  slices (no compaction pad and no prune config) run as one segmented
  superstep (K5 of ``kernels.compact`` over their rows, ``_ShardSegCtx``),
  and the others are the buckets of a hub plan (K7 chooses each one's
  branch: skip an inert slice, all rows, only the ≤ pad active rows, or
  the prune ladder's captures; K8 runs it; ``kernels.hub``). K21 and K22
  (``kernels.shard``, ``engine.fused``) close the superstep and the pair.
- **Reductions**: SUM over the fail and active counts, MAX over ``mc``, the
  gather calls (the slowest shard's: every shard waits on it) and the max
  color, so the colors equal ``BucketedELLEngine``'s at every mesh size.

A capped hub-bucket window never asserts a wrong FAILURE (the fail counts
are gated per slice), and an attempt it starves ends STALLED, after which
``attempt``/``sweep`` widen the cap and retry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgc_tpu_torch.engine.bucketed import (MAX_WINDOW_PLANES, bucket_planes,
                                           build_degree_buckets)
from dgc_tpu_torch.engine.fused import ShardEngine
from dgc_tpu_torch.engine.hub import hub_prune_cfg
from dgc_tpu_torch.engine.hub import pow2_ceil as _pow2_ceil
from dgc_tpu_torch.kernels import compact as kc
from dgc_tpu_torch.kernels import hub as kh
from dgc_tpu_torch.kernels import shard as ks
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.ops.segmented_gather import plan_from_parts
from dgc_tpu_torch.ops.speculative import decode_combined, encode_combined
from dgc_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple

# the host functions below (ShardedBucketLayout, build_sharded_buckets,
# shard_prune_cfg, shard_pad_for) are dgc_tpu's, verbatim
# (tests/test_torch_import.py)


@dataclass
class ShardedBucketLayout:
    """Bucketed graph in shard-major final-id space.

    ``orig_of_final[f]`` is the original vertex id of final row f (−1 for
    bucket-padding rows); ``deg_final`` its degree (pads: 0). ``tables[b]``
    is the bucket's combined (neighbor id | beats bit) table with neighbor
    ids in final space (sentinel = ``v_final``), row-padded so every shard
    owns ``slice_sizes[b]`` rows of it.
    """

    orig_of_final: np.ndarray
    deg_final: np.ndarray
    tables: list[np.ndarray]
    slice_sizes: list[int]
    v_final: int


def build_sharded_buckets(arrays: GraphArrays, n: int,
                          min_width: int = 4) -> ShardedBucketLayout:
    """Deal each degree bucket's rows across ``n`` shards in contiguous
    slices and relabel so shard s's rows (its slice of every bucket,
    buckets in order) are the contiguous final-id range [s·V/n, (s+1)·V/n)."""
    b = build_degree_buckets(arrays, min_width=min_width)
    v = arrays.num_vertices
    vb = [cb.shape[0] for cb in b.combined]
    vb_pad = [pad_to_multiple(x, n) for x in vb]
    slices = [x // n for x in vb_pad]
    v_final = sum(vb_pad)
    vl = v_final // n
    # within-shard start offset of each bucket's slice
    lb0 = np.concatenate([[0], np.cumsum(slices[:-1])]).astype(np.int64)

    final_of_rel = np.empty(v, np.int64)
    for bi in range(len(vb)):
        r = np.arange(vb[bi], dtype=np.int64)
        shard = r // slices[bi]
        final_of_rel[b.row0[bi] + r] = shard * vl + lb0[bi] + r % slices[bi]

    deg_final = np.zeros(v_final, np.int32)
    orig_of_final = np.full(v_final, -1, np.int64)
    deg_final[final_of_rel] = b.degrees
    orig_of_final[final_of_rel] = b.perm

    # remap neighbor ids (relabeled space, sentinel v) into final space
    fmap = np.concatenate([final_of_rel, [v_final]]).astype(np.int32)
    tables = []
    for bi, cb in enumerate(b.combined):
        nbr, beats = decode_combined(cb)
        t = encode_combined(fmap[nbr], beats)
        pad_rows = vb_pad[bi] - vb[bi]
        if pad_rows:  # all-sentinel rows: degree 0, nobody references them
            t = np.concatenate(
                [t, np.full((pad_rows, cb.shape[1]), v_final, np.int32)]
            )
        # deal slices shard-major so NamedSharding(P(VERTEX_AXIS)) hands
        # shard s exactly bucket rows [s·slice, (s+1)·slice) — already true
        # for a contiguous row split, so no data movement needed here
        tables.append(t)
    return ShardedBucketLayout(
        orig_of_final=orig_of_final, deg_final=deg_final, tables=tables,
        slice_sizes=slices, v_final=v_final,
    )


def shard_prune_cfg(slice_rows: int, width: int,
                    uncond_entries: int = 1 << 17,
                    u_min: int = 128, u_div: int = 4,
                    p2_min: int = 32, p_div: int = 2,
                    p2_div: int = 8) -> tuple | None:
    """Neighbor-pruning config ``(P, U)`` / ``(P, U, P2)`` for one shard's
    bucket slice — exactly the single-device hub rule
    (``engine.compact.hub_prune_cfg``) applied to the slice, including its
    pad-to-rows clamp (a slice whose pad covers its rows still prunes: the
    rebase costs what the full branch would until the capture validates,
    then [P, U] thereafter) and the tier-2 re-capture pad ``P2`` (the slot
    list row-shrinks once the slice's live count fits it). Monotone
    confirmation is a global property, so the exactness argument holds per
    shard unchanged. ``p_div``/``p2_div`` thread the tuned capture/prune
    divisors (``dgc_tpu.tune``) through to the shared rule."""
    return hub_prune_cfg(slice_rows, width, u_min=u_min, u_div=u_div,
                         uncond_entries=uncond_entries, p2_min=p2_min,
                         p_div=p_div, p2_div=p2_div)


def shard_pad_for(slice_rows: int, width: int,
                  uncond_entries: int = 1 << 17) -> int:
    """Row-compaction pad for one shard's slice of a bucket (0 = run the
    full slice unconditioned — for small slices the cond machinery costs
    more than the gather it can skip). Pads sit at rows/2: per-bucket live
    counts in the high-degree core decay slowly (trajectory measurement,
    ``utils.trajectory``), so rows/8-style pads only engage at the very
    end of the sweep."""
    if slice_rows * width <= uncond_entries:
        return 0
    pad = _pow2_ceil(max(slice_rows // 2, 32))
    return pad if pad < slice_rows else 0


def _uncond_slices(pads: tuple, prune_cfg: tuple) -> tuple:
    """The slices that run their whole table every superstep with no
    control flow: pad 0 and no prune config."""
    return tuple(bi for bi in range(len(pads))
                 if pads[bi] == 0
                 and (bi >= len(prune_cfg) or prune_cfg[bi] is None))


class _ShardSegCtx:
    """The segmented superstep of one shard's unconditioned slices
    (``_uncond_slices``, slice shapes ``shapes``): one plan over them
    (``ops.segmented_gather``), its device view, and the global rows of
    its rows, for K5."""

    def __init__(self, shapes, planes: tuple, uncond_idx: tuple,
                 row0s: tuple, device):
        self.plan = plan_from_parts([shapes[bi][0] for bi in uncond_idx],
                                    [shapes[bi][1] for bi in uncond_idx],
                                    [planes[bi] for bi in uncond_idx])
        self.desc = kc.plan_desc(self.plan, device)
        self.gidx = torch.cat([
            torch.arange(row0s[bi], row0s[bi] + shapes[bi][0],
                         dtype=torch.int32)
            for bi in uncond_idx]).to(device)


class ShardedBucketedEngine(ShardEngine):
    """Degree-bucketed, color-windowed engine over an n-rank vertex mesh:
    per-bucket tables keep memory ∝ Σ deg and per-bucket windows keep the
    plane counts bounded at any Δ, while the colors stay those of
    ``BucketedELLEngine`` at every mesh size."""

    def __init__(self, arrays: GraphArrays, num_shards: int | None = None,
                 mesh=None, max_steps: int | None = None, min_width: int = 4,
                 max_window_planes: int = MAX_WINDOW_PLANES,
                 uncond_entries: int = 1 << 17,
                 prune_u_min: int = 128, prune_u_div: int = 4,
                 prune_p2_min: int = 32,
                 prune_p_div: int = 2, prune_p2_div: int = 8,
                 device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(num_shards,
                                                            device)
        lay = build_sharded_buckets(arrays, self.mesh.size,
                                    min_width=min_width)
        # per-shard-slice frontier gating pads (0 = unconditioned slice)
        pads = tuple(
            shard_pad_for(s, t.shape[1], uncond_entries=uncond_entries)
            for s, t in zip(lay.slice_sizes, lay.tables))
        # per-slice neighbor-pruning captures (the hub rule per shard)
        prune_cfg = tuple(
            shard_prune_cfg(s, t.shape[1], uncond_entries=uncond_entries,
                            u_min=prune_u_min, u_div=prune_u_div,
                            p2_min=prune_p2_min, p_div=prune_p_div,
                            p2_div=prune_p2_div)
            for s, t in zip(lay.slice_sizes, lay.tables))
        self._setup(lay, pads, prune_cfg, max_window_planes,
                    max_steps if max_steps is not None
                    else 2 * arrays.num_vertices + 4)

    def _setup(self, lay: ShardedBucketLayout, pads: tuple, prune_cfg: tuple,
               max_window_planes: int, max_steps: int) -> None:
        # also the build from given tables
        # (convert.sharded_bucketed_engine_from_tables)
        dev = self.mesh.device
        n, s = self.mesh.size, self.mesh.rank
        if lay.v_final != n * sum(lay.slice_sizes) or any(
                len(t) != n * sl for t, sl in zip(lay.tables, lay.slice_sizes)):
            raise ValueError(f"the layout is not dealt over {n} shards")
        self.layout = lay
        self.num_vertices = int(np.count_nonzero(lay.orig_of_final >= 0))
        self._window_cap = max_window_planes
        self.planes = bucket_planes(lay.tables, max_planes=max_window_planes)
        self.max_steps = int(max_steps)
        self.pads = tuple(int(p) for p in pads)
        self.prune_cfg = tuple(None if c is None else tuple(c)
                               for c in prune_cfg)
        blk = self.mesh.block(lay.v_final)
        self.row_off = blk.start
        # the global row of each of this shard's slices, and the slices
        sizes = [int(x) for x in lay.slice_sizes]
        lb0 = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
        self.row0s = tuple(int(blk.start + x) for x in lb0)
        tables_l = [t[s * sl: (s + 1) * sl]
                    for t, sl in zip(lay.tables, sizes)]
        self.uncond_idx = _uncond_slices(self.pads, self.prune_cfg)
        self.cond_idx = tuple(bi for bi in range(len(sizes))
                              if bi not in self.uncond_idx)
        self._slice_shapes = [t.shape for t in tables_l]
        # one device buffer of the shard's tables: the unconditioned slices
        # (K5's flat layout), then the conditioned ones (the hub table K8
        # reads at each bucket's offset)
        flat = [tables_l[bi].reshape(-1)
                for bi in self.uncond_idx + self.cond_idx]
        tables = torch.from_numpy(np.concatenate(flat) if flat else
                                  np.zeros(0, np.int32)).to(dev)
        n_un = sum(tables_l[bi].size for bi in self.uncond_idx)
        self.seg_table, self.hub_table = tables[:n_un], tables[n_un:]
        deg_l = np.asarray(lay.deg_final[blk], np.int32)
        self.deg_l = torch.from_numpy(np.ascontiguousarray(deg_l)).to(dev)
        self.state = ks.new_shard_state(lay.v_final, dev)
        self.back = self.state[1, blk]
        self.packed_l = torch.empty(blk.stop - blk.start, dtype=torch.int32,
                                    device=dev)
        self.p1 = torch.empty_like(self.packed_l)
        # the live table of the conditioned slices (their live counts and
        # prune tiers); the gather calls: one for the segmented superstep,
        # one for each conditioned slice with live rows
        self.nh = len(self.cond_idx)
        self.live = self.init_ba = None
        if self.nh:
            self.init_ba = torch.tensor(
                [int(np.count_nonzero(deg_l[lb0[bi]: lb0[bi] + sizes[bi]] > 0))
                 for bi in self.cond_idx], dtype=torch.int32, device=dev)
            self.live = kc.new_live(self.init_ba)
        self.gc_const = int(bool(self.uncond_idx))
        # the round-1 outcome: isolated vertices confirm 0, the rest take
        # color 0 fresh; the loop starts at step 1
        self.init_word, self.init_step = 1, 1
        self.init_prev = lay.v_final + 1
        # the launch plan and the windows it was built for (``_plan``)
        self._plan_of = None

    def _plan(self):
        """The launch plan of the current windows: the segmented
        superstep's context and the hub plan of the conditioned slices
        with its pool (None where there are none). Built once per window
        (``dgc_tpu``'s ``(name, window_key)``-cached ``jit(shard_map)``)."""
        if self._plan_of is None or self._plan_of[0] != self.planes:
            shapes, dev = self._slice_shapes, self.packed_l.device
            seg = None
            if self.uncond_idx:
                seg = _ShardSegCtx(shapes, self.planes, self.uncond_idx,
                                   self.row0s, dev)
            hub = pool = None
            if self.cond_idx:
                c = self.cond_idx
                hub = kh.hub_plan(
                    [self.row0s[bi] for bi in c], [shapes[bi][0] for bi in c],
                    [shapes[bi][1] for bi in c], [self.planes[bi] for bi in c],
                    [self.prune_cfg[bi] for bi in c], [False] * len(c), dev,
                    pads=[self.pads[bi] for bi in c], table=self.hub_table,
                    v=self.state.shape[1] - 2)
                pool = kh.new_pool(hub, dev)
            self._plan_of = (self.planes, (seg, hub, pool))
        return self._plan_of[1]

    def _start(self, k: int) -> torch.Tensor:
        self.packed_l.copy_(torch.where(self.deg_l == 0, 0, self.init_word))
        if self.live is not None:
            self.live.zero_()
            self.live[kc.LIVE_BA] = self.init_ba
        gc = self.gc_const
        if self.live is not None:
            gc += int((self.init_ba > 0).sum())
        return ks.new_shard_ctrl(self.init_step, self.init_prev, k, gc,
                                 self.packed_l.device)

    def _superstep(self, ctrl, k: int) -> None:
        seg, hub, pool = self._plan()
        c = ctrl[: kc.CTRL_LEN]  # the compact engine's control block
        if seg is not None:
            kc.segmented_superstep(c, self.state, self.seg_table, seg.plan,
                                   seg.desc, k, 0, self.max_steps,
                                   gidx=seg.gidx)
        if hub is not None:
            kh.hub_slots(c, self.state, self.live, hub, pool, 0,
                         self.max_steps)
            kh.hub_superstep(c, self.state, self.hub_table, self.live, hub,
                             pool, k, 0, self.max_steps)

    def _budget(self, k: int) -> int:
        return int(k)

    def _widen(self) -> bool:
        """After STALLED, double the hub-window cap if any bucket is capped
        below its width (``BucketedELLEngine._maybe_widen_windows``);
        True iff the caller should retry."""
        capped = any(32 * p < t.shape[1] + 1
                     for t, p in zip(self.layout.tables, self.planes))
        if not capped:
            return False
        self._window_cap *= 2
        self.planes = bucket_planes(self.layout.tables,
                                    max_planes=self._window_cap)
        return True

    def _colors(self, colors_final: np.ndarray) -> np.ndarray:
        real = self.layout.orig_of_final >= 0
        colors = np.empty(self.num_vertices, np.int32)
        colors[self.layout.orig_of_final[real]] = colors_final[real]
        return colors
