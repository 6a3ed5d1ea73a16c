"""What K5 (``segmented_superstep``) and K8 (``hub_superstep``) take from
the host, on the CPU, against the graphs and ``dgc_tpu``'s tables:

- each hub row's real length (``kernels.hub.hub_row_lengths``, the entries
  K8 walks on the card) is its degree and agrees with a NumPy brute force,
  and past it the port's hub and flat tables hold the pad sentinel alone,
  as ``dgc_tpu``'s tables for the same graph do (the two held equal): so
  walking the real entries gives K8 the bytes of walking the padded width;
- the Python layout helpers: ``kernels.hub.k8_layout`` (a warp or a block
  an item, by width) deals every item of every branch to one team exactly
  once, and ``kernels.compact.k5_lanes``/``k5_warps`` give every row of
  every segment one lane group.

The grid tests walk the grids in Python as the kernels index them
(``csrc/hub.cu`` ``block_bucket`` and ``hub_superstep_kernel``,
``csrc/compact.cu`` ``segmented_superstep_kernel``): they pin the helpers
that size and lay out the grids, not the kernels, which only
``chip_smoke.py`` holds against their plain versions on the card. Layouts:
a uniform graph whose hub region starts at width 8 (``flat_cap=4``), an
RMAT graph at the default knobs, and a star whose hub row is 8,192 entries
wide (4,599 real).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dgc_tpu.engine import compact as jc  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import compact as tc  # noqa: E402
from dgc_tpu_torch.kernels import compact as kc  # noqa: E402
from dgc_tpu_torch.kernels import hub as kh  # noqa: E402
from dgc_tpu_torch.ops.segmented_gather import plan_from_parts  # noqa: E402

STAGES = ((None, 1024), (1024, 64), (64, 0))


def _star():
    """A hub joined to 4,599 leaves, and random edges among the leaves."""
    rng = np.random.default_rng(3)
    n = 6000
    leaves = np.arange(1, 4600)
    extra = rng.integers(1, n, size=(8000, 2))
    return JaxArrays.from_edge_list(n, np.concatenate(
        [np.stack([np.zeros_like(leaves), leaves], axis=1), extra]))


LAYOUTS = {
    "uniform": (lambda: generate_random_graph(3000, 16, seed=11,
                                              native=False),
                dict(flat_cap=4, stages=STAGES)),
    "rmat": (lambda: generate_rmat_graph(4096, avg_degree=8, seed=0,
                                         native=False),
             dict(stages=STAGES)),
    "star": (_star, dict(stages=STAGES)),
}
_engines: dict = {}


def engines(name: str):
    """(port engine on the CPU, dgc_tpu's engine) of a layout, once."""
    if name not in _engines:
        make, kw = LAYOUTS[name]
        g = make()
        _engines[name] = (
            tc.CompactFrontierEngine(
                convert.graph_from_numpy(g.indptr, g.indices), device="cpu",
                **kw),
            jc.CompactFrontierEngine(g, **kw))
    return _engines[name]


def _hub_degrees(ours) -> np.ndarray:
    deg = ours.degrees.numpy()
    return np.concatenate([
        deg[r0: r0 + cb.shape[0]]
        for r0, cb in zip(ours.row0[:ours.hub_buckets],
                          ours.combined_buckets)])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_hub_row_lengths_are_the_degrees(name):
    ours, _ = engines(name)
    plan = ours._hub_plan
    assert plan is not None and plan.lens is not None
    np.testing.assert_array_equal(plan.lens.numpy(), _hub_degrees(ours))
    # each bucket's descriptor points at its rows' lengths
    for b in plan.buckets:
        assert b.len0 == sum(c.rows for c in plan.buckets
                             if c.row0 < b.row0)
    if name == "star":  # the wide row: a block walks it
        wide = max(plan.buckets, key=lambda b: b.width)
        assert wide.width >= 4096 and wide.mode != kh.K8_WARP_ITEMS
        assert int(plan.lens[wide.len0]) == 4599


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tables_hold_the_pad_sentinel_past_each_degree(name):
    """The port's hub tables and flat table, and dgc_tpu's, are equal; in
    each, a row's first degree entries are real neighbors and the rest
    the pad sentinel V alone."""
    ours, ref = engines(name)
    v = ours.num_vertices
    deg = ours.degrees.numpy()
    np.testing.assert_array_equal(deg, np.asarray(ref.degrees))
    assert ours.hub_buckets == ref.hub_buckets > 0
    tables = [(r0, cb.numpy(), np.asarray(rcb)) for r0, cb, rcb in
              zip(ours.row0, ours.combined_buckets, ref.combined_buckets)]
    assert ours.flat_ext is not None and ref.flat_ext is not None
    flat = ours.flat_ext.numpy()
    tables.append((ours.flat_row0, flat[:-1], np.asarray(ref.flat_ext)[:-1]))
    assert (flat[-1] == v).all()
    for r0, t, rt in tables:
        np.testing.assert_array_equal(t, rt)
        d = deg[r0: r0 + t.shape[0]]
        past = np.arange(t.shape[1])[None, :] >= d[:, None]
        assert (t[past] == v).all()
        assert ((t[~past] & ((1 << 30) - 1)) < v).all()


def test_row_lengths_reach_the_last_real_entry():
    """A pad inside a row is walked; the length ends after the last real
    entry, so nothing real is ever skipped."""
    v = 50
    t = torch.full((3, 8), v, dtype=torch.int32)
    t[0, :3] = torch.tensor([4, 5, 6])
    t[1, 5] = 7 | 1 << 30  # one real entry behind pads, beats bit set
    buckets = [kh.HubBucket(0, 3, 8, 1, 0, kh.KIND_UNCOND, 0, 0, 0, *[0] * 8,
                            len0=0, block0=0, mode=kh.K8_WARP_ITEMS)]
    assert kh.hub_row_lengths(t.reshape(-1), buckets, v).tolist() == [3, 6, 0]


@pytest.mark.parametrize("widths", [(1,), (3, 8), (64, 5), (4096,),
                                    (7, 513, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_lengths_equal_a_brute_force(widths, seed):
    """Buckets of random rows laid one after another in one table (pads
    anywhere, rows of pads alone, full rows, beats bits set): each row's
    length is one past its last entry whose neighbor is not V."""
    rng = np.random.default_rng(seed)
    v = 1000
    buckets, parts, want = [], [], []
    cb = 0
    for w in widths:
        rows = int(rng.integers(1, 6))
        t = rng.integers(0, v, (rows, w)).astype(np.int64)
        t[rng.random((rows, w)) < 0.3] = v
        cut = rng.integers(0, w + 1, rows)
        t[np.arange(w)[None, :] >= cut[:, None]] = v
        t[0] = rng.integers(0, v, w)  # a full row
        t |= (rng.random((rows, w)) < 0.2).astype(np.int64) << 30
        for row in t:
            real = [j for j in range(w) if row[j] & ((1 << 30) - 1) != v]
            want.append(real[-1] + 1 if real else 0)
        buckets.append(kh.HubBucket(0, rows, w, 1, cb, kh.KIND_UNCOND, 0, 0,
                                    0, *[0] * 8, len0=0, block0=0,
                                    mode=kh.K8_WARP_ITEMS))
        parts.append(t.reshape(-1))
        cb += rows * w
    table = torch.from_numpy(np.concatenate(parts).astype(np.int32))
    got = kh.hub_row_lengths(table, buckets, v)
    assert got.dtype == torch.int32
    assert got.tolist() == want


def _bucket_of(plan, block: int) -> int:
    """The kernel's block_bucket: the last bucket starting at or before."""
    return max(bi for bi, b in enumerate(plan.buckets) if b.block0 <= block)


def _k8_items(plan) -> dict:
    """Item -> the teams (block, or block and warp) K8's grid gives it, per
    bucket, for the most items any branch has."""
    seen = {bi: {} for bi in range(len(plan.buckets))}
    for blk in range(plan.blocks):
        bi = _bucket_of(plan, blk)
        b = plan.buckets[bi]
        rel = blk - b.block0
        items = max(b.rows, b.pad, b.p2)
        if b.mode == kh.K8_WARP_ITEMS:
            got = [(rel * kh.K8_WARPS + w, (blk, w))
                   for w in range(kh.K8_WARPS)]
        else:
            got = [(rel, (blk,))]
        for item, team in got:
            if item < items:
                seen[bi].setdefault(item, []).append(team)
    return seen


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_k8_grid_gives_every_item_one_team(name):
    plan = engines(name)[0]._hub_plan
    starts = [b.block0 for b in plan.buckets] + [plan.blocks]
    for b, nxt in zip(plan.buckets, starts[1:]):
        assert b.block0 < nxt
        assert b.mode == (kh.K8_BLOCK_ITEMS if b.width >= kh.K8_BLOCK_WIDTH
                          else kh.K8_WARP_ITEMS)
    for bi, items in _k8_items(plan).items():
        b = plan.buckets[bi]
        assert sorted(items) == list(range(max(b.rows, b.pad, b.p2)))
        assert all(len(teams) == 1 for teams in items.values())


@pytest.mark.parametrize("width", [kh.K8_BLOCK_WIDTH // 2,
                                   kh.K8_BLOCK_WIDTH - 1, kh.K8_BLOCK_WIDTH,
                                   4 * kh.K8_BLOCK_WIDTH])
def test_k8_layout_deals_by_width(width):
    """Buckets of one width, with pads and P2s past their rows and a bucket
    of no rows: a warp an item below K8_BLOCK_WIDTH, a block from it; each
    bucket holds blocks for its most items and at least one."""
    rows, pads, p2s = [1, 40, 0, 17], [0, 64, 0, 3], [0, 8, 0, 30]
    lay, blocks = kh.k8_layout(rows, pads, p2s, [width] * 4)
    block = width >= kh.K8_BLOCK_WIDTH
    need = [max(r, p, q, 1) for r, p, q in zip(rows, pads, p2s)]
    each = need if block else [-(-n // kh.K8_WARPS) for n in need]
    assert [m for _, m in lay] == [kh.K8_BLOCK_ITEMS if block
                                   else kh.K8_WARP_ITEMS] * 4
    assert [b0 for b0, _ in lay] == np.concatenate(
        [[0], np.cumsum(each)[:-1]]).tolist()
    assert blocks == sum(each)


def _k5_rows(plan) -> dict:
    """(segment, row) -> the (warp, group) that take it, as K5's kernel
    deals its warps."""
    first = np.cumsum([0] + [
        -(-s.rows * kc.k5_lanes(s.width) // 32) for s in plan])
    total = int(first[-1])
    assert total == kc.k5_warps(plan)
    seen = {}
    for gw in range(total):
        s = int(np.searchsorted(first, gw, side="right") - 1)
        seg = plan[s]
        lanes = kc.k5_lanes(seg.width)
        assert 32 % lanes == 0
        for lane in range(32):
            rs = (gw - int(first[s])) * (32 // lanes) + lane // lanes
            if rs < seg.rows:
                seen.setdefault((s, rs), set()).add((gw, lane // lanes))
    return seen


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_k5_groups_take_every_row_once(name):
    ours, _ = engines(name)
    plans = [ours._full_plan[0]] + [p for p, _ in ours._stage_plans.values()]
    # and every flat width from 1 to 256 in one-width segments
    plans.append(plan_from_parts([3] * 256, list(range(1, 257)), [1] * 256))
    for plan in plans:
        seen = _k5_rows(plan)
        assert sorted(seen) == [(s, r) for s, seg in enumerate(plan)
                                for r in range(seg.rows)]
        assert all(len(g) == 1 for g in seen.values())
        for seg in plan:
            lanes = kc.k5_lanes(seg.width)
            assert lanes == 32 or lanes * kc.K5_LANE_ENTRIES >= seg.width
            assert lanes == 1 or (lanes // 2) * kc.K5_LANE_ENTRIES < seg.width
