"""K23 (``ring_stats``) over its narrow layout on the CPU, against
``dgc_tpu``'s ring engine.

- (a) ``kernels.ring.NarrowTables`` against a NumPy brute force: the
  tables and their row lists concatenated (a flat table's rows ``0 ..
  V_l − 1``), each table row's real length (up to its last non-sentinel
  entry, sentinels inside a row included), each table's descriptor (first
  row, rows, width, offset, first warp at ``32 / team_lanes(width)`` rows a
  warp), and the teams of K23's grid (``narrow_teams``) walking every
  table row exactly once. A layout whose length cuts off a real entry
  fails the plain version.
- (b) The plain K23 over each rotation's narrow layout, K24 over its wide
  tables and K25, shard 1 of 3 of an RMAT draw whose rotation tables fill
  every narrow width (4 to 256), every rotation's block seeded with
  fresh, confirmed and uncolored words: the accumulators equal
  ``dgc_tpu.ops.speculative.neighbor_stats`` OR-folded over the rotations
  on every row that is not confirmed (a confirmed row's stay 0, as K23
  and K24 skip it), and K25's words and counters equal
  ``apply_update_mc``, at a one-plane cap and the full window.
- (d) ``RingHaloEngine`` on that draw: its sweep pair from Δ + 1 equals
  ``dgc_tpu``'s at world size 1 (one rotation: every narrow bucket in
  K23's one launch) and at 3 gloo ranks (``tests/torch_shard_ranks.py``).

Every value compared is an int32; intra-op threads are pinned to 1.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgc_tpu.engine import ring as jring  # noqa: E402
from dgc_tpu.models.generators import generate_rmat_graph  # noqa: E402
from dgc_tpu.ops import speculative as jspec  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import ring as tring  # noqa: E402
from dgc_tpu_torch.kernels import ring as kr  # noqa: E402
from dgc_tpu_torch.kernels import shard as ks  # noqa: E402
from dgc_tpu_torch.ops.bitmask import num_planes_for  # noqa: E402
from dgc_tpu_torch.ops.speculative import NBR_MASK  # noqa: E402
from torch_shard_ranks import RankGroup  # noqa: E402

NARROW = [4 * i for i in range(1, 17)] + [128, 256]  # the ladder to 256
_cache: dict = {}


def rmat():
    if "g" not in _cache:
        _cache["g"] = generate_rmat_graph(1536, avg_degree=20, seed=2,
                                          native=False)
    return _cache["g"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(3)
    yield group
    group.close()


# ---- (a) the narrow layout -------------------------------------------------

def _random_tables(rng, vl: int) -> list:
    """A flat table alone, or buckets of widths 1 to 300 over disjoint
    rows with padding rows; rows of every real length, sentinels inside."""
    if rng.random() < 0.3:
        widths, groups = [int(rng.choice([1, 32, 256]))], [None]
    else:
        widths = [int(w) for w in rng.choice([1, 3, 4, 32, 33, 64, 256, 300],
                                             size=4)]
        cuts = np.sort(rng.choice(np.arange(1, vl), 3, replace=False))
        groups = [rng.permutation(np.concatenate([g, [vl] * int(rng.integers(
            0, 3))])).astype(np.int32)
            for g in np.split(rng.permutation(vl), cuts)]
    out = []
    for rows, width in zip(groups, widths):
        n = vl if rows is None else len(rows)
        nb = rng.integers(0, vl + 1, size=(n, width))
        real = rng.integers(0, width + 1, n)
        nb[np.arange(width)[None, :] >= real[:, None]] = vl
        out.append((rows, (nb | rng.integers(0, 2, (n, width)) << 30)
                    .astype(np.int32)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_narrow_layout_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    vl = 300
    tables = _random_tables(rng, vl)
    nt = kr.NarrowTables(tables, vl, "cpu")
    np.testing.assert_array_equal(
        nt.entries.numpy(), np.concatenate([t.ravel() for _, t in tables]))
    np.testing.assert_array_equal(nt.rows.numpy(), np.concatenate(
        [np.arange(vl) if r is None else r for r, _ in tables]))
    lens = []
    for _, t in tables:
        for row in t:
            real = np.flatnonzero((row & NBR_MASK) != vl)
            lens.append(real[-1] + 1 if len(real) else 0)
    assert nt.lens.tolist() == lens
    j0 = off = warp0 = 0
    for d, (_, t) in zip(nt.desc.tolist(), tables):
        n, w = t.shape
        lanes = 1
        while lanes < 32 and 32 * lanes < w:
            lanes *= 2
        assert d == [j0, n, w, off, warp0]
        j0, off, warp0 = j0 + n, off + t.size, warp0 + -(-n * lanes // 32)
    assert nt.warps == warp0
    teams = kr.narrow_teams(nt.desc.numpy(), nt.warps)
    assert sorted(teams[teams >= 0].tolist()) == list(range(j0))
    for (rows, table, ln), (r, t) in zip(nt.buckets, tables):
        assert (rows is None) == (r is None)
        np.testing.assert_array_equal(table.numpy(), t)
        assert ln.shape[0] == t.shape[0]


def test_a_layout_that_cuts_off_an_entry_fails():
    rng = np.random.default_rng(9)
    vl = 50
    nt = kr.NarrowTables(_random_tables(rng, vl), vl, "cpu")
    nt.lens -= (nt.lens > 0).to(torch.int32)
    block = torch.full((vl + 1,), -1, dtype=torch.int32)
    packed = torch.full((vl,), -1, dtype=torch.int32)
    ctrl = ks.new_shard_ctrl(0, vl + 1, 5, -1, "cpu")
    with pytest.raises(AssertionError):
        kr.ring_stats(ctrl, block, packed, nt, kr.new_acc(2, vl, "cpu"), 2)


# ---- (b) the plain versions against dgc_tpu ---------------------------------

def _words(rng, n: int, max_color: int) -> np.ndarray:
    col = np.where(rng.random(n) < 0.8, rng.integers(0, 6, size=n),
                   rng.integers(0, max_color, size=n))
    kind = rng.integers(0, 5, size=n)
    return np.where(kind == 0, -1, col * 2 + (kind % 2)).astype(np.int32)


def test_the_draw_fills_every_narrow_width():
    _v_pad, _vl, rot = jring.build_bucketed_rotation_tables(rmat(), 1)
    widths = {c.shape[2] for _, c in rot[0]}
    assert set(NARROW) <= widths and max(widths) > kr.WIDE_WIDTH


@pytest.mark.parametrize("window", ["cap1", "full"])
def test_plain_narrow_stats_equal_jax(window):
    g = rmat()
    n, s = 3, 1
    planes = 1 if window == "cap1" else num_planes_for(g.max_degree + 1)
    k = g.max_degree + 1
    v_pad, vl, tables, beats = jring.build_rotation_tables(g, n)
    blk = slice(s * vl, (s + 1) * vl)
    rng = np.random.default_rng(13)
    words = _words(rng, v_pad, min(g.max_degree, 32 * planes + 40))
    packed = words[blk]

    def held(r):
        o = (s - r) % n
        return np.concatenate([words[o * vl: (o + 1) * vl], [-1]]
                              ).astype(np.int32)

    mycol = jnp.asarray(packed) >> 1
    fa = fo = jnp.zeros((vl, planes), jnp.uint32)
    cl = jnp.zeros((vl,), bool)
    for r in range(n):
        st = jspec.neighbor_stats(jnp.asarray(held(r))[tables[r][blk]],
                                  jnp.asarray(beats[r][blk]), mycol, planes)
        fa, fo, cl = fa | st[0], fo | st[1], cl | st[2]
    new, fail, active, mc = jspec.apply_update_mc(jnp.asarray(packed), fa,
                                                  fo, cl, k)

    rot = jring.build_bucketed_rotation_tables(g, n)[2]
    ctrl = ks.new_shard_ctrl(0, v_pad + 1, k, -1, "cpu")
    acc = kr.new_acc(planes, vl, "cpu")
    packed_t = torch.from_numpy(packed.copy())
    for r in range(n):
        block = torch.from_numpy(held(r))
        launches = [(rows[s], comb[s]) for rows, comb in rot[r]]
        narrow = [x for x in launches if x[1].shape[1] <= kr.WIDE_WIDTH]
        wide = [x for x in launches if x[1].shape[1] > kr.WIDE_WIDTH]
        kr.ring_stats(ctrl, block, packed_t,
                      kr.NarrowTables(narrow, vl, "cpu"), acc, planes)
        if wide:
            kr.ring_stats_wide(ctrl, block, packed_t,
                               kr.WideTables(wide, vl, "cpu"), acc, planes)
    conf = (packed >= 0) & (packed & 1 == 0)
    assert conf.any() and not conf.all()
    fa_np = np.where(conf[:, None], 0, np.asarray(fa).view(np.int32))
    fo_np = np.where(conf[:, None], 0, np.asarray(fo).view(np.int32))
    np.testing.assert_array_equal(acc[:planes].T.numpy(), fa_np)
    np.testing.assert_array_equal(acc[planes: 2 * planes].T.numpy(), fo_np)
    np.testing.assert_array_equal(acc[2 * planes].numpy(),
                                  np.asarray(cl) & ~conf)
    assert (acc[2 * planes + 1] != 0).sum() == ((fa_np | fo_np) != 0).any(
        axis=1).sum()
    back = torch.empty_like(packed_t)
    kr.ring_apply(ctrl, packed_t, acc, back, planes, k, True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(new))
    c = ctrl.tolist()
    assert (c[ks.CTRL_FAIL], c[ks.CTRL_ACTIVE], c[ks.CTRL_MC]) == (
        int(np.asarray(fail).sum()), int(np.asarray(active).sum()),
        int(mc))
    assert not acc.any()


# ---- (d) the engine against dgc_tpu -----------------------------------------

def row(res):
    return None if res is None else (int(res.status), res.supersteps, res.k,
                                     res.colors)


def assert_same(ours, ref):
    if ref is None:
        assert ours is None
        return
    assert ours[:3] == ref[:3]
    np.testing.assert_array_equal(ours[3], ref[3])


def jax_calls(shards):
    """``dgc_tpu``'s sweep pair from Δ + 1 (the attempt at Δ + 1 and the
    one below its count)."""
    key = ("jax", shards)
    if key not in _cache:
        g = rmat()
        eng = jring.RingHaloEngine(g, num_shards=shards)
        assert eng.bucket_tables
        _cache[key] = tuple(row(r) for r in eng.sweep(g.max_degree + 1))
    return _cache[key]


def _assert_pair(ours, ref):
    assert all(r is not None for r in ref)
    for o, r in zip(ours, ref, strict=True):
        assert_same(o, r)


def test_engine_world1_equals_jax():
    g = rmat()
    ref = jax_calls(1)
    eng = tring.RingHaloEngine(convert.graph_from_numpy(g.indptr, g.indices),
                               device="cpu")
    narrow = eng.rot[0]
    assert eng.bucket_tables and narrow is not None
    assert [d[kr.NARROW_WIDTH] for d in narrow.desc.tolist()] == NARROW
    _assert_pair(tuple(row(r) for r in eng.sweep(g.max_degree + 1)), ref)


def test_engine_three_ranks_equal_jax(ranks, tmp_path):
    g = rmat()
    ref = jax_calls(3)
    path = tmp_path / "rmat.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    per_rank = ranks.run({"kind": "engine", "backend": "sharded-ring",
                          "graph": str(path),
                          "calls": [["sweep", g.max_degree + 1]]})
    assert len(per_rank) == 3
    for ours in per_rank:
        _assert_pair(tuple(None if r is None else r[:4] for r in ours[-1]),
                     ref)
