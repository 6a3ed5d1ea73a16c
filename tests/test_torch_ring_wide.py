"""The ring engine's wide-table kernels (K24 ``ring_stats_wide`` over its
work list) and the accumulators' touched-plane masks (K23 and K24 set
them, K25 reads only the planes they name) equal ``dgc_tpu`` on the CPU.

- ``kernels.ring.wide_work_list`` against a NumPy brute force: every real
  entry (up to a row's last non-sentinel one) in exactly one chunk, no
  chunk past a row's real length or longer than the chunk size, none for
  a padding row or an empty one; on random tables and on a
  star-plus-RMAT draw's bucketed rotation tables at 1 and 3 shards.
- The plain versions of K23, K24 (over the wide tables whose work list
  cuts a hub row into many chunks) and K25, the masks included, on shard
  0 of 3 of that draw, every rotation's block seeded with fresh, confirmed and uncolored words, equal
  ``dgc_tpu.ops.speculative.neighbor_stats`` OR-folded over the rotations
  and ``apply_update_mc``, at a one-plane cap and the full window (116
  planes: four a mask bit).
- K25's plain version reads only the planes a row's mask names and
  leaves the others as they are.
- ``RingHaloEngine`` on the draw (its hub row of 3,696 entries over four
  chunks of ``WIDE_CHUNK`` at world size 1, and over two in two of the
  three rotations at 3 ranks): every attempt and the sweep pair equal
  ``dgc_tpu``'s at world size 1 and at 3 gloo ranks
  (``tests/torch_shard_ranks.py``).

The comparison is exact: every value is an int32.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgc_tpu.engine import ring as jring  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import generate_rmat_graph  # noqa: E402
from dgc_tpu.ops import speculative as jspec  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import ring as tring  # noqa: E402
from dgc_tpu_torch.kernels import ring as kr  # noqa: E402
from dgc_tpu_torch.kernels import shard as ks  # noqa: E402
from dgc_tpu_torch.ops.bitmask import num_planes_for  # noqa: E402
from dgc_tpu_torch.ops.speculative import NBR_MASK  # noqa: E402
from torch_shard_ranks import RankGroup  # noqa: E402

_cache: dict = {}
# the star's hub and its leaves, a second hub, the RMAT part's size
HUB, LEAVES, HUB2, RMAT_V, STAR_V = 7, range(512, 4200), 100, 512, 4200


def cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def star_rmat() -> JaxArrays:
    """A 512-vertex RMAT draw plus a star of 3,688 leaves on vertex 7 and
    1,301 leaves on vertex 100: the hub rows are wider than ``WIDE_WIDTH``
    in every rotation at 1 and 3 shards, and vertex 7's wider than
    ``WIDE_CHUNK`` in two of the three."""
    def build():
        base = generate_rmat_graph(RMAT_V, avg_degree=8, seed=3,
                                   native=False)
        src = np.repeat(np.arange(RMAT_V), np.diff(base.indptr))
        keep = src < base.indices
        edges = [np.stack([src[keep], base.indices[keep]], axis=1),
                 np.array([[HUB, v] for v in LEAVES]),
                 np.array([[HUB2, v] for v in range(600, 1901)])]
        return JaxArrays.from_edge_list(STAR_V, np.concatenate(edges))
    return cached("star", build)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are many small ops: one intra-op thread keeps
    them fast under the runner's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(3)
    yield group
    group.close()


# ---- the work list ----------------------------------------------------------

def _random_buckets(rng, vl: int) -> list:
    """A flat-style table (rows None) and bucket tables with padding rows,
    empty rows, sentinels inside a row (some with the beats bit) and rows
    filled to the last column."""
    out = []
    for width, flat in ((300, True), (512, False), (1500, False)):
        n_rows = vl if flat else int(rng.integers(1, 9))
        table = np.full((n_rows, width), vl, np.int32)
        for j in range(n_rows):
            length = int(rng.choice([0, 1, 5, width - 1, width,
                                     int(rng.integers(0, width + 1))]))
            table[j, :length] = rng.integers(0, vl + 1, size=length) | (
                rng.integers(0, 2, size=length) << 30)
        rows = None if flat else np.where(
            rng.random(n_rows) < 0.2, vl,
            rng.permutation(vl)[:n_rows]).astype(np.int32)
        out.append((rows, table))
    return out


def _brute_force_check(buckets, vl: int, chunk: int) -> int:
    """Every real entry covered once, nothing past a row's real length;
    returns the items' count."""
    work = kr.wide_work_list(buckets, vl, chunk).view(np.uint32).astype(
        np.int64)
    assert work.shape[1] == 4
    off = work[:, 2] | (work[:, 3] << 32)
    n = work[:, 1]
    assert ((n >= 1) & (n <= chunk)).all()
    total = sum(t.size for _, t in buckets)
    cover = np.zeros(total, np.int64)
    row_of = np.full(total, -1, np.int64)   # the local row of each slot
    last = np.full(total, -1, np.int64)     # its row's real length's end
    base = 0
    for rows, table in buckets:
        n_rows, width = table.shape
        for j in range(n_rows):
            local = j if rows is None else int(rows[j])
            real = np.flatnonzero((table[j] & NBR_MASK) != vl)
            start = base + j * width
            row_of[start: start + width] = local
            if local < vl and len(real):
                last[start: start + width] = start + real[-1] + 1
        base += table.size
    for o, c, r in zip(off, n, work[:, 0]):
        assert row_of[o] == r
        assert o + c <= last[o], "a chunk past its row's real length"
        cover[o: o + c] += 1
    base = 0
    want = np.zeros(total, np.int64)
    for rows, table in buckets:
        for j in range(table.shape[0]):
            local = j if rows is None else int(rows[j])
            if local < vl:
                real = np.flatnonzero((table[j] & NBR_MASK) != vl)
                if len(real):
                    s = base + j * table.shape[1]
                    want[s: s + real[-1] + 1] = 1
        base += table.size
    np.testing.assert_array_equal(cover, want)
    # chunks start at multiples of the chunk size within their row
    starts = {}
    base = 0
    for _, table in buckets:
        for j in range(table.shape[0]):
            starts[base + j * table.shape[1]] = table.shape[1]
        base += table.size
    row_start = np.array(sorted(starts))
    first = row_start[np.searchsorted(row_start, off, side="right") - 1]
    assert ((off - first) % chunk == 0).all()
    return len(work)


@pytest.mark.parametrize("chunk", [1, 3, 64, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_work_list_equals_brute_force(seed, chunk):
    rng = np.random.default_rng(seed)
    vl = 40
    assert _brute_force_check(_random_buckets(rng, vl), vl, chunk) > 0


@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("n", [1, 3])
def test_work_list_of_the_star_tables(n, chunk):
    g = star_rmat()
    _v_pad, vl, rot = jring.build_bucketed_rotation_tables(g, n)
    hub_items = 0
    for buckets in rot:
        for s in range(n):
            wide = [(rows[s], comb[s]) for rows, comb in buckets
                    if comb.shape[2] > kr.WIDE_WIDTH]
            assert wide, "a rotation without a wide bucket"
            _brute_force_check(wide, vl, chunk)
            if s == HUB // vl:
                work = kr.wide_work_list(wide, vl, chunk)
                hub_items += int((work[:, 0] == HUB % vl).sum())
    # the hub row's real entries, over every rotation, in chunks
    deg = int(g.degrees[HUB])
    assert hub_items >= -(-deg // chunk) and hub_items >= 3


# ---- the plain versions against dgc_tpu -----------------------------------

def _words(rng, n: int, max_color: int) -> np.ndarray:
    """Packed words: a fifth uncolored, two fifths fresh, two fifths
    confirmed; most colors below 6, the rest anywhere below
    ``max_color``."""
    col = np.where(rng.random(n) < 0.8, rng.integers(0, 6, size=n),
                   rng.integers(0, max_color, size=n))
    kind = rng.integers(0, 5, size=n)
    return np.where(kind == 0, -1, col * 2 + (kind % 2)).astype(np.int32)


def _touched_np(fa: np.ndarray, fo: np.ndarray, planes: int) -> np.ndarray:
    group = 1 << max(0, (planes - 1).bit_length() - 5)  # 32·group >= P
    bits = np.zeros(fa.shape[0], np.uint32)
    for p in range(planes):
        nz = (fa[:, p] | fo[:, p]) != 0
        bits |= np.where(nz, np.uint32(1) << np.uint32(p // group),
                         np.uint32(0))
    return bits.view(np.int32)


@pytest.mark.parametrize("budget", ["small", "full"])
@pytest.mark.parametrize("window", ["cap1", "full"])
def test_plain_kernels_and_masks_equal_jax(window, budget):
    """K23's plain version on the narrow buckets and K24's (chunks of 64)
    on the wide ones, shard 0 of 3 (both hubs), every rotation; the
    accumulators, the masks among them, against dgc_tpu's stats; then
    K25's."""
    g = star_rmat()
    n, s = 3, 0
    planes = 1 if window == "cap1" else num_planes_for(g.max_degree + 1)
    k = 4 if budget == "small" else g.max_degree + 1
    v_pad, vl, tables, beats = jring.build_rotation_tables(g, n)
    blk = slice(s * vl, (s + 1) * vl)
    rng = np.random.default_rng(5)
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
    chunks = 0
    for r in range(n):
        block = torch.from_numpy(held(r))
        narrow = [(rows[s], comb[s]) for rows, comb in rot[r]
                  if comb.shape[2] <= kr.WIDE_WIDTH]
        wide = kr.WideTables([(rows[s], comb[s]) for rows, comb in rot[r]
                              if comb.shape[2] > kr.WIDE_WIDTH], vl, "cpu",
                             chunk=64)
        chunks = max(chunks, int(torch.bincount(
            wide.work[:, 0].long()).max()))
        kr.ring_stats(ctrl, block, packed_t,
                      kr.NarrowTables(narrow, vl, "cpu"), acc, planes)
        kr.ring_stats_wide(ctrl, block, packed_t, wide, acc, planes)
    assert chunks >= 10  # a hub row over many blocks
    # a confirmed row's stats are skipped: its accumulators stay 0
    conf = (packed >= 0) & (packed & 1 == 0)
    assert conf.any() and not conf.all()
    fa_np = np.where(conf[:, None], 0, np.asarray(fa).view(np.int32))
    fo_np = np.where(conf[:, None], 0, np.asarray(fo).view(np.int32))
    np.testing.assert_array_equal(acc[:planes].T.numpy(), fa_np)
    np.testing.assert_array_equal(acc[planes: 2 * planes].T.numpy(), fo_np)
    np.testing.assert_array_equal(acc[2 * planes].numpy(),
                                  np.asarray(cl) & ~conf)
    np.testing.assert_array_equal(acc[2 * planes + 1].numpy(),
                                  _touched_np(fa_np, fo_np, planes))
    assert (acc[2 * planes + 1] != 0).any()
    back = torch.empty_like(packed_t)
    kr.ring_apply(ctrl, packed_t, acc, back, planes, k, True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(new))
    c = ctrl.tolist()
    assert (c[ks.CTRL_FAIL], c[ks.CTRL_ACTIVE], c[ks.CTRL_MC]) == (
        int(np.asarray(fail).sum()), int(np.asarray(active).sum()),
        int(mc))
    assert not acc.any()  # zero for the next superstep
    # a launch past the attempt's end does nothing
    ctrl[ks.CTRL_STATUS] = 1
    kr.ring_stats_wide(ctrl, block, packed_t, wide, acc, planes)
    assert not acc.any()


@pytest.mark.parametrize("planes", [2, 40])
def test_apply_reads_only_the_touched_planes(planes):
    """A plane whose mask bit is clear folds as zero and keeps its word;
    the touched planes, the clash flags and the masks go back to zero."""
    rng = np.random.default_rng(planes)
    vl = 200
    acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(
        2 * planes + 2, vl)).astype(np.int32))
    acc[2 * planes] = torch.from_numpy(rng.integers(0, 2, vl).astype(np.int32))
    packed = torch.from_numpy(_words(rng, vl, 32 * planes))
    group = kr.mask_group(planes)
    mask = acc[2 * planes + 1].long() & 0xFFFFFFFF
    touched = ((mask[None] >> (torch.arange(planes)[:, None] // group)) & 1
               ) == 1
    zeroed = acc.clone()
    zeroed[:planes][~touched] = 0
    zeroed[planes: 2 * planes][~touched] = 0
    for k in (1, 33, 32 * planes):
        ctrls, backs, accs = [], [], []
        for a in (acc.clone(), zeroed.clone()):
            ctrl = ks.new_shard_ctrl(0, vl + 1, k, -1, "cpu")
            back = torch.empty_like(packed)
            kr.ring_apply(ctrl, packed, a, back, planes, k, True)
            ctrls.append(ctrl), backs.append(back), accs.append(a)
        assert torch.equal(ctrls[0], ctrls[1])
        assert torch.equal(backs[0], backs[1])
        assert not accs[1].any()
        kept = acc.clone()
        kept[:planes][touched] = 0
        kept[planes: 2 * planes][touched] = 0
        kept[2 * planes:] = 0
        assert torch.equal(accs[0], kept)


# ---- the engine against dgc_tpu ---------------------------------------------

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
    g = star_rmat()

    def run():
        eng = jring.RingHaloEngine(g, num_shards=shards)
        assert eng.bucket_tables
        k0 = g.max_degree + 1
        first = eng.attempt(k0)
        ks_ = [k0, first.colors_used - 1, max(first.colors_used - 3, 1)]
        return ks_, [row(first)] + [row(eng.attempt(k)) for k in ks_[1:]] \
            + [tuple(row(r) for r in eng.sweep(k0))]
    return cached(("jax", shards), run)


def _assert_calls(ours, ref):
    for o, r in zip(ours[:-1], ref[:-1], strict=True):
        assert_same(o, r)
    for o, r in zip(ours[-1], ref[-1], strict=True):
        assert_same(o, r)


def test_star_engine_equals_jax():
    g = star_rmat()
    ks_, ref = jax_calls(None)
    eng = tring.RingHaloEngine(convert.graph_from_numpy(g.indptr, g.indices),
                               device="cpu")
    assert eng.bucket_tables and eng.wide[0] is not None
    work = eng.wide[0].work
    hub = int((work[:, 0] == HUB).sum())
    assert hub == -(-int(g.degrees[HUB]) // kr.WIDE_CHUNK) == 4
    ours = [row(eng.attempt(k)) for k in ks_] + [
        tuple(row(r) for r in eng.sweep(ks_[0]))]
    _assert_calls(ours, ref)


def test_star_three_ranks_equal_jax(ranks, tmp_path):
    g = star_rmat()
    ks_, ref = jax_calls(3)
    path = tmp_path / "star.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    # the hub row's chunks in each rotation at 3 shards
    _v_pad, vl, rot = jring.build_bucketed_rotation_tables(g, 3)
    chunks = [int((kr.wide_work_list(
        [(rows[0], comb[0]) for rows, comb in buckets
         if comb.shape[2] > kr.WIDE_WIDTH], vl)[:, 0] == HUB).sum())
        for buckets in rot]
    assert sorted(chunks) == [1, 2, 2]
    per_rank = ranks.run({"kind": "engine", "backend": "sharded-ring",
                          "graph": str(path),
                          "calls": [["attempt", k] for k in ks_]
                          + [["sweep", ks_[0]]]})
    for ours in per_rank:
        _assert_calls([r[:4] for r in ours[:-1]]
                      + [tuple(None if r is None else r[:4]
                               for r in ours[-1])], ref)
