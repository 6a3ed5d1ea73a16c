"""The port's ring-halo engine (``--backend sharded-ring``) equals
``dgc_tpu``'s on the CPU.

- The host tables (flat rotation tables and beats masks, the bucketed
  ones, ``flat_rotation_entries``) equal ``dgc_tpu``'s at 1, 2, 3 and 8
  shards on a uniform and an RMAT draw.
- The plain versions of K23 (K24's too) and K25 on one shard of 4, every
  rotation's block seeded with fresh, confirmed and uncolored words, equal
  ``dgc_tpu.ops.speculative.neighbor_stats`` OR-folded over the rotations
  and ``apply_update_mc``, at a one-plane cap and at the full window,
  through the flat and the bucketed tables.
- At world size 1, in this process (a one-rank gloo group): every
  attempt's status, supersteps, budget and colors, and ``sweep``'s pair,
  equal ``dgc_tpu``'s ``RingHaloEngine`` on the 8 host devices, each
  layout forced and chosen, the port's engine built from the graph and
  from the JAX engine's tables (``convert``); with telemetry on, the
  trajectories too; the window retry on K40 under a 1-plane cap; the
  empty budgets; ``--shards`` above the world size.
- At 3 gloo ranks (``tests/torch_shard_ranks.py``: one group for this
  module, one thread a rank): the same calls against ``dgc_tpu`` at 3
  shards, the trajectories, the CLI's JSON and attempt lines against
  ``dgc_tpu.cli --backend sharded-ring``, and no tensor on any rank with
  the padded vertex count's rows. Three ranks, not two: at two the rank a
  block goes to and the rank it comes from are the same, so a ring that
  turned the wrong way would pass.

The comparison is exact: every value is an int32.
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgc_tpu import cli as jcli  # noqa: E402
from dgc_tpu.engine import ring as jring  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu.ops import speculative as jspec  # noqa: E402
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import ring as tring  # noqa: E402
from dgc_tpu_torch.kernels import ring as kr  # noqa: E402
from dgc_tpu_torch.kernels import shard as ks  # noqa: E402
from dgc_tpu_torch.ops.bitmask import num_planes_for  # noqa: E402
from dgc_tpu_torch.ops.speculative import encode_combined  # noqa: E402
from dgc_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from torch_shard_ranks import RankGroup  # noqa: E402

GRAPHS = {
    # 301 rows: the padded V differs at 1, 2, 3 and 8 shards
    "uniform": lambda: generate_random_graph(301, 10, seed=2, native=False),
    # Δ 83: the flat layout would waste 13-18× the edges, so the bucketed
    # one is chosen at every shard count
    "rmat": lambda: generate_rmat_graph(256, avg_degree=8, seed=1,
                                        native=False),
    "isolated": lambda: JaxArrays.from_neighbor_lists(
        [[], [2, 3], [1], [1], [], [6], [5], []]),
}
# the layout each test graph's engine runs: forced either way, or chosen
LAYOUTS = {"flat": False, "bucketed": True, "auto": None}
_cache: dict = {}


def cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def graph(name: str) -> JaxArrays:
    return cached(("graph", name), GRAPHS[name])


def jax_engine(name: str, shards=None, bucket_tables=None, **kw):
    """The JAX engine, one a configuration; ``auto`` shares the forced
    engine of the layout it picks (the same tables, the same kernels)."""
    g = graph(name)
    n = shards or 8
    if bucket_tables is None:
        bucket_tables = jring.flat_rotation_entries(g, n) > (
            jring.RingHaloEngine.BUCKET_WASTE_RATIO
            * max(g.num_directed_edges, 1))
    return cached(("jax", name, shards, bucket_tables,
                   tuple(sorted(kw.items()))),
                  lambda: jring.RingHaloEngine(g, num_shards=shards,
                                               bucket_tables=bucket_tables,
                                               **kw))


def port_arrays(g):
    return convert.graph_from_numpy(g.indptr, g.indices)


def row(res):
    return None if res is None else (int(res.status), res.supersteps, res.k,
                                     res.colors)


def assert_same(ours, ref):
    if ref is None:
        assert ours is None
        return
    assert ours[:3] == ref[:3]
    np.testing.assert_array_equal(ours[3], ref[3])


def calls_for(name: str) -> list:
    """Every budget the tests run: Δ+1, the next budgets of the minimal-k
    loop, a failing one, the empty budgets and one past every window."""
    k0 = graph(name).max_degree + 1
    used = cached(("used", name),
                  lambda: jax_engine(name).attempt(k0)).colors_used
    return [k0, used - 1, max(used - 3, 1), 0, -1, 32 * 4 + 77]


def reference(eng, ks: list) -> list:
    return cached(("ref", id(eng), tuple(ks)), lambda: [
        row(eng.attempt(k)) for k in ks] + [
        tuple(row(r) for r in eng.sweep(ks[0]))])


def assert_calls(ours, ref):
    for o, r in zip(ours[:-1], ref[:-1], strict=True):
        assert_same(o, r)
    for o, r in zip(ours[-1], ref[-1], strict=True):
        assert_same(o, r)


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


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["uniform", "rmat"])
def test_host_tables_equal_jax(name, n):
    g = graph(name)
    arrays = port_arrays(g)
    assert tring.flat_rotation_entries(arrays, n) == \
        jring.flat_rotation_entries(g, n)
    ours, theirs = (tring.build_rotation_tables(arrays, n),
                    jring.build_rotation_tables(g, n))
    assert ours[:2] == theirs[:2]
    for a, b in zip(ours[2] + ours[3], theirs[2] + theirs[3], strict=True):
        np.testing.assert_array_equal(a, b)
    ours, theirs = (tring.build_bucketed_rotation_tables(arrays, n),
                    jring.build_bucketed_rotation_tables(g, n))
    assert ours[:2] == theirs[:2]
    assert [len(b) for b in ours[2]] == [len(b) for b in theirs[2]]
    for bo, bt in zip(ours[2], theirs[2]):
        for (ro, co), (rt, ct) in zip(bo, bt):
            np.testing.assert_array_equal(ro, rt)
            np.testing.assert_array_equal(co, ct)


def _words(rng, n: int, max_color: int) -> np.ndarray:
    """Packed words: a fifth uncolored, two fifths fresh, two fifths
    confirmed; most colors below 6 (crowded first-fit, failures at small
    budgets), the rest anywhere below ``max_color``."""
    col = np.where(rng.random(n) < 0.8, rng.integers(0, 6, size=n),
                   rng.integers(0, max_color, size=n))
    kind = rng.integers(0, 5, size=n)
    return np.where(kind == 0, -1, col * 2 + (kind % 2)).astype(np.int32)


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
@pytest.mark.parametrize("budget", ["small", "full"])
@pytest.mark.parametrize("window", ["cap1", "full"])
def test_plain_kernels_equal_jax(window, budget, layout):
    """K23's and K25's plain versions on shard 1 of 4 of the RMAT graph
    (colors past the window and in every plane), every rotation's block
    another shard's seeded words, at a budget of 4 and of Δ+1."""
    g = graph("rmat")
    n, s = 4, 1
    planes = 1 if window == "cap1" else num_planes_for(g.max_degree + 1)
    k = 4 if budget == "small" else g.max_degree + 1
    v_pad, vl, tables, beats = jring.build_rotation_tables(g, n)
    blk = slice(s * vl, (s + 1) * vl)
    rng = np.random.default_rng(11)
    words = _words(rng, v_pad, g.max_degree + 8)
    packed = words[blk]

    def held(r):  # the block held after r rotations, −1 at slot vl
        o = (s - r) % n
        return np.concatenate([words[o * vl: (o + 1) * vl], [-1]]
                              ).astype(np.int32)

    # dgc_tpu: neighbor_stats OR-folded over the rotations, apply_update_mc
    mycol = jnp.asarray(packed) >> 1
    fa = fo = jnp.zeros((vl, planes), jnp.uint32)
    cl = jnp.zeros((vl,), bool)
    for r in range(n):
        st = jspec.neighbor_stats(jnp.asarray(held(r))[tables[r][blk]],
                                  jnp.asarray(beats[r][blk]), mycol, planes)
        fa, fo, cl = fa | st[0], fo | st[1], cl | st[2]
    new, fail, active, mc = jspec.apply_update_mc(jnp.asarray(packed), fa,
                                                  fo, cl, k)

    # the port: K23's plain version per rotation (per bucket), then K25's
    if layout == "flat":
        rot = [[(None, encode_combined(tables[r][blk], beats[r][blk]))]
               for r in range(n)]
    else:
        rot = [[(rows[s], comb[s]) for rows, comb in bl] for bl in
               jring.build_bucketed_rotation_tables(g, n)[2]]
    ctrl = ks.new_shard_ctrl(0, v_pad + 1, k, -1, "cpu")
    acc = kr.new_acc(planes, vl, "cpu")
    packed_t = torch.from_numpy(packed.copy())
    for r in range(n):
        block = torch.from_numpy(held(r))
        kr.ring_stats(ctrl, block, packed_t, kr.NarrowTables(rot[r], vl, "cpu"),
                      acc, planes)
    # a confirmed row's stats are skipped: its accumulators stay 0
    conf = (packed >= 0) & (packed & 1 == 0)
    assert conf.any() and not conf.all()
    np.testing.assert_array_equal(
        acc[:planes].T.numpy(),
        np.where(conf[:, None], 0, np.asarray(fa).view(np.int32)))
    np.testing.assert_array_equal(
        acc[planes: 2 * planes].T.numpy(),
        np.where(conf[:, None], 0, np.asarray(fo).view(np.int32)))
    np.testing.assert_array_equal(acc[2 * planes].numpy(),
                                  np.asarray(cl) & ~conf)
    back = torch.empty_like(packed_t)
    kr.ring_apply(ctrl, packed_t, acc, back, planes, k, True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(new))
    c = ctrl.tolist()
    assert (c[ks.CTRL_FAIL], c[ks.CTRL_ACTIVE], c[ks.CTRL_MC]) == (
        int(np.asarray(fail).sum()), int(np.asarray(active).sum()),
        int(mc))
    # the seeded words make the small budget fail and push mc past it
    assert (c[ks.CTRL_FAIL] > 0) == (budget == "small") and c[ks.CTRL_MC] > 4
    assert not acc.any()  # zero for the next superstep
    # a launch past the attempt's end does nothing
    ctrl[ks.CTRL_STATUS] = 1
    before = (ctrl.clone(), back.clone())
    kr.ring_stats(ctrl, block, packed_t, kr.NarrowTables(rot[0], vl, "cpu"),
                  acc, planes)
    kr.ring_apply(ctrl, packed_t, acc, back, planes, k, True)
    assert not acc.any()
    assert torch.equal(ctrl, before[0]) and torch.equal(back, before[1])


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["uniform", "rmat"])
def test_attempts_and_sweep_equal_jax(name, layout, build):
    g = graph(name)
    ks_ = calls_for(name)
    bt = LAYOUTS[layout]
    if build == "port":
        eng = tring.RingHaloEngine(port_arrays(g), bucket_tables=bt,
                                   device="cpu")
    else:
        # the tables depend on the shard count: a one-shard JAX engine's
        # (its runs are not needed: the colors do not depend on it)
        j = jax_engine(name, shards=1, bucket_tables=bt)
        eng = convert.ring_engine_from_tables(
            np.asarray(j.deg_l), j.v_true, j.max_steps,
            tables=[np.asarray(t) for t in j.tables] or None,
            beats=[np.asarray(b) for b in j.beats] or None,
            rot_buckets=[[(np.asarray(r), np.asarray(c)) for r, c in bl]
                         for bl in j.rot_buckets] if j.bucket_tables
            else None, max_window_planes=j.num_planes, device="cpu")
        assert eng.bucket_tables == j.bucket_tables
    want = bt if bt is not None else name == "rmat"
    assert eng.bucket_tables == want
    ours = [row(eng.attempt(k)) for k in ks_] + [
        tuple(row(r) for r in eng.sweep(ks_[0]))]
    assert_calls(ours, reference(jax_engine(name, bucket_tables=bt), ks_))


def test_isolated_vertices_equal_jax():
    g = graph("isolated")
    ks_ = calls_for("isolated")
    eng = tring.RingHaloEngine(port_arrays(g), device="cpu")
    ours = [row(eng.attempt(k)) for k in ks_] + [
        tuple(row(r) for r in eng.sweep(ks_[0]))]
    assert_calls(ours, reference(jax_engine("isolated"), ks_))


def _traj_cols(t) -> tuple:
    return (t.first_step, t.truncated) + tuple(
        getattr(t, c) for c in ("active", "fail", "mc", "gather_calls",
                                "max_unconf"))


def _assert_traj(ours: tuple, theirs: tuple):
    assert ours[:2] == theirs[:2]
    for a, b in zip(ours[2:], theirs[2:], strict=True):
        np.testing.assert_array_equal(a, b)


def jax_trajectories(name: str) -> list:
    def run():
        ref = jax_engine(name)
        ref.record_trajectory = True
        k0 = graph(name).max_degree + 1
        out = [ref.attempt(k0), *ref.sweep(k0)]
        ref.record_trajectory = False
        return [_traj_cols(r.trajectory) for r in out]
    return cached(("traj", name), run)


def test_trajectories_equal_jax():
    g = graph("uniform")
    k0 = g.max_degree + 1
    eng = tring.RingHaloEngine(port_arrays(g), device="cpu")
    eng.record_trajectory = True
    ours = [eng.attempt(k0), *eng.sweep(k0)]
    for o, t in zip(ours, jax_trajectories("uniform"), strict=True):
        assert o.trajectory.bucket_active is None
        _assert_traj(_traj_cols(o.trajectory), t)


def test_one_rank_ring_sends_nothing():
    """At world size 1 a ring has one rotation and sends no block."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.staged) == (1, False)
    dst = torch.full((5,), -7, dtype=torch.int32)
    mesh.rotate(dst, torch.arange(5, dtype=torch.int32))
    assert (dst == -7).all()


def _complete(v: int) -> JaxArrays:
    return JaxArrays.from_edge_list(
        v, np.array([[i, j] for i in range(v) for j in range(i + 1, v)]))


def test_capped_window_widens_on_clique(ranks, tmp_path):
    # K40 under a 1-plane (32-color) window: no wrong FAILURE, STALLED,
    # widened, 40 colors; 39 fails. One rank and three.
    g = cached(("graph", "k40"), lambda: _complete(40))
    ref = jring.RingHaloEngine(g, max_window_planes=1)
    want = [row(ref.attempt(40)), row(ref.attempt(39))]
    pair = tuple(row(r) for r in ref.sweep(40))
    assert want[0][0] == 1 and len(set(want[0][3].tolist())) == 40
    eng = tring.RingHaloEngine(port_arrays(g), max_window_planes=1,
                               device="cpu")
    assert eng.num_planes == 1
    got = [row(eng.attempt(40)), row(eng.attempt(39))]
    assert eng.num_planes == ref.num_planes > 1
    path = tmp_path / "k40.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    three = ranks.run({"kind": "engine", "backend": "sharded-ring",
                       "graph": str(path), "kw": {"max_window_planes": 1},
                       "calls": [["attempt", 40], ["attempt", 39],
                                 ["sweep", 40]]})
    for ours in [got] + [t[:2] for t in three]:
        for o, r in zip(ours, want, strict=True):
            assert_same(o, r)
    for t in three:
        for o, r in zip(t[2], pair, strict=True):
            assert_same(o, r)


@pytest.mark.parametrize("name", ["uniform", "rmat"])
def test_three_ranks_equal_jax(ranks, tmp_path, name):
    """The calls at 3 gloo ranks against ``dgc_tpu`` at 3 shards (the
    uniform graph with telemetry on: its trajectories against the 8-device
    run's); on every rank no engine tensor has the padded vertex count's
    rows, which the all-gather engine's state has."""
    g = graph(name)
    ks_ = calls_for(name)
    path = tmp_path / "g.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    calls = [["attempt", k] for k in ks_] + [["sweep", ks_[0]]]
    ref = reference(jax_engine(name, shards=3), ks_)
    traj = name == "uniform"
    per_rank = ranks.run({"kind": "engine", "backend": "sharded-ring",
                          "graph": str(path), "calls": calls,
                          "trajectory": traj, "tensor_rows": True})
    v_pad = jring.build_rotation_tables(g, 3)[0]
    for ours in per_rank:
        assert ours[-1] < v_pad
        calls_out = ours[:-1]
        assert_calls([r[:4] for r in calls_out[:-1]]
                     + [tuple(None if r is None else r[:4]
                              for r in calls_out[-1])], ref)
        if traj:
            want = jax_trajectories("uniform")
            _assert_traj(calls_out[0][4], want[0])
            for r, t in zip(calls_out[-1], want[1:], strict=True):
                _assert_traj(r[4], t)
    # the all-gather engine holds the whole padded state on each rank
    gathered = ranks.run({"kind": "engine", "backend": "sharded",
                          "graph": str(path), "calls": [],
                          "tensor_rows": True})
    assert all(r[-1] >= v_pad for r in gathered)


def _attempt_lines(out: str) -> list:
    return re.findall(r"attempt: k=(-?\d+) status=(\w+) supersteps=(\d+)"
                      r"(?: colors_used=(\d+))?", out)


@pytest.mark.parametrize("extra", [[], ["--strict-decrement"]])
def test_cli_equals_jax_cli(ranks, tmp_path, capsys, extra):
    common = ["--node-count", "180", "--max-degree", "9", "--seed", "4",
              "--backend", "sharded-ring", *extra]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json")]) == 0
    port_out = capsys.readouterr().out
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    count = re.findall(r"Minimal number of colors: \d+", jax_out)
    assert _attempt_lines(port_out) == _attempt_lines(jax_out) != []
    assert re.findall(r"Minimal number of colors: \d+", port_out) == count
    for rank, (rc, out, _err) in enumerate(ranks.run({
            "kind": "cli", "argv": common + [
                "--device", "cpu", "--output-coloring",
                str(tmp_path / "rank{rank}.json")]})):
        assert rc == 0
        assert (tmp_path / f"rank{rank}.json").read_bytes() == want
        assert _attempt_lines(out) == _attempt_lines(jax_out)
        assert re.findall(r"Minimal number of colors: \d+", out) == count


def test_cli_shards_above_world_size(ranks, tmp_path):
    common = ["--node-count", "50", "--max-degree", "4", "--seed", "1",
              "--backend", "sharded-ring", "--shards", "16"]
    msg = r"^requested 16 devices, have (\d+)$"
    with pytest.raises(ValueError, match=msg) as theirs:
        jcli.main(common + ["--output-coloring", str(tmp_path / "j.json")])
    with pytest.raises(ValueError, match=msg) as ours:
        tcli.main(common + ["--device", "cpu", "--output-coloring",
                            str(tmp_path / "p.json")])
    # an uncaught ValueError: `python -m` exits 1 for both
    assert type(ours.value) is type(theirs.value)
    assert re.match(msg, str(theirs.value)).group(1) == "8"
    assert re.match(msg, str(ours.value)).group(1) == "1"
    for rc, _out, err in ranks.run({"kind": "cli", "argv": common + [
            "--device", "cpu", "--output-coloring",
            str(tmp_path / "r{rank}.json")]}):
        assert rc == 1
        assert err.splitlines()[-1] == \
            "ValueError: requested 16 devices, have 3"
