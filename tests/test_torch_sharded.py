"""The port's vertex-sharded flat engine (``--backend sharded``) equals
``dgc_tpu``'s on the CPU.

- At world size 1, in this process (a one-rank gloo group): every
  attempt's status, supersteps, budget and colors, and ``sweep``'s pair,
  equal ``dgc_tpu``'s ``ShardedELLEngine`` on the 8 host devices, the
  port's engine built from the graph and from the JAX engine's tables
  (``convert``); with telemetry on, the trajectories too.
- At 2 gloo ranks (``tests/torch_shard_ranks.py``: one group, spawned once
  for this module, one thread a rank): the same, and the CLI.
- The window retry on K40 under a 1-plane cap, the empty budget, the
  ``max_ell_width`` refusal and ``--shards`` above the world size (the
  same message and exit as ``dgc_tpu.cli``).

The comparison is exact: every value is an int32.
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu import cli as jcli  # noqa: E402
from dgc_tpu.engine.sharded import ShardedELLEngine as JaxSharded  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import generate_random_graph  # noqa: E402
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine.sharded import ShardedELLEngine  # noqa: E402
from dgc_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple  # noqa: E402
from torch_shard_ranks import RankGroup  # noqa: E402


def _complete(v: int) -> JaxArrays:
    return JaxArrays.from_edge_list(
        v, np.array([[i, j] for i in range(v) for j in range(i + 1, v)]))


GRAPHS = {
    # 301 rows: the padded V differs at 1, 2 and 8 shards
    "uniform": lambda: generate_random_graph(301, 10, seed=2, native=False),
    "uniform_dense": lambda: generate_random_graph(160, 24, seed=5,
                                                   native=False),
    "isolated": lambda: JaxArrays.from_neighbor_lists(
        [[], [2, 3], [1], [1], [], [6], [5], []]),
}
_cache: dict = {}


def cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def graph(name: str) -> JaxArrays:
    return cached(("graph", name), GRAPHS[name])


def jax_engine(name: str, **kw):
    return cached(("jax", name, tuple(sorted(kw.items()))),
                  lambda: JaxSharded(graph(name), **kw))


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


def calls_for(g) -> list:
    """Every budget the tests run: Δ+1, the next budgets of the minimal-k
    loop, a failing one, the empty budgets and one past every window."""
    k0 = g.max_degree + 1
    used = cached(("used", id(g)), lambda: JaxSharded(g).attempt(k0)).colors_used
    return [k0, used - 1, max(used - 3, 1), 0, -1, 32 * 4 + 77]


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


def _reference(name: str, ks: list) -> list:
    eng = jax_engine(name)
    return [row(eng.attempt(k)) for k in ks] + [
        tuple(row(r) for r in eng.sweep(ks[0]))]


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_attempts_and_sweep_equal_jax(name, build):
    g = graph(name)
    ks = calls_for(g)
    if build == "port":
        eng = ShardedELLEngine(port_arrays(g), device="cpu")
    else:
        j = jax_engine(name)
        eng = convert.sharded_engine_from_tables(
            np.asarray(j.nbrs), np.asarray(j.deg_g), j.v_true, j.max_steps,
            max_window_planes=j.num_planes, device="cpu")
    ours = [row(eng.attempt(k)) for k in ks] + [
        tuple(row(r) for r in eng.sweep(ks[0]))]
    ref = _reference(name, ks)
    for o, r in zip(ours[:-1], ref[:-1]):
        assert_same(o, r)
    for o, r in zip(ours[-1], ref[-1]):
        assert_same(o, r)


@pytest.mark.parametrize("name", ["uniform", "uniform_dense"])
def test_two_ranks_equal_jax(ranks, tmp_path, name):
    g = graph(name)
    ks = calls_for(g)
    path = tmp_path / "g.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    calls = [["attempt", k] for k in ks] + [["sweep", ks[0]]]
    ref = _reference(name, ks)
    per_rank = ranks.run({"kind": "engine", "backend": "sharded",
                          "graph": str(path), "calls": calls})
    for ours in per_rank:
        for o, r in zip(ours[:-1], ref[:-1]):
            assert_same(o, r)
        for o, r in zip(ours[-1], ref[-1]):
            assert_same(o, r)


def test_capped_window_widens_on_clique(ranks, tmp_path):
    # K40 under a 1-plane (32-color) window: no wrong FAILURE, STALLED,
    # widened, 40 colors; 39 fails. One rank and two.
    g = cached(("graph", "k40"), lambda: _complete(40))
    ref = JaxSharded(g, max_window_planes=1)
    want = [row(ref.attempt(40)), row(ref.attempt(39))]
    assert want[0][0] == 1 and len(set(want[0][3].tolist())) == 40
    eng = ShardedELLEngine(port_arrays(g), max_window_planes=1, device="cpu")
    assert eng.num_planes == 1
    got = [row(eng.attempt(40)), row(eng.attempt(39))]
    assert eng.num_planes == ref.num_planes > 1
    path = tmp_path / "k40.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    two = ranks.run({"kind": "engine", "backend": "sharded",
                     "graph": str(path), "kw": {"max_window_planes": 1},
                     "calls": [["attempt", 40], ["attempt", 39],
                               ["sweep", 40]]})
    ref2 = JaxSharded(g, max_window_planes=1)
    pair = tuple(row(r) for r in ref2.sweep(40))
    for ours in [got] + [t[:2] for t in two]:
        for o, r in zip(ours, want):
            assert_same(o, r)
    for t in two:
        for o, r in zip(t[2], pair):
            assert_same(o, r)


def test_trajectories_equal_jax():
    g = graph("uniform")
    k0 = g.max_degree + 1
    ref = JaxSharded(g)
    ref.record_trajectory = True
    eng = ShardedELLEngine(port_arrays(g), device="cpu")
    eng.record_trajectory = True
    pairs = [(eng.attempt(k0), ref.attempt(k0))]
    pairs += list(zip(eng.sweep(k0), ref.sweep(k0)))
    for ours, theirs in pairs:
        a, b = ours.trajectory, theirs.trajectory
        assert (a.first_step, a.truncated) == (b.first_step, b.truncated)
        for col in ("active", "fail", "mc", "gather_calls", "max_unconf"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
        assert a.bucket_active is None and a.step_us is None


def test_refuses_heavy_tail():
    v = 600
    g = JaxArrays.from_edge_list(v, np.array([[0, j] for j in range(1, v)]))
    with pytest.raises(ValueError) as theirs:
        JaxSharded(g, num_shards=2, max_ell_width=256)
    with pytest.raises(ValueError) as ours:
        ShardedELLEngine(port_arrays(g), max_ell_width=256, device="cpu")
    assert str(ours.value) == str(theirs.value)
    assert "sharded-bucketed" in str(ours.value)
    # an explicit opt-in runs, and agrees
    eng = ShardedELLEngine(port_arrays(g), max_ell_width=1024, device="cpu")
    ref = JaxSharded(g, num_shards=2, max_ell_width=1024)
    assert_same(row(eng.attempt(g.max_degree + 1)),
                row(ref.attempt(g.max_degree + 1)))


def test_mesh_and_padding():
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"v": 1})
    assert mesh.block(12) == slice(0, 12)
    assert [pad_to_multiple(n, 8) for n in (1, 8, 301)] == [8, 8, 304]
    with pytest.raises(ValueError, match=r"^requested 2 devices, have 1$"):
        make_mesh(2, device="cpu")


@pytest.mark.parametrize("nccl,cards,env,want", [
    (False, 1, {}, "gloo"),
    (True, 0, {}, "gloo"),
    (True, 1, {}, "cpu:gloo,cuda:nccl"),
    (True, 1, {"WORLD_SIZE": "2"}, "gloo"),
    (True, 2, {"WORLD_SIZE": "2"}, "cpu:gloo,cuda:nccl"),
    (True, 4, {"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"},
     "cpu:gloo,cuda:nccl"),
    (True, 1, {"WORLD_SIZE": "1", "LOCAL_WORLD_SIZE": "2"}, "gloo"),
])
def test_group_backend(monkeypatch, nccl, cards, env, want):
    """NCCL where every rank of the host has a card of its own, else gloo
    (NCCL refuses two ranks on one card)."""
    from dgc_tpu_torch.parallel import mesh as pm

    monkeypatch.setattr(pm.dist, "is_nccl_available", lambda: nccl)
    monkeypatch.setattr(pm.torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(pm.torch.cuda, "device_count", lambda: cards)
    for name in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert pm.group_backend() == want


def _attempt_lines(out: str) -> list:
    return re.findall(r"attempt: k=(-?\d+) status=(\w+) supersteps=(\d+)"
                      r"(?: colors_used=(\d+))?", out)


@pytest.mark.parametrize("extra", [[], ["--strict-decrement"]])
def test_cli_equals_jax_cli(ranks, tmp_path, capsys, extra):
    common = ["--node-count", "180", "--max-degree", "9", "--seed", "4",
              "--backend", "sharded", *extra]
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
              "--backend", "sharded", "--shards", "16"]
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
            "ValueError: requested 16 devices, have 2"
