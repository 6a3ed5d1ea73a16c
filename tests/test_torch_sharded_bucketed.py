"""The port's degree-bucketed sharded engine (``--backend
sharded-bucketed``) equals ``dgc_tpu``'s on the CPU.

- At world size 1, in this process: every attempt's status, supersteps,
  budget and colors, and ``sweep``'s pair, equal ``dgc_tpu``'s
  ``ShardedBucketedEngine`` on the 8 host devices, on a uniform draw, an
  RMAT draw with a heavy tail and isolated vertices; at the default knobs,
  and with every slice conditioned (each branch of the hub ladder: skip,
  full, compact, rebase, pruned, shrink, pruned2), which moves work and
  never a result; built from the graph and from the JAX engine's tables
  (``convert``); with telemetry on, the trajectories too.
- At 2 gloo ranks (``tests/torch_shard_ranks.py``, one group for this
  module): the same, the prefix-resumed confirm of the heavy tail, and
  the CLI.
- The window retry on K40 under a 1-plane cap, the empty budget, the host
  functions' copies (``tests/test_torch_import.py`` pins their source).
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu import cli as jcli  # noqa: E402
from dgc_tpu.engine import sharded_bucketed as jsb  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import sharded_bucketed as tsb  # noqa: E402
from dgc_tpu_torch.engine.hub import BRANCH_NAMES, fresh_prune  # noqa: E402
from dgc_tpu_torch.kernels import hub as kh  # noqa: E402
from torch_shard_ranks import RankGroup  # noqa: E402

GRAPHS = {
    "uniform": lambda: generate_random_graph(301, 10, seed=2, native=False),
    # Δ 238: a heavy tail, 15 width buckets
    "rmat": lambda: generate_rmat_graph(1024, avg_degree=8, seed=1,
                                        native=False),
    "isolated": lambda: JaxArrays.from_neighbor_lists(
        [[], [2, 3], [1], [1], [], [6], [5], []]),
}
# every slice conditioned: the knobs move work, never a result. PADDED:
# each slice compacts at its pad (no prune config under 2·128 columns);
# FORCED: prune configs (tier 2 included) on test-size slices
KNOBS = {"default": {}, "padded": dict(uncond_entries=0),
         "forced": dict(uncond_entries=0, prune_u_min=2, prune_p2_min=2)}
FORCED = KNOBS["forced"]
_cache: dict = {}


def cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def graph(name: str) -> JaxArrays:
    return cached(("graph", name), GRAPHS[name])


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


def reference(name: str) -> tuple:
    """(budgets, results): dgc_tpu's engine on the 8 host devices at
    Δ+1, the loop's next budget, a failing one, the empty budget, then its
    sweep pair from Δ+1."""

    def build():
        g = graph(name)
        eng = jsb.ShardedBucketedEngine(g)
        k0 = g.max_degree + 1
        first = eng.attempt(k0)
        ks = [k0, first.colors_used - 1, max(first.colors_used - 3, 1), 0]
        return ks, [row(first)] + [row(eng.attempt(k)) for k in ks[1:]] + [
            tuple(row(r) for r in eng.sweep(k0))]

    return cached(("ref", name), build)


def run_calls(eng, ks: list) -> list:
    return [row(eng.attempt(k)) for k in ks] + [
        tuple(row(r) for r in eng.sweep(ks[0]))]


def assert_calls(ours: list, ref: list) -> None:
    for o, r in zip(ours[:-1], ref[:-1]):
        assert_same(o, r)
    for o, r in zip(ours[-1], ref[-1]):
        assert_same(o, r)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_attempts_and_sweep_equal_jax(name, knobs):
    ks, ref = reference(name)
    eng = tsb.ShardedBucketedEngine(port_arrays(graph(name)), device="cpu",
                                    **KNOBS[knobs])
    assert_calls(run_calls(eng, ks), ref)


def test_conditioned_slices_take_every_branch(monkeypatch):
    # the hub ladder's branches the RMAT sweeps took under the padded and
    # the forced knobs, read off the live table K7 leaves each superstep
    taken = set()
    real = kh.hub_superstep

    def spy(ctrl, state, table, live, plan, pool, *a, **kw):
        taken.update(live[kh.LIVE_BRANCH, : len(plan.buckets)].tolist())
        return real(ctrl, state, table, live, plan, pool, *a, **kw)

    monkeypatch.setattr(tsb.kh, "hub_superstep", spy)
    ks, ref = reference("rmat")
    for knobs in ("padded", "forced"):
        eng = tsb.ShardedBucketedEngine(port_arrays(graph("rmat")),
                                        device="cpu", **KNOBS[knobs])
        assert len(eng.cond_idx) > 0
        first, second = eng.sweep(ks[0])
        assert_same(row(first), ref[-1][0])
        assert_same(row(second), ref[-1][1])
        # the confirm fast-forwarded past the prefix it shares with
        # attempt 1
        assert eng.resumed_from_step is not None and eng.resumed_from_step > 1
    assert eng.uncond_idx == () and len(eng.cond_idx) == len(eng.planes)
    assert any(c is not None and len(c) == 3 for c in eng.prune_cfg)
    assert {BRANCH_NAMES[b] for b in taken} == set(BRANCH_NAMES)


def test_engine_from_jax_tables():
    # the JAX engine at one shard: its layout is this rank's
    g = graph("rmat")
    j = jsb.ShardedBucketedEngine(g, num_shards=1)
    lay = j.layout
    eng = convert.sharded_bucketed_engine_from_tables(
        lay.orig_of_final, lay.deg_final, lay.tables, lay.slice_sizes,
        lay.v_final, j.pads, j.prune_cfg, j.max_steps, device="cpu")
    ks, ref = reference("rmat")
    assert_calls(run_calls(eng, ks[:2]), ref[:2] + ref[-1:])


def test_host_layout_equals_jax():
    g = graph("rmat")
    for n in (1, 2, 8):
        ours = tsb.build_sharded_buckets(port_arrays(g), n)
        theirs = jsb.build_sharded_buckets(g, n)
        assert ours.slice_sizes == theirs.slice_sizes
        assert ours.v_final == theirs.v_final
        np.testing.assert_array_equal(ours.orig_of_final,
                                      theirs.orig_of_final)
        np.testing.assert_array_equal(ours.deg_final, theirs.deg_final)
        for a, b in zip(ours.tables, theirs.tables, strict=True):
            np.testing.assert_array_equal(a, b)
    # the fresh prune state of a shard's slices: invalid captures
    tables = [np.asarray(t[: sl]) for t, sl in
              zip(theirs.tables, theirs.slice_sizes)]
    planes = tuple(min(-(-(t.shape[1] + 1) // 32), 32) for t in tables)
    cfg = tuple(jsb.shard_prune_cfg(t.shape[0], t.shape[1], uncond_entries=0,
                                    u_min=2) for t in tables)
    for a, b in zip(fresh_prune(tables, len(tables), planes, cfg,
                                theirs.v_final),
                    jsb._fresh_shard_prune(tables, planes, cfg,
                                           theirs.v_final), strict=True):
        assert (a is None) == (b is None)
        for x, y in zip(a or (), b or (), strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for rows, width in ((32, 8192), (4096, 64), (100, 2000)):
        assert tsb.shard_pad_for(rows, width) == jsb.shard_pad_for(rows, width)
        assert tsb.shard_prune_cfg(rows, width, u_min=4) == \
            jsb.shard_prune_cfg(rows, width, u_min=4)


def test_two_ranks_equal_jax(ranks, tmp_path):
    for name in ("uniform", "rmat"):
        g = graph(name)
        ks, ref = reference(name)
        path = tmp_path / f"{name}.npz"
        np.savez(path, indptr=g.indptr, indices=g.indices)
        calls = [["attempt", k] for k in ks] + [["sweep", ks[0]]]
        for kw in KNOBS.values():
            for ours in ranks.run({"kind": "engine",
                                   "backend": "sharded-bucketed",
                                   "graph": str(path), "kw": kw,
                                   "calls": calls}):
                assert_calls(ours, ref)


def test_capped_window_widens_on_clique(ranks, tmp_path):
    v = 40
    g = cached(("graph", "k40"), lambda: JaxArrays.from_edge_list(
        v, np.array([[i, j] for i in range(v) for j in range(i + 1, v)])))
    ref = jsb.ShardedBucketedEngine(g, max_window_planes=1)
    want = tuple(row(r) for r in ref.sweep(v))
    assert want[0][0] == 1 and len(set(want[0][3].tolist())) == 40
    eng = tsb.ShardedBucketedEngine(port_arrays(g), max_window_planes=1,
                                    device="cpu")
    got = tuple(row(r) for r in eng.sweep(v))
    assert eng._window_cap == ref._window_cap > 1
    path = tmp_path / "k40.npz"
    np.savez(path, indptr=g.indptr, indices=g.indices)
    two = ranks.run({"kind": "engine", "backend": "sharded-bucketed",
                     "graph": str(path), "kw": {"max_window_planes": 1},
                     "calls": [["sweep", v]]})
    for ours in [got] + [t[0] for t in two]:
        for o, r in zip(ours, want):
            assert_same(o, r)


def test_trajectories_equal_jax():
    g = graph("uniform")
    k0 = g.max_degree + 1
    ref = jsb.ShardedBucketedEngine(g)
    ref.record_trajectory = True
    eng = tsb.ShardedBucketedEngine(port_arrays(g), device="cpu")
    eng.record_trajectory = True
    for ours, theirs in zip(eng.sweep(k0), ref.sweep(k0)):
        a, b = ours.trajectory, theirs.trajectory
        assert (a.first_step, a.truncated) == (b.first_step, b.truncated)
        for col in ("active", "fail", "mc", "gather_calls", "max_unconf"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


def _attempt_lines(out: str) -> list:
    return re.findall(r"attempt: k=(-?\d+) status=(\w+) supersteps=(\d+)"
                      r"(?: colors_used=(\d+))?", out)


def test_cli_equals_jax_cli(ranks, tmp_path, capsys):
    common = ["--node-count", "200", "--max-degree", "12", "--seed", "3",
              "--gen-method", "rmat", "--backend", "sharded-bucketed",
              "--strict-decrement"]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    jax_out = capsys.readouterr().out
    want = (tmp_path / "jax.json").read_bytes()
    count = re.findall(r"Minimal number of colors: \d+", jax_out)
    d = tmp_path / "tel"
    d.mkdir()
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json"),
                               "--log-json", str(d / "run.jsonl"),
                               "--run-manifest", str(d / "m.json")]) == 0
    port_out = capsys.readouterr().out
    assert (tmp_path / "port.json").read_bytes() == want
    assert _attempt_lines(port_out) == _attempt_lines(jax_out) != []
    assert re.findall(r"Minimal number of colors: \d+", port_out) == count
    events = (d / "run.jsonl").read_text()
    assert '"event": "distributed"' in events
    assert events.count('"event": "trajectory"') == len(
        _attempt_lines(jax_out))
    for rank, (rc, out, _err) in enumerate(ranks.run({
            "kind": "cli", "argv": common + [
                "--device", "cpu", "--output-coloring",
                str(tmp_path / "rank{rank}.json")]})):
        assert rc == 0
        assert (tmp_path / f"rank{rank}.json").read_bytes() == want
        assert _attempt_lines(out) == _attempt_lines(jax_out)
        assert re.findall(r"Minimal number of colors: \d+", out) == count


@pytest.mark.parametrize("argv", [["--backend", "sharded-ring",
                                   "--reshard-on-loss"],
                                  ["--backend", "sharded-bucketed",
                                   "--reshard-on-loss"]])
def test_cli_refuses_the_unported(tmp_path, capsys, argv):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--node-count", "50", "--max-degree", "4", "--device",
                   "cpu", "--output-coloring", str(tmp_path / "c.json"),
                   *argv])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
