"""The port's dense engine (``DenseEngine`` on the plain K11 and K12)
equals ``dgc_tpu``'s on the CPU, exactly: every value is an integer and
the f32 counts are exact.

- ``find_minimal_coloring`` in jump and strict mode: the attempt tuples
  (k, status, supersteps, colors_used), ``minimal_colors`` and the colors'
  bytes, on uniform graphs, a heavy-tail graph with kmax above 128, a graph
  with isolated vertices and V off the 256-vertex tile;
- single attempts below 1, above kmax (equal to the k0 attempt) and under
  a ``max_steps`` that stalls;
- K11's and K12's plain versions against the JAX kernel body's
  intermediates (``cand``, ``fail_v``, ``keep``, the new colors) on random
  colorings, both engines fed the same adjacency through
  ``convert.dense_from_jax``;
- the CLI's ``--backend dense`` writes ``dgc_tpu.cli``'s coloring JSON.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from dgc_tpu.engine.dense_engine import DenseEngine as JaxDense  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine.dense_engine import DenseEngine  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring  # noqa: E402
from dgc_tpu_torch.kernels import dense as kd  # noqa: E402


def _with_isolated(v: int, seed: int) -> JaxArrays:
    """A random graph on the first 80% of ``v`` vertices; the rest isolated."""
    rng = np.random.default_rng(seed)
    live = int(v * 0.8)
    edges = rng.integers(0, live, size=(4 * v, 2))
    return JaxArrays.from_edge_list(v, edges)


GRAPHS = {
    "uniform400-s0": lambda: generate_random_graph(400, 12, seed=0, native=False),
    "uniform400-s1": lambda: generate_random_graph(400, 12, seed=1, native=False),
    "rmat1500": lambda: generate_rmat_graph(1500, 8.0, seed=1, native=False),
    "isolated333": lambda: _with_isolated(333, 2),
}
_cache: dict = {}


def graph(name: str) -> JaxArrays:
    if name not in _cache:
        _cache[name] = GRAPHS[name]()
    return _cache[name]


def port_engine(g, **kw) -> DenseEngine:
    return DenseEngine(convert.graph_from_numpy(g.indptr, g.indices),
                       device="cpu", **kw)


def key(res) -> tuple:
    return ([(a.k, int(a.status), a.supersteps, a.colors_used)
             for a in res.attempts], res.minimal_colors, res.colors.tobytes())


def test_rmat_case_has_a_wide_one_hot():
    assert port_engine(graph("rmat1500")).kmax > 128
    assert graph("isolated333").num_vertices % kd.VERTEX_TILE != 0
    assert (graph("isolated333").degrees == 0).any()


@pytest.mark.parametrize("strict", [False, True], ids=["jump", "strict"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_find_minimal_coloring_equals_jax(name, strict):
    g = graph(name)
    k0 = g.max_degree + 1
    if strict:  # a few budgets above the jump result: a short strict chain
        k0 = jax_find(JaxDense(g), k0).minimal_colors + 3
    want = key(jax_find(JaxDense(g), k0, strict_decrement=strict))
    assert key(find_minimal_coloring(port_engine(g), k0,
                                     strict_decrement=strict)) == want


def _same(ours, ref) -> None:
    assert (int(ours.status), ours.supersteps, ours.k) == \
        (int(ref.status), ref.supersteps, ref.k)
    np.testing.assert_array_equal(ours.colors, ref.colors)


@pytest.mark.parametrize("name", ["uniform400-s0", "rmat1500", "isolated333"])
def test_single_attempts_equal_jax(name):
    g = graph(name)
    jax_engine, ours = JaxDense(g), port_engine(g)
    assert ours.kmax == jax_engine.kmax and ours.max_steps == jax_engine.max_steps
    k0 = g.max_degree + 1
    for k in (0, -3, 1, 2, k0, ours.kmax, ours.kmax + 77):
        _same(ours.attempt(k), jax_engine.attempt(k))
    # a budget past kmax clamps to it: the k0 attempt, bit for bit
    top, first = ours.attempt(ours.kmax + 77), ours.attempt(k0)
    assert (top.status, top.supersteps) == (first.status, first.supersteps)
    np.testing.assert_array_equal(top.colors, first.colors)
    # a small step budget stalls
    ours2, jax2 = port_engine(g, max_steps=2), JaxDense(g, max_steps=2)
    res = ours2.attempt(k0)
    assert res.status.name == "STALLED" and res.supersteps == 2
    _same(res, jax2.attempt(k0))


def test_too_large_raises_with_the_jax_message():
    g = JaxArrays.from_edge_list(20_000, np.zeros((0, 2), np.int64))
    with pytest.raises(ValueError) as want:
        JaxDense(g)
    with pytest.raises(ValueError) as got:
        DenseEngine(convert.graph_from_numpy(g.indptr, g.indices),
                    device="cpu")
    assert str(got.value) == str(want.value)


def _jax_body(adj, degrees, colors, k: int, kmax: int) -> dict:
    """The intermediates of one superstep of
    ``dgc_tpu.engine.dense_engine._attempt_kernel_dense``'s body, line for
    line (the jitted loop does not expose them)."""
    v = adj.shape[0]
    ids = jnp.arange(v, dtype=jnp.int32)
    col_ids = jnp.arange(kmax, dtype=jnp.int32)
    beats = (degrees[None, :] > degrees[:, None]) | (
        (degrees[None, :] == degrees[:, None]) & (ids[None, :] < ids[:, None]))
    uncol = colors < 0
    onehot = (colors[:, None] == col_ids[None, :]).astype(jnp.bfloat16)
    counts = jax.lax.dot(adj, onehot, preferred_element_type=jnp.float32)
    free = ~((counts > 0.5) | (col_ids[None, :] >= k))
    cand = jnp.argmax(free, axis=1).astype(jnp.int32)
    fail_v = ~jnp.any(free, axis=1)
    any_fail = jnp.any(uncol & fail_v)
    beaten = (adj > 0) & uncol[None, :] & (cand[None, :] == cand[:, None]) & beats
    keep = ~jnp.any(beaten, axis=1)
    new = jnp.where(uncol & keep & ~fail_v, cand, colors)
    new = jnp.where(any_fail, colors, new)
    return {k_: np.asarray(x) for k_, x in dict(
        cand=cand, fail_v=fail_v, keep=keep, new=new, uncol=uncol,
        any_fail=any_fail).items()}


@pytest.mark.parametrize("name", ["uniform400-s1", "rmat1500", "isolated333"])
def test_plain_kernels_equal_the_jax_body(name):
    g = graph(name)
    jax_engine = JaxDense(g)
    ours = convert.dense_from_jax(
        np.asarray(jax_engine.adj, np.float32), np.asarray(jax_engine.degrees),
        jax_engine.kmax, jax_engine.max_steps, device="cpu")
    v, vp = g.num_vertices, ours.adj.shape[0]
    rng = np.random.default_rng(11)
    top = g.max_degree + 1
    for trial in range(6):
        rate = (0.0, 0.3, 0.7, 1.0, 0.5, 0.2)[trial]
        colors = np.where(rng.random(v) < rate, -1,
                          rng.integers(0, max(2, top // (trial + 1)), v))
        colors = colors.astype(np.int32)
        for k in (1, 3, max(1, top // 2), top, ours.kmax):
            want = _jax_body(jax_engine.adj, jax_engine.degrees,
                             jnp.asarray(colors), k, jax_engine.kmax)
            buf = np.full((2, vp), -1, np.int32)
            buf[trial % 2, :v] = colors
            state = torch.from_numpy(buf)
            ctrl = kd.new_dense_ctrl("cpu")
            ctrl[kd.DCTRL_CUR] = trial % 2
            ctrl[kd.DCTRL_STEP] = trial
            cand = torch.full((vp,), 7, dtype=torch.int32)

            first, fail = kd.first_fit_reference(ours.adj, state[trial % 2], k)
            np.testing.assert_array_equal(first[:v].numpy(), want["cand"])
            np.testing.assert_array_equal(fail[:v].numpy(), want["fail_v"])

            kd.dense_forbid(ctrl, state, ours.adj, cand, v, k)
            uncol = want["uncol"]
            np.testing.assert_array_equal(cand[:v].numpy(),
                                          np.where(uncol, want["cand"], -1))
            assert (cand[v:] == -1).all()
            assert int(ctrl[kd.DCTRL_FAIL]) == int((uncol & want["fail_v"]).sum())

            keep = kd.keep_reference(ours.adj, cand, ours.degrees)
            np.testing.assert_array_equal(keep[:v].numpy()[uncol],
                                          want["keep"][uncol])

            kd.dense_resolve(ctrl, state, ours.adj, cand, ours.degrees, v,
                             jax_engine.max_steps)
            cur = int(ctrl[kd.DCTRL_CUR])
            assert cur == (trial % 2 if want["any_fail"] else 1 - trial % 2)
            np.testing.assert_array_equal(state[cur, :v].numpy(), want["new"])
            assert int(ctrl[kd.DCTRL_STEP]) == trial + 1
            status = kd.resolve_status(bool(want["any_fail"]),
                                       int((want["new"] < 0).sum()), trial,
                                       jax_engine.max_steps)
            assert int(ctrl[kd.DCTRL_STATUS]) == status


def _edge_rows_graph():
    """Rows 0, 41 and 100 joined to 40, 32 and 64 neighbors that hold the
    colors 0..n-1: first fits past a 32-bit word, at its first bit, and
    none below 64; every other row uncolored and isolated."""
    edges, colors = [], np.full(300, -1, np.int32)
    for row, first, n in ((0, 1, 40), (41, 42, 32), (100, 101, 64)):
        edges += [(row, first + i) for i in range(n)]
        colors[first: first + n] = np.arange(n)
    return JaxArrays.from_edge_list(300, np.array(edges)), colors


def test_plain_first_fit_at_the_mask_words_equals_the_jax_body():
    """K11's plain version — the card's yardstick for its bitmask — where
    a first fit crosses or ends a 32-bit word, or finds no free color."""
    g, colors = _edge_rows_graph()
    jax_engine = JaxDense(g)
    ours = convert.dense_from_jax(
        np.asarray(jax_engine.adj, np.float32), np.asarray(jax_engine.degrees),
        jax_engine.kmax, jax_engine.max_steps, device="cpu")
    v, vp = g.num_vertices, ours.adj.shape[0]
    buf = np.full((2, vp), -1, np.int32)
    buf[0, :v] = colors
    for k in (1, 32, 33, 40, 41, 64, 65, jax_engine.kmax):
        want = _jax_body(jax_engine.adj, jax_engine.degrees,
                         jnp.asarray(colors), k, jax_engine.kmax)
        ctrl = kd.new_dense_ctrl("cpu")
        cand = torch.full((vp,), 7, dtype=torch.int32)
        kd.dense_forbid(ctrl, torch.from_numpy(buf), ours.adj, cand, v, k)
        uncol = want["uncol"]
        np.testing.assert_array_equal(cand[:v].numpy(),
                                      np.where(uncol, want["cand"], -1))
        assert [int(cand[r]) for r in (0, 41, 100)] == [
            n if n < k else 0 for n in (40, 32, 64)]
        assert int(ctrl[kd.DCTRL_FAIL]) == int((uncol & want["fail_v"]).sum())


def test_cpu_run_counts_no_launch():
    kd.reset_launch_counts()
    g = graph("uniform400-s0")
    port_engine(g).attempt(g.max_degree + 1)
    assert set(kd.launch_counts.values()) == {0}


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = graph("isolated333")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseEngine(convert.graph_from_numpy(g.indptr, g.indices))


@pytest.mark.parametrize("extra", [[], ["--strict-decrement"]])
def test_cli_writes_the_jax_cli_coloring(tmp_path, capsys, extra):
    from dgc_tpu import cli as jcli

    common = ["--node-count", "300", "--max-degree", "10", "--seed", "3",
              "--backend", "dense", *extra]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert "Minimal number of colors:" in capsys.readouterr().out
