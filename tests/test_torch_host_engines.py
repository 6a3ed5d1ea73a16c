"""The port's host engines (``OracleEngine``, ``ReferenceSimEngine``) equal
``dgc_tpu``'s on the CPU, exactly.

The cases are those of ``tests/test_reference_sim_vectorized.py``: random
graphs walked from k0 down into failure, a heavy tail, a disconnected
graph (the baseline's stall) and a superstep cap, for both variants and
both ``impl``s — every attempt's status, supersteps, k and colors, the
per-superstep ``trace.uncolored``, and ``find_minimal_coloring``'s result.
The CLI's ``--backend oracle`` and ``--backend reference-sim`` (both
variants) write ``dgc_tpu.cli``'s coloring JSON.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.engine.oracle import OracleEngine as JaxOracle  # noqa: E402
from dgc_tpu.engine.oracle import greedy_color as jax_greedy  # noqa: E402
from dgc_tpu.engine.reference_sim import ReferenceSimEngine as JaxSim  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring  # noqa: E402
from dgc_tpu_torch.engine.oracle import OracleEngine, greedy_color  # noqa: E402
from dgc_tpu_torch.engine.reference_sim import (ReferenceSimEngine,  # noqa: E402
                                                _concat_ranges)

# name -> (graph, superstep cap)
CASES = {
    "random-s0": (lambda: generate_random_graph(80, 8, seed=0), None),
    "random-s3": (lambda: generate_random_graph(80, 8, seed=3), None),
    "random-s7": (lambda: generate_random_graph(80, 8, seed=7), None),
    "heavy-tail": (lambda: generate_rmat_graph(600, avg_degree=6, seed=5,
                                               native=False), 3 * 600),
    "disconnected": (lambda: generate_random_graph(60, 2, seed=11), 200),
    "cap2": (lambda: generate_random_graph(50, 5, seed=4), 2),
}
_cache: dict = {}


def case(name: str):
    if name not in _cache:
        make, cap = CASES[name]
        _cache[name] = (make(), cap)
    return _cache[name]


def port(g):
    return convert.graph_from_numpy(g.indptr, g.indices)


def _same(ours, ref) -> None:
    assert (int(ours.status), ours.supersteps, ours.k) == \
        (int(ref.status), ref.supersteps, ref.k)
    np.testing.assert_array_equal(ours.colors, ref.colors)


@pytest.mark.parametrize("impl", ["vectorized", "loop"])
@pytest.mark.parametrize("variant", ["optimized", "baseline"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_sim_equals_jax(name, variant, impl):
    g, cap = case(name)
    ours = ReferenceSimEngine(port(g), variant=variant, impl=impl,
                              max_supersteps=cap)
    ref = JaxSim(g, variant=variant, impl=impl, max_supersteps=cap)
    k0 = g.max_degree + 1
    first = ref.attempt(k0)
    _same(ours.attempt(k0), first)
    used = first.colors_used if first.success else k0
    for k in range(used, max(used - 3, 1) - 1, -1):  # into failure
        _same(ours.attempt(k), ref.attempt(k))
    assert ours.trace.uncolored == ref.trace.uncolored


@pytest.mark.parametrize("variant", ["optimized", "baseline"])
@pytest.mark.parametrize("name", ["random-s0", "heavy-tail", "disconnected"])
def test_minimal_coloring_equals_jax(name, variant):
    g, cap = case(name)
    for strict in (False, True):
        a = jax_find(JaxSim(g, variant=variant, max_supersteps=cap),
                     g.max_degree + 1, strict_decrement=strict)
        b = find_minimal_coloring(
            ReferenceSimEngine(port(g), variant=variant, max_supersteps=cap),
            g.max_degree + 1, strict_decrement=strict)
        assert [(r.k, int(r.status), r.supersteps, r.colors_used)
                for r in b.attempts] == \
            [(r.k, int(r.status), r.supersteps, r.colors_used)
             for r in a.attempts]
        assert b.minimal_colors == a.minimal_colors
        assert (b.colors is None) == (a.colors is None)
        if a.colors is not None:
            assert b.colors.tobytes() == a.colors.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_equals_jax(name):
    g, _ = case(name)
    np.testing.assert_array_equal(greedy_color(port(g)), jax_greedy(g))
    ours, ref = OracleEngine(port(g)), JaxOracle(g)
    top = g.max_degree + 1
    for k in range(top, 0, -1):
        _same(ours.attempt(k), ref.attempt(k))
    a = jax_find(JaxOracle(g), top)
    b = find_minimal_coloring(OracleEngine(port(g)), top)
    assert (b.minimal_colors, b.colors.tobytes()) == \
        (a.minimal_colors, a.colors.tobytes())


def test_concat_ranges_rejects_zero_length_rows():
    indptr = np.array([0, 2, 2, 5], np.int64)
    ids = np.array([0, 1, 2], np.int64)
    with pytest.raises(ValueError, match="zero-length"):
        _concat_ranges(indptr, ids, (indptr[ids + 1] - indptr[ids]))
    ok = _concat_ranges(indptr, np.array([0, 2], np.int64),
                        np.array([2, 3], np.int64))
    assert ok.tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("backend", [
    ["--backend", "oracle"],
    ["--backend", "reference-sim"],
    ["--backend", "reference-sim", "--sim-variant", "baseline"],
    ["--backend", "reference-sim", "--strict-decrement"],
], ids=["oracle", "sim-optimized", "sim-baseline", "sim-strict"])
def test_cli_writes_the_jax_cli_coloring(tmp_path, capsys, monkeypatch,
                                        backend):
    from dgc_tpu import cli as jcli

    def no_post_pass(arrays):
        raise AssertionError("the post-pass ran on a host backend")

    # the host backends' counts are the parity target: no post-pass
    monkeypatch.setattr(tcli, "make_reducer", no_post_pass)

    common = ["--node-count", "300", "--max-degree", "10", "--seed", "3",
              *backend]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert "Minimal number of colors:" in capsys.readouterr().out
