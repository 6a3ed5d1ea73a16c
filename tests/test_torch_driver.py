"""The port's minimal-k loop, host copies and CLI equal ``dgc_tpu``'s on
the CPU.

- ``find_minimal_coloring`` in jump and strict mode: the same attempt
  tuples (k, status, supersteps, colors_used) and final colors;
- the host copies (generators' NumPy paths, ``csr_to_ell``/``ell_to_csr``,
  ``Graph`` JSON, ``validate_coloring``, ``reduce_color_count`` with
  ``native=False``) equal their originals;
- ``python -m dgc_tpu_torch --device cpu`` writes the same coloring JSON as
  ``dgc_tpu.cli`` with the same backend (``ell-compact``, the default of
  both, ``ell-bucketed`` and ``ell``).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu.engine.bucketed import BucketedELLEngine as JaxBucketed  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.engine.minimal_k import make_validator as jax_validator  # noqa: E402
from dgc_tpu.engine.superstep import ELLEngine as JaxELL  # noqa: E402
from dgc_tpu.models import arrays as jarr  # noqa: E402
from dgc_tpu.models import generators as jgen  # noqa: E402
from dgc_tpu.models.graph import Graph as JaxGraph  # noqa: E402
from dgc_tpu.ops.reduce_colors import reduce_color_count as jax_reduce  # noqa: E402
from dgc_tpu.ops.validate import validate_coloring as jax_validate  # noqa: E402
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch.convert import graph_from_numpy  # noqa: E402
from dgc_tpu_torch.engine.bucketed import BucketedELLEngine  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,  # noqa: E402
                                            make_reducer, make_validator)
from dgc_tpu_torch.engine.superstep import ELLEngine  # noqa: E402
from dgc_tpu_torch.models import arrays as tarr  # noqa: E402
from dgc_tpu_torch.models import generators as tgen  # noqa: E402
from dgc_tpu_torch.models.graph import Graph  # noqa: E402
from dgc_tpu_torch.ops.reduce_colors import reduce_color_count  # noqa: E402
from dgc_tpu_torch.ops.validate import validate_coloring  # noqa: E402


def rows(result):
    return [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in result.attempts]


def same_arrays(ours, ref):
    np.testing.assert_array_equal(ours.indptr, ref.indptr)
    np.testing.assert_array_equal(ours.indices, ref.indices)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("kind", ["ell", "bucketed"])
@pytest.mark.parametrize("seed", [0, 3])
def test_find_minimal_coloring_equals_jax(seed, kind, strict):
    g = jgen.generate_random_graph(250, 12, seed=seed, native=False)
    tg = graph_from_numpy(g.indptr, g.indices)
    jax_engine = JaxELL(g) if kind == "ell" else JaxBucketed(g)
    ours_engine = (ELLEngine if kind == "ell" else BucketedELLEngine)(
        tg, device="cpu")
    ref = jax_find(jax_engine, g.max_degree + 1, strict_decrement=strict,
                   validate=jax_validator(g),
                   post_reduce=lambda c: jax_reduce(g.indptr, g.indices, c,
                                                    native=False))
    ours = find_minimal_coloring(ours_engine, g.max_degree + 1,
                                 strict_decrement=strict,
                                 validate=make_validator(tg),
                                 post_reduce=make_reducer(tg))
    assert rows(ours) == rows(ref)
    assert ours.minimal_colors == ref.minimal_colors
    assert ours.swept_colors == ref.swept_colors
    np.testing.assert_array_equal(ours.colors, ref.colors)
    assert ours.validation.valid and len(ours.attempts) >= 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generators_equal_jax(seed):
    same_arrays(tgen.generate_random_graph(120, 9, seed=seed),
                jgen.generate_random_graph(120, 9, seed=seed, native=False))
    same_arrays(tgen.generate_random_graph_fast(500, 6.0, seed=seed, max_degree=9),
                jgen.generate_random_graph_fast(500, 6.0, seed=seed,
                                                max_degree=9, native=False))
    same_arrays(tgen.generate_rmat_graph(700, 5.0, seed=seed),
                jgen.generate_rmat_graph(700, 5.0, seed=seed, native=False))
    same_arrays(tgen.generate_rmat_graph(700, 5.0, seed=seed, max_degree=20),
                jgen.generate_rmat_graph(700, 5.0, seed=seed, max_degree=20,
                                         native=False))


@pytest.mark.parametrize("pad_to", [1, 8])
def test_ell_conversions_equal_jax(pad_to):
    g = jgen.generate_rmat_graph(300, 6.0, seed=4, native=False)
    ours = tarr.csr_to_ell(g.indptr, g.indices, pad_to=pad_to)
    ref = jarr.csr_to_ell(g.indptr, g.indices, pad_to=pad_to)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    same_arrays(tarr.ell_to_csr(*ours), jarr.ell_to_csr(*ref))
    bad = tarr.GraphArrays(indptr=np.array([0, 1, 1]), indices=np.array([1]))
    assert bad.validate() == jarr.GraphArrays(
        indptr=np.array([0, 1, 1]), indices=np.array([1])).validate()


def test_graph_json_equals_jax(tmp_path):
    g = jgen.generate_random_graph(80, 6, seed=5, native=False)
    colors = np.arange(80, dtype=np.int32) % 7
    JaxGraph(g).serialize(tmp_path / "jax_graph.json", colors)
    Graph(tarr.GraphArrays(g.indptr, g.indices)).serialize(
        tmp_path / "graph.json", colors)
    assert (tmp_path / "graph.json").read_bytes() == \
        (tmp_path / "jax_graph.json").read_bytes()
    back = Graph.deserialize(tmp_path / "jax_graph.json")
    ref = JaxGraph.deserialize(tmp_path / "jax_graph.json")
    same_arrays(back.arrays, ref.arrays)
    np.testing.assert_array_equal(back.colors, ref.colors)
    Graph(back.arrays).save_coloring(tmp_path / "c.json", colors)
    JaxGraph(ref.arrays).save_coloring(tmp_path / "jc.json", colors)
    assert (tmp_path / "c.json").read_bytes() == (tmp_path / "jc.json").read_bytes()
    np.testing.assert_array_equal(Graph.load_coloring(tmp_path / "c.json"), colors)


@pytest.mark.parametrize("seed", [0, 1])
def test_validate_and_reduce_equal_jax(seed):
    g = jgen.generate_random_graph(300, 10, seed=seed, native=False)
    rng = np.random.default_rng(seed)
    for colors in (rng.integers(-1, 4, 300).astype(np.int32),
                   np.arange(300, dtype=np.int32)):
        ours = validate_coloring(g.indptr, g.indices, colors)
        ref = jax_validate(g.indptr, g.indices, colors)
        assert (ours.uncolored, ours.conflicts, ours.valid) == \
            (ref.uncolored, ref.conflicts, ref.valid)
    # a valid coloring with far too many colors: both tiers have work
    wasteful = np.arange(300, dtype=np.int32)
    res = JaxELL(g).attempt(g.max_degree + 1)
    for colors in (wasteful, res.colors, (res.colors * 3).astype(np.int32)):
        for greedy in (True, False):
            ours = reduce_color_count(g.indptr, g.indices, colors,
                                      greedy_resweep=greedy, native=False)
            ref = jax_reduce(g.indptr, g.indices, colors, native=False,
                             greedy_resweep=greedy)
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("extra", [[], ["--strict-decrement"],
                                   ["--no-reduce-colors"]])
@pytest.mark.parametrize("backend", ["ell-compact", "ell-bucketed", "ell"])
def test_cli_writes_the_jax_cli_coloring(tmp_path, capsys, backend, extra):
    from dgc_tpu import cli as jcli

    common = ["--node-count", "150", "--max-degree", "9", "--seed", "7",
              "--backend", backend, *extra]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json"),
                               "--output-graph", str(tmp_path / "g.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    out = capsys.readouterr().out
    assert "Minimal number of colors:" in out and "Total time:" in out
    # the saved graph reloads through --input to the same coloring
    assert tcli.main(["--input", str(tmp_path / "g.json"), "--device", "cpu",
                      "--backend", backend, *extra, "--output-coloring",
                      str(tmp_path / "again.json")]) == 0
    assert (tmp_path / "again.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_cli_exit_codes(tmp_path, capsys):
    out = str(tmp_path / "c.json")
    assert tcli.main(["--output-coloring", out]) == 2
    (tmp_path / "c.json").write_text('[{"id": 0, "color": 0}]')
    assert tcli.main(["--input", out, "--device", "cpu",
                      "--output-coloring", str(tmp_path / "x.json")]) == 2
    (tmp_path / "g.json").write_text(
        '[{"id": 0, "neighbors": [0], "color": -1}]')  # a self loop
    assert tcli.main(["--input", str(tmp_path / "g.json"), "--device", "cpu",
                      "--output-coloring", str(tmp_path / "x.json")]) == 2
    assert tcli.build_parser().parse_args(
        ["--output-coloring", out, "--backend", "sharded-ring"]
    ).backend == "sharded-ring"
    assert tcli.build_parser().parse_args(
        ["--output-coloring", out]).backend == "ell-compact"
    assert tcli.build_parser().parse_args(
        ["--output-coloring", out]).device == "cuda"
    capsys.readouterr()
