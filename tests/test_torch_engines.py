"""The port's ELL and bucketed engines equal ``dgc_tpu``'s on the CPU.

Each engine of the port runs twice: built by the port from the graph, and
built from the JAX engine's own tables through ``dgc_tpu_torch.convert``.
Every attempt's status, supersteps and color vector must equal the JAX
engine's exactly, across seeds and budgets (success, failure, k < 1).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu.engine.bucketed import BucketedELLEngine as JaxBucketed  # noqa: E402
from dgc_tpu.engine.bucketed import build_degree_buckets as jax_buckets  # noqa: E402
from dgc_tpu.engine.bucketed import bucket_planes as jax_planes  # noqa: E402
from dgc_tpu.engine.superstep import ELLEngine as JaxELL  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu.ops.speculative import beats_rule as jax_beats  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import bucketed as tb  # noqa: E402
from dgc_tpu_torch.engine.superstep import ELLEngine, ell_combined_table  # noqa: E402


def _complete(v: int) -> JaxArrays:
    return JaxArrays.from_edge_list(
        v, np.array([[i, j] for i in range(v) for j in range(i + 1, v)]))


GRAPHS = {
    "uniform0": lambda: generate_random_graph(200, 10, seed=0, native=False),
    "uniform1": lambda: generate_random_graph(300, 14, seed=1, native=False),
    "rmat": lambda: generate_rmat_graph(512, avg_degree=6, seed=1, native=False),
    "isolated": lambda: JaxArrays.from_neighbor_lists(
        [[], [2, 3], [1], [1], [], [6], [5], []]),
}
_graph_cache: dict = {}


def graph(name: str) -> JaxArrays:
    if name not in _graph_cache:
        _graph_cache[name] = GRAPHS[name]()
    return _graph_cache[name]


def port_engine(kind: str, build: str, jax_engine, g, **kw):
    if kind == "ell" and build == "port":
        return ELLEngine(convert.graph_from_numpy(g.indptr, g.indices),
                         device="cpu")
    if kind == "ell":
        return convert.ell_engine_from_tables(
            np.asarray(jax_engine.nbrs), np.asarray(jax_engine.degrees),
            device="cpu")
    if build == "port":
        return tb.BucketedELLEngine(
            convert.graph_from_numpy(g.indptr, g.indices), device="cpu", **kw)
    return convert.bucketed_engine_from_tables(
        jax_engine.perm, np.asarray(jax_engine.degrees),
        [np.asarray(c) for c in jax_engine.combined_buckets], jax_engine.planes,
        max_window_planes=jax_engine._window_cap, device="cpu")


def assert_same_attempt(ours, ref):
    assert (int(ours.status), ours.supersteps, ours.k) == \
        (int(ref.status), ref.supersteps, ref.k)
    np.testing.assert_array_equal(ours.colors, ref.colors)


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("kind", ["ell", "bucketed"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_attempts_equal_jax(name, kind, build):
    g = graph(name)
    jax_engine = JaxELL(g) if kind == "ell" else JaxBucketed(g)
    ours = port_engine(kind, build, jax_engine, g)
    k0 = g.max_degree + 1
    first = jax_engine.attempt(k0)
    used = first.colors_used
    # success at k0 and above the capacity, the tightest success, failure
    # below it, the smallest budgets, and k < 1
    budgets = sorted({k0, k0 + 40, used, used - 1, max(used - 2, 1), 2, 1,
                      0, -1}, reverse=True)
    statuses = set()
    for k in budgets:
        ref = jax_engine.attempt(k)
        statuses.add(ref.status.name)
        assert_same_attempt(ours.attempt(k), ref)
    assert {"SUCCESS", "FAILURE"} <= statuses


@pytest.mark.parametrize("build", ["port", "convert"])
def test_capped_window_widens_like_jax(build):
    """max_window_planes=1 on K40: every window is capped below its width,
    the first pass stalls, the windows widen and the retry succeeds."""
    g = _complete(40)
    jax_engine = JaxBucketed(g, max_window_planes=1)
    ours = port_engine("bucketed", build, jax_engine, g, max_window_planes=1)
    assert ours.planes == jax_engine.planes == (1,)
    for k in (41, 40, 39, 33, 32):
        assert_same_attempt(ours.attempt(k), jax_engine.attempt(k))
    assert ours._window_cap == jax_engine._window_cap > 1
    assert ours.planes == jax_engine.planes


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bucket_tables_equal_jax(name):
    g = graph(name)
    ref = jax_buckets(g, native=False)
    ours = tb.build_degree_buckets(convert.graph_from_numpy(g.indptr, g.indices))
    for field in ("perm", "degrees", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
    assert ours.row0 == ref.row0
    assert len(ours.combined) == len(ref.combined)
    for a, b in zip(ours.combined, ref.combined):
        np.testing.assert_array_equal(a, b)
    for cap in (1, 2, 32):
        assert tb.bucket_planes(ours.combined, cap) == jax_planes(ref.combined, cap)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_table_equals_jax_pre_beats(name):
    """The ELL engine's combined table packs exactly ``pre_beats`` of
    ``dgc_tpu.engine.superstep._attempt_kernel`` into bit 30."""
    import torch

    g = graph(name)
    jax_engine = JaxELL(g)
    nbrs = np.array(jax_engine.nbrs)
    degrees = np.array(jax_engine.degrees)
    v = len(degrees)
    n_deg = np.concatenate([degrees, [-1]])[nbrs]
    beats = jax_beats(n_deg, nbrs, degrees[:, None], np.arange(v)[:, None])
    ours = ell_combined_table(torch.from_numpy(nbrs), torch.from_numpy(degrees))
    np.testing.assert_array_equal(ours.numpy(),
                                  tb.encode_combined(nbrs, beats))


def test_bucket_widths_equal_jax():
    from dgc_tpu.engine.bucketed import _bucket_widths

    for d in (0, 1, 3, 16, 17, 63, 64, 65, 300, 5000):
        for mw in (4, 8):
            assert tb._bucket_widths(d, min_width=mw) == _bucket_widths(d, min_width=mw)


def test_cpu_engine_never_counts_launches():
    from dgc_tpu_torch.kernels.superstep import launch_counts, reset_launch_counts

    reset_launch_counts()
    g = graph("uniform0")
    tb.BucketedELLEngine(convert.graph_from_numpy(g.indptr, g.indices),
                         device="cpu").attempt(g.max_degree + 1)
    assert launch_counts == {"superstep_rows": 0, "superstep_finish": 0}


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = graph("uniform0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ELLEngine(convert.graph_from_numpy(g.indptr, g.indices))
