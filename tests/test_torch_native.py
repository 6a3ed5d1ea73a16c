"""The port's native host paths (``dgc_tpu_torch.native``) equal
``dgc_tpu``'s, byte for byte, where a C++ toolchain exists.

- ``graphgen.cpp`` is ``dgc_tpu``'s source, verbatim;
- ``Graph.generate`` at 60,000 vertices (the C++ generators' side of the
  50,000-vertex threshold) for ``fast``, ``rmat`` and ``reference``, and
  the 1M ``fast`` and ``rmat`` draws of ``chip_smoke.py``'s main path
  (whose sha256 it pins), equal ``dgc_tpu``'s defaults;
- ``reduce_color_count`` with its defaults (the native walk with its
  budget, the native greedy resweep) equals ``dgc_tpu``'s, colors and
  ``last_run``;
- the native relabel and combined-table builds equal the NumPy paths;
- a loader that cannot build gives the ``native=False`` results.

A case skips only where ``dgc_tpu``'s own library is unavailable.
"""

import hashlib
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu.models.graph import Graph as JaxGraph  # noqa: E402
from dgc_tpu.native import bindings as jax_bindings  # noqa: E402
from dgc_tpu.ops import reduce_colors as jrc  # noqa: E402
from dgc_tpu_torch.engine import bucketed as tb  # noqa: E402
from dgc_tpu_torch.engine.oracle import greedy_color  # noqa: E402
from dgc_tpu_torch.models import generators as tgen  # noqa: E402
from dgc_tpu_torch.models.graph import Graph  # noqa: E402
from dgc_tpu_torch.native import bindings  # noqa: E402
from dgc_tpu_torch.ops import reduce_colors as trc  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def toolchain():
    if not jax_bindings.native_available():
        pytest.skip("no C++ toolchain: dgc_tpu's native library is unavailable")
    assert bindings.native_available()


def _same_csr(a, b) -> None:
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def test_graphgen_source_is_dgc_tpus():
    ours = (ROOT / "dgc_tpu_torch" / "native" / "graphgen.cpp").read_bytes()
    assert ours == (ROOT / "dgc_tpu" / "native" / "graphgen.cpp").read_bytes()


@pytest.mark.parametrize("method", ["fast", "rmat", "reference"])
def test_generate_at_60k_equals_jax(toolchain, method):
    ours = Graph.generate(60_000, 32, seed=0, method=method).arrays
    _same_csr(ours, JaxGraph.generate(60_000, 32, seed=0, method=method).arrays)
    # the C++ stream: another graph than the NumPy path's
    py = {"fast": lambda: tgen.generate_random_graph_fast(
              60_000, 16.0, seed=0, max_degree=32, native=False),
          "rmat": lambda: tgen.generate_rmat_graph(60_000, 16.0, seed=0,
                                                   native=False),
          "reference": lambda: tgen.generate_random_graph(
              60_000, 32, seed=0, native=False)}[method]()
    assert not np.array_equal(ours.indices[:1000], py.indices[:1000])


@pytest.mark.parametrize("method", ["fast", "rmat"])
def test_main_path_draw_equals_jax_and_its_pin(toolchain, method):
    import chip_smoke

    ours = Graph.generate(1_000_000, 32, seed=0, method=method).arrays
    ref = JaxGraph.generate(1_000_000, 32, seed=0, method=method).arrays
    _same_csr(ours, ref)
    assert chip_smoke.graph_sha256(ours) == chip_smoke.DRAW_SHA256[method]
    want = hashlib.sha256(ref.indptr.astype("<i4").tobytes()
                          + ref.indices.astype("<i4").tobytes()).hexdigest()
    assert want == chip_smoke.DRAW_SHA256[method]
    if method == "fast":
        assert len(ours.indices) == 15_999_324
    else:
        assert ours.max_degree == 38_142


def _reduce_input(seed: int):
    """A 60,000-vertex graph and a valid coloring with slack: first-fit in
    a random order."""
    g = Graph.generate(60_000, 32, seed=seed, method="fast").arrays
    order = np.random.default_rng(seed).permutation(g.num_vertices)
    return g, greedy_color(g, order=order)


@pytest.mark.parametrize("seed", [0, 1])
def test_reduce_defaults_equal_jax(toolchain, seed):
    g, colors = _reduce_input(seed)
    ours = trc.reduce_color_count(g.indptr, g.indices, colors)
    ours_run = dict(trc.last_run)
    ref = jrc.reduce_color_count(g.indptr, g.indices, colors)
    np.testing.assert_array_equal(ours, ref)
    assert ours_run == dict(jrc.last_run)
    assert ours_run["path"] == "native" and ours_run["greedy"] == "native"
    assert int(ours.max()) < int(colors.max())


def test_last_run_is_per_thread(toolchain):
    g, colors = _reduce_input(0)
    trc.reduce_color_count(g.indptr, g.indices, colors)
    seen = {}
    t = threading.Thread(target=lambda: seen.update(dict(trc.last_run)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == {}
    assert trc.last_run["path"] == "native"


@pytest.mark.parametrize("method", ["fast", "rmat"])
def test_relabel_and_combined_equal_numpy(toolchain, method):
    arrays = Graph.generate(3000, 32, seed=2, method=method).arrays
    nat = tb.build_degree_buckets(arrays, native=True)
    py = tb.build_degree_buckets(arrays, native=False)
    np.testing.assert_array_equal(nat.indices, py.indices)
    np.testing.assert_array_equal(nat.indptr, py.indptr)
    assert nat.row0 == py.row0
    for a, b in zip(nat.combined, py.combined, strict=True):
        np.testing.assert_array_equal(a, b)
    v = arrays.num_vertices
    w = max(1, int(nat.degrees[0]))
    np.testing.assert_array_equal(
        tb.build_combined_rows(nat.indptr, nat.indices, nat.degrees, 5, v, w,
                               v, native=True),
        tb.build_combined_rows(py.indptr, py.indices, py.degrees, 5, v, w, v))


def test_a_loader_that_cannot_build_takes_the_numpy_paths(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_load_failed", False)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(bindings, "CXX", str(tmp_path / "no-such-compiler"))
    assert not bindings.native_available()
    assert not list(tmp_path.rglob("*.tmp"))  # nothing half-written left
    for method, py in (
            ("fast", lambda: tgen.generate_random_graph_fast(
                60_000, 16.0, seed=0, max_degree=32, native=False)),
            ("rmat", lambda: tgen.generate_rmat_graph(60_000, 16.0, seed=0,
                                                      native=False))):
        _same_csr(Graph.generate(60_000, 32, seed=0, method=method).arrays,
                  py())
    arrays = Graph.generate(400, 12, seed=1, method="fast").arrays
    colors = np.arange(400, dtype=np.int32)
    out = trc.reduce_color_count(arrays.indptr, arrays.indices, colors)
    np.testing.assert_array_equal(out, trc.reduce_color_count(
        arrays.indptr, arrays.indices, colors, native=False))
    assert trc.last_run["path"] == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        trc.reduce_color_count(arrays.indptr, arrays.indices, colors,
                               native=True)
