"""Hub layouts shared by ``tests/test_torch_hub_engine.py``,
``tests/test_torch_hub_layouts.py``, ``tests/test_torch_hub_uniform.py``
and ``tests/test_torch_telemetry_hub*.py``:
each graph and its knobs, the JAX engine's results (run once per module),
the same calls on the port, and the checks the three files share.

At test sizes the default knobs never reach the conditioned ladder (every
hub bucket holds fewer than 2^17 entries, so it runs unconditioned); the
forced knobs are those of ``tests/test_compact.py``.
"""

import numpy as np

from dgc_tpu.engine import compact as jc
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find
from dgc_tpu.models.arrays import GraphArrays as JaxArrays
from dgc_tpu.models.generators import generate_random_graph, generate_rmat_graph
from dgc_tpu_torch import convert
from dgc_tpu_torch.engine import compact as tc
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring


def _rmat2000():
    return generate_rmat_graph(2000, avg_degree=10.0, seed=5, native=False)


def _clique48():
    return JaxArrays.from_edge_list(
        48, np.array([[i, j] for i in range(48) for j in range(i + 1, 48)]))


CONFIGS = {
    # every conditioned branch, tier 2 included, with compaction stages
    "rmat-tier2": (_rmat2000, dict(
        flat_cap=8, prune_u_min=4, prune_p2_min=4, hub_uncond_entries=0,
        stages=((None, 500), (500, 64), (64, 0)))),
    # the ladder-free full-table phase (_hybrid_superstep)
    "rmat-ladder-free": (_rmat2000, dict(flat_cap=8, prune_u_min=4,
                                         hub_uncond_entries=0)),
    # the compact branch: hub buckets of > 4·hub_pad_for rows, no config
    "uniform-compact": (lambda: generate_random_graph(5000, 16, seed=21,
                                                      native=False),
                        dict(flat_cap=4, hub_uncond_entries=0,
                             stages=((None, 2500), (2500, 312), (312, 0)))),
    # the default knobs: a hub region of unconditioned buckets only
    "rmat-default": (lambda: generate_rmat_graph(4096, avg_degree=8, seed=0,
                                                 native=False),
                     dict(stages=((None, 1024), (1024, 64), (64, 0)))),
    # a capped window on a pruned bucket: the attempt stalls, widens
    "k48-cap1": (_clique48, dict(flat_cap=4, prune_u_min=8,
                                 hub_uncond_entries=0, max_window_planes=1,
                                 stages=((None, 0),))),
}
_graphs: dict = {}
_runs: dict = {}


def graph(name: str):
    if name not in _graphs:
        _graphs[name] = CONFIGS[name][0]()
    return _graphs[name]


def jax_engine(name: str):
    """A fresh JAX engine (widening changes an engine, so each sequence of
    calls starts from a new one)."""
    return jc.CompactFrontierEngine(graph(name), **CONFIGS[name][1])


def port_engine(name: str, build: str = "port"):
    """The port's engine, built by the port or from a fresh JAX engine's
    tables (``convert``), on the CPU."""
    g = graph(name)
    if build == "port":
        return tc.CompactFrontierEngine(
            convert.graph_from_numpy(g.indptr, g.indices), device="cpu",
            **CONFIGS[name][1])
    e = jax_engine(name)
    return convert.compact_engine_from_tables(
        e.perm, np.asarray(e.degrees),
        [np.asarray(c) for c in e.combined_buckets], e.planes,
        None if e.flat_ext is None else np.asarray(e.flat_ext),
        e.stages, e.stage_ranges, hub_buckets=e.hub_buckets,
        hub_prune=e.hub_prune, hub_uncond=e.hub_uncond,
        max_window_planes=e._window_cap, max_steps=e.max_steps, device="cpu")


def row(res):
    if res is None:
        return None
    return (res.k, int(res.status), res.supersteps, res.colors_used,
            res.colors.tobytes())


def run_calls(engine, k0: int, used: int, resumed: list | None = None) -> list:
    """attempt at k0, at the JAX result's colors and one below, then the
    fused sweeps at k0 and at that count: every result's row. ``resumed``
    (the port's engines only) receives each sweep's ``resumed_from_step``."""
    out = [row(engine.attempt(k)) for k in (k0, used, used - 1)]
    for k in (k0, used):
        pair = engine.sweep(k)
        out.append(tuple(row(r) for r in pair))
        if resumed is not None:
            resumed.append(engine.resumed_from_step)
    return out


def jax_calls(name: str) -> list:
    """``run_calls`` on the JAX engine, once per module."""
    if name not in _runs:
        g = graph(name)
        k0 = g.max_degree + 1
        used = jax_engine(name).attempt(k0).colors_used
        _runs[name] = (k0, used, run_calls(jax_engine(name), k0, used))
    return _runs[name]


def find_rows(engine, k0: int, strict: bool, jax: bool) -> tuple:
    find = jax_find if jax else find_minimal_coloring
    res = find(engine, k0, strict_decrement=strict, k_min=2)
    return ([(a.k, int(a.status), a.supersteps, a.colors_used)
             for a in res.attempts], res.minimal_colors, res.colors.tobytes())


def strict_k0(name: str) -> int:
    """Start the one-by-one chain a few budgets above the jump result."""
    k0, used, _ = jax_calls(name)
    return min(k0, used + 2)


def check_tables(name: str, build: str = "port"):
    """The port's schedule and tables equal the JAX engine's."""
    ref = jax_engine(name)
    ours = port_engine(name, build)
    assert ours.hub_buckets == ref.hub_buckets > 0
    assert (ours.hub_prune, ours.hub_uncond) == (ref.hub_prune, ref.hub_uncond)
    assert ours.flat_row0 == ref.flat_row0
    assert ours.init_bucket_active == ref.init_bucket_active
    assert ours.planes == ref.planes and ours.stages == ref.stages
    if ref.flat_ext is None:
        assert ours.flat_ext is None
    else:
        np.testing.assert_array_equal(ours.flat_ext.numpy(),
                                      np.asarray(ref.flat_ext))
    return ours, ref


def check_runs(name: str, build: str) -> list:
    """``run_calls`` on the port equals it on JAX; returns each sweep's
    ``resumed_from_step``."""
    k0, used, ref = jax_calls(name)
    resumed = []
    assert run_calls(port_engine(name, build), k0, used, resumed) == ref
    return resumed


def check_find(name: str, strict: bool) -> None:
    """Jump or strict ``find_minimal_coloring`` equals JAX's."""
    k0 = strict_k0(name) if strict else jax_calls(name)[0]
    assert find_rows(port_engine(name), k0, strict, jax=False) \
        == find_rows(jax_engine(name), k0, strict, jax=True)


def check_telemetry(name: str, attempt: bool = False) -> list:
    """The fused sweep at k0 (and, with ``attempt``, one attempt at the
    JAX result's colors less one) with telemetry on: results and
    trajectories equal JAX's; the port's results equal telemetry off.
    Returns the port's trajectories."""
    ref_e, ours_e = jax_engine(name), port_engine(name)
    ref_e.record_trajectory = ours_e.record_trajectory = True
    k0 = graph(name).max_degree + 1
    ref, ours = list(ref_e.sweep(k0)), list(ours_e.sweep(k0))
    assert ours_e.resumed_from_step is not None
    if attempt:
        used = ref[0].colors_used
        ref.append(ref_e.attempt(used - 1))
        ours.append(ours_e.attempt(used - 1))
    plain = port_engine(name)
    off = list(plain.sweep(k0)) + (
        [plain.attempt(ref[0].colors_used - 1)] if attempt else [])
    for r, o, f in zip(ref, ours, off):
        assert row(o) == row(r) == row(f)
        assert o.trajectory.to_dict() == r.trajectory.to_dict()
        assert f.trajectory is None
        t = o.trajectory
        assert t.first_step + len(t) == o.supersteps
        assert (t.max_unconf == t.max_unconf_bucket.max(axis=1)).all()
        assert t.bucket_active.shape[1] == len(ours_e.init_bucket_active)
        assert (t.bucket_active.sum(axis=1) == t.active).all()
    return [o.trajectory for o in ours]
