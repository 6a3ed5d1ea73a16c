"""The port's compact engine (``dgc_tpu_torch.engine.compact``) equals
``dgc_tpu.engine.compact.CompactFrontierEngine`` on the CPU.

- The schedule (``default_stages``, ``stage_slot_ranges``,
  ``derive_schedule``, the hub configs and the ladder checks) equals the
  JAX functions on uniform and RMAT bucket layouts, hub layouts and
  malformed inputs included (the same ``ValueError``s).
- ``compact_idx`` and the stage-entry row gather equal the JAX code.
- ``attempt`` and ``sweep`` equal the JAX engine's, built by the port and
  from the JAX engine's tables (``convert``): status, supersteps, k and
  colors of every attempt, on a uniform graph, an RMAT graph and an
  isolated-vertex graph, with explicit stage ladders (the default ladder
  does not compact below 2^14 vertices); also jump and strict sweeps,
  k < 1, failing budgets, window widening, a step budget that stalls, a
  confirm resumed from the ring and one that misses it.
- The CLI colors a hub layout (a 301-vertex star) as ``dgc_tpu.cli`` does.
  ``tests/test_torch_hub*.py`` hold the hub region itself against JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dgc_tpu.engine import compact as jc  # noqa: E402
from dgc_tpu.engine.bucketed import build_degree_buckets as jax_buckets  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu.models.graph import Graph as JaxGraph  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import compact as tc  # noqa: E402
from dgc_tpu_torch.engine import hub as th  # noqa: E402
from dgc_tpu_torch.engine.base import AttemptStatus  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring  # noqa: E402
from dgc_tpu_torch.kernels import compact as kc  # noqa: E402
from dgc_tpu_torch.ops.segmented_gather import plan_from_ranges  # noqa: E402


def _complete(v: int) -> JaxArrays:
    return JaxArrays.from_edge_list(
        v, np.array([[i, j] for i in range(v) for j in range(i + 1, v)]))


# graph, engine knobs (explicit ladders force compaction at test size)
CONFIGS = {
    "uniform": (lambda: generate_random_graph(3000, 16, seed=0, native=False),
                dict(stages=((None, 750), (750, 188), (188, 12), (12, 0)))),
    "rmat": (lambda: generate_rmat_graph(4096, avg_degree=8, seed=0,
                                         native=False),
             dict(flat_cap=1024,
                  stages=((None, 1024), (1024, 64), (64, 0)))),
    "isolated": (lambda: JaxArrays.from_neighbor_lists(
        [[], [2, 3], [1], [1], [], [6], [5], []]),
        dict(stages=((None, 4), (4, 0)))),
    "k40-cap1": (lambda: _complete(40),
                 dict(max_window_planes=1, stages=((None, 0),))),
    "steps3": (lambda: generate_random_graph(3000, 16, seed=1, native=False),
               dict(max_steps=3, stages=((None, 750), (750, 0)))),
}
_cache: dict = {}


def config(name: str):
    """(graph, JAX engine), built once per module."""
    if name not in _cache:
        make, kw = CONFIGS[name]
        g = make()
        _cache[name] = (g, jc.CompactFrontierEngine(g, **kw))
    return _cache[name]


def port_engine(name: str, build: str):
    g, jax_engine = config(name)
    kw = CONFIGS[name][1]
    if build == "port":
        return tc.CompactFrontierEngine(
            convert.graph_from_numpy(g.indptr, g.indices), device="cpu", **kw)
    return convert.compact_engine_from_tables(
        jax_engine.perm, np.asarray(jax_engine.degrees),
        [np.asarray(c) for c in jax_engine.combined_buckets],
        jax_engine.planes,
        None if jax_engine.flat_ext is None else np.asarray(jax_engine.flat_ext),
        jax_engine.stages, jax_engine.stage_ranges,
        hub_buckets=jax_engine.hub_buckets, hub_prune=jax_engine.hub_prune,
        hub_uncond=jax_engine.hub_uncond,
        max_window_planes=jax_engine._window_cap,
        max_steps=jax_engine.max_steps, device="cpu")


def assert_same_attempt(ours, ref):
    assert (int(ours.status), ours.supersteps, ours.k) == \
        (int(ref.status), ref.supersteps, ref.k)
    np.testing.assert_array_equal(ours.colors, ref.colors)


def assert_same_pair(ours, ref):
    assert (ours[1] is None) == (ref[1] is None)
    for a, b in zip(ours, ref):
        if b is not None:
            assert_same_attempt(a, b)


# ---- schedule ---------------------------------------------------------------

def _layout(name: str):
    g = config(name)[0]
    b = jax_buckets(g, native=False)
    return ([c.shape[0] for c in b.combined], [c.shape[1] for c in b.combined],
            g.num_vertices, g.max_degree)


def test_default_stages_equal_jax():
    for v in (1, 100, 1 << 14, (1 << 14) + 1, 20_000, 1_000_000):
        for heavy in (False, True):
            assert tc.default_stages(v, heavy) == jc.default_stages(v, heavy)


@pytest.mark.parametrize("name", ["uniform", "rmat"])
def test_stage_slot_ranges_equal_jax(name):
    sizes, widths, v, _ = _layout(name)
    for pad in (1, 16, 1024, 4096, 8192):
        for max_ranges in (1, 2, 6):
            for pct in (0, 10, 100):
                assert tc.stage_slot_ranges(sizes, widths, pad, max_ranges, pct) \
                    == jc.stage_slot_ranges(sizes, widths, pad, max_ranges, pct)


@pytest.mark.parametrize("name", ["uniform", "rmat"])
def test_derive_schedule_equal_jax(name):
    sizes, widths, v, dmax = _layout(name)
    knob_sets = [
        {},
        dict(flat_cap=1024),
        dict(flat_cap=4),                          # every bucket a hub
        dict(flat_cap=32, hub_uncond_entries=0, prune_u_min=4),
        dict(flat_budget=5000, max_ranges=2, range_coalesce_pct=0),
        dict(flat_cap=8, prune_p_div=4, prune_p2_div=2, prune_p2_min=8,
             hub_prune_overrides={0: {"u_div": 2}, 1: {"p_div": 1}}),
        dict(stages=((None, v // 2), (v // 2, v // 16), (v // 16, 0))),
    ]
    hubs = set()
    for kw in knob_sets:
        ours = tc.derive_schedule(sizes, widths, v, dmax, **kw)
        ref = jc.derive_schedule(sizes, widths, v, dmax, **kw)
        assert ours == ref
        hubs.add(ours["hub_buckets"] > 0)
    assert hubs == {False, True}


def _raises_alike(fn_ours, fn_ref):
    with pytest.raises(ValueError) as ours:
        fn_ours()
    with pytest.raises(ValueError) as ref:
        fn_ref()
    assert str(ours.value) == str(ref.value)


BAD_LADDERS = [
    (),
    ((None, 50), (16, 0)),        # scale below the possible frontier
    ((None, 10), (200, 0)),       # rung above V
    ((None, 10), (0, 0)),         # non-positive rung
    ((None, -1),),                # negative threshold
    ((None, 10), (None, 20)),     # thresholds increasing
    ((None, 10), (16.0, 0)),      # a float rung
    ((None, True),),              # a bool threshold
]


@pytest.mark.parametrize("ladder", BAD_LADDERS, ids=str)
def test_malformed_ladders_raise_like_jax(ladder):
    _raises_alike(lambda: tc._check_stage_ladder(ladder, 100),
                  lambda: jc._check_stage_ladder(ladder, 100))


BAD_KNOBS = [
    dict(flat_cap=0), dict(max_ranges=0), dict(range_coalesce_pct=101),
    dict(hub_uncond_entries=-1), dict(prune_u_min=True),
    dict(hub_prune_overrides={-1: {}}),
    dict(hub_prune_overrides={0: {"bogus": 1}}),
    dict(hub_prune_overrides={0: {"u_div": 0}}),
]


@pytest.mark.parametrize("knobs", BAD_KNOBS, ids=str)
def test_bad_knobs_raise_like_jax(knobs):
    sizes, widths, v, dmax = _layout("rmat")
    _raises_alike(lambda: tc.derive_schedule(sizes, widths, v, dmax, **knobs),
                  lambda: jc.derive_schedule(sizes, widths, v, dmax, **knobs))


def test_hub_configs_equal_jax():
    for rows in (1, 31, 100, 1000, 10_000):
        assert th.hub_pad_for(rows) == jc.hub_pad_for(rows)
        for width in (64, 512, 8192):
            for kw in ({}, dict(u_min=8, uncond_entries=0),
                       dict(p_div=1, p2_div=16, p2_min=4)):
                assert th.hub_prune_cfg(rows, width, **kw) == \
                    jc.hub_prune_cfg(rows, width, **kw)
    _raises_alike(lambda: th.hub_prune_cfg(10, 10, p_div=0),
                  lambda: jc.hub_prune_cfg(10, 10, p_div=0))


# ---- compaction and the stage-entry gather ----------------------------------

@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_compact_idx_equals_jax(density):
    """Active counts below, at and above the pad."""
    rng = np.random.default_rng(int(density * 100))
    n = 500
    act = rng.random(n) < density
    for pad in (1, 16, int(act.sum()) or 1, 256, 1024):
        ours = kc.compact_idx(torch.from_numpy(act), pad, n)
        ref = jc._compact_idx(jnp.asarray(act), pad, n)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_stage_rows_equal_jax_gather():
    """K4's plain version against the JAX stage entry (compact.py:1526-1541)."""
    rng = np.random.default_rng(3)
    v, w_flat = 300, 12
    flat_ext = np.concatenate([rng.integers(0, v + 1, (v, w_flat)),
                               np.full((1, w_flat), v)]).astype(np.int32)
    act = rng.random(v) < 0.3
    pad = 128
    ranges = ((0, 20, 12, 1), (20, 70, 8, 1), (70, 128, 4, 1))
    idx = jc._compact_idx(jnp.asarray(act), pad, v)
    seg_ref = jnp.concatenate([
        jnp.take(jnp.asarray(flat_ext)[:, :w], idx[r0:r1], axis=0).reshape(-1)
        for r0, r1, w, _ in ranges])
    gidx_ref = jnp.where(idx == v, v + 1, idx)
    seg, gidx = kc.stage_rows_reference(
        torch.from_numpy(flat_ext), torch.from_numpy(np.array(idx)),
        plan_from_ranges(ranges), 0, v)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_ref))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(gidx_ref))


def test_compact_slots_copies_the_current_buffer():
    rng = np.random.default_rng(5)
    v = 200
    state = torch.from_numpy(rng.integers(-1, 40, (2, v + 2)).astype(np.int32))
    state[:, v], state[:, v + 1] = -1, 0
    ctrl = kc.new_ctrl(step=3, prev_active=v, device="cpu")
    ctrl[kc.CTRL_CUR] = 1
    idx = kc.compact_slots(ctrl, state, 0, 256)
    assert torch.equal(state[0], state[1])
    pk = state[1, :v]
    np.testing.assert_array_equal(
        idx.numpy(), kc.compact_idx((pk < 0) | ((pk & 1) == 1), 256, v).numpy())


# K3's plain version at the kernel's edges: V off its 2,048-item round, a
# pad far above the active count (the first stage's ratio), row offsets
@pytest.mark.parametrize("v,row0,pad,density", [
    (2047, 0, 8192, 0.01), (4099, 0, 1 << 16, 0.002),
    (5003, 3, 1 << 17, 0.01), (2049, 2048, 4096, 1.0)])
def test_compact_slots_plain_with_a_far_pad_equals_jax(v, row0, pad,
                                                        density):
    rng = np.random.default_rng(v)
    words = rng.integers(0, 400, (2, v + 2)) * 2
    act = rng.random((2, v + 2)) < density
    words[act] = np.where(rng.random(int(act.sum())) < 0.5, -1,
                          words[act] + 1)
    state = torch.from_numpy(words.astype(np.int32))
    state[:, v], state[:, v + 1] = -1, 0
    before = state.clone()
    ctrl = kc.new_ctrl(step=3, prev_active=v, device="cpu")
    ctrl[kc.CTRL_CUR] = 1
    idx = kc.compact_slots_reference(ctrl, state, row0, pad)
    pk = before[1, row0:v]
    want = jc._compact_idx(jnp.asarray(((pk < 0) | ((pk & 1) == 1)).numpy()),
                           pad, v - row0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert torch.equal(state[0, row0:v], before[1, row0:v])
    assert torch.equal(state[0, :row0], before[0, :row0])
    assert torch.equal(state[1], before[1])


def test_slots_scratch_checks_and_the_cpu_needs_none():
    cpu = torch.device("cpu")
    assert kc.new_slots_scratch(cpu) is None
    with pytest.raises(ValueError, match="needs its scratch"):
        kc._check_slots_scratch(None, cpu)
    with pytest.raises(ValueError, match="is on meta"):
        kc._check_slots_scratch(torch.zeros(5, dtype=torch.int64,
                                            device="meta"), cpu)
    with pytest.raises(TypeError, match="int64"):
        kc._check_slots_scratch(torch.zeros(5, dtype=torch.int32), cpu)
    with pytest.raises(ValueError, match="1 \\+ blocks"):
        kc._check_slots_scratch(torch.zeros(1, dtype=torch.int64), cpu)
    kc._check_slots_scratch(torch.zeros(5, dtype=torch.int64), cpu)
    # the plain version takes no scratch, and leaves one it is given alone
    v = 300
    state = torch.from_numpy(np.random.default_rng(3).integers(
        -1, 40, (2, v + 2)).astype(np.int32))
    ctrl = kc.new_ctrl(step=3, prev_active=v, device="cpu")
    scratch = torch.full((4,), 5, dtype=torch.int64)
    a = kc.compact_slots(ctrl, state.clone(), 0, 512)
    b = kc.compact_slots(ctrl, state.clone(), 0, 512, scratch)
    assert torch.equal(a, b) and (scratch == 5).all()


# ---- the engine -------------------------------------------------------------

ENGINE_GRAPHS = ["uniform", "rmat", "isolated"]


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", ENGINE_GRAPHS)
def test_engine_tables_equal_jax(name, build):
    _, jax_engine = config(name)
    ours = port_engine(name, build)
    assert ours.stages == jax_engine.stages
    assert ours.stage_ranges == jax_engine.stage_ranges
    assert ours.planes == jax_engine.planes
    assert ours.flat_planes == jax_engine.flat_planes
    assert ours.init_bucket_active == jax_engine.init_bucket_active
    assert ours.max_steps == jax_engine.max_steps
    np.testing.assert_array_equal(ours.flat_ext.numpy(),
                                  np.asarray(jax_engine.flat_ext))
    for a, b in zip(ours.combined_buckets, jax_engine.combined_buckets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", ENGINE_GRAPHS)
def test_attempts_equal_jax(name, build):
    g, jax_engine = config(name)
    ours = port_engine(name, build)
    k0 = g.max_degree + 1
    used = jax_engine.attempt(k0).colors_used
    budgets = sorted({k0, used, used - 1, max(used - 2, 1), 1, 0, -1},
                     reverse=True)
    statuses = set()
    for k in budgets:
        ref = jax_engine.attempt(k)
        statuses.add(ref.status.name)
        assert_same_attempt(ours.attempt(k), ref)
    assert {"SUCCESS", "FAILURE"} <= statuses


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", ENGINE_GRAPHS)
def test_sweep_equals_jax(name, build):
    g, jax_engine = config(name)
    ours = port_engine(name, build)
    k0 = g.max_degree + 1
    used = jax_engine.attempt(k0).colors_used
    for k in (k0, used, 1, 0):
        assert_same_pair(ours.sweep(k), jax_engine.sweep(k))
    pair = ours.sweep(k0)
    if pair[1] is not None and pair[1].k >= 1:
        # the confirm resumed from the ring, past the shared prefix
        assert ours.resumed_from_step is not None
        assert 1 <= ours.resumed_from_step <= pair[1].supersteps


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", ENGINE_GRAPHS)
def test_find_minimal_coloring_equals_jax(name, strict):
    g, jax_engine = config(name)
    k0 = g.max_degree + 1
    if strict:  # start the one-by-one chain a few budgets above the result
        k0 = min(k0, jax_engine.attempt(k0).colors_used + 2)
    ours = find_minimal_coloring(port_engine(name, "port"), k0,
                                 strict_decrement=strict, k_min=2)
    ref = jax_find(jax_engine, k0, strict_decrement=strict, k_min=2)
    rows = [[(a.k, int(a.status), a.supersteps, a.colors_used)
             for a in r.attempts] for r in (ours, ref)]
    assert rows[0] == rows[1]
    assert ours.minimal_colors == ref.minimal_colors
    np.testing.assert_array_equal(ours.colors, ref.colors)


@pytest.mark.parametrize("build", ["port", "convert"])
def test_capped_window_widens_like_jax(build):
    """max_window_planes=1 on K40: the first pass stalls, the windows
    widen and the retry succeeds, in attempt and in sweep. Widening
    changes the engines, so each run starts from fresh ones."""
    _cache.pop("k40-cap1", None)
    _, jax_engine = config("k40-cap1")
    ours = port_engine("k40-cap1", build)
    assert ours.planes == (1,)
    for k in (41, 40, 39, 33, 32):
        assert_same_attempt(ours.attempt(k), jax_engine.attempt(k))
    assert ours._window_cap == jax_engine._window_cap > 1
    assert ours.planes == jax_engine.planes
    _cache.pop("k40-cap1")
    _, jax_engine = config("k40-cap1")
    ours = port_engine("k40-cap1", build)
    assert_same_pair(ours.sweep(41), jax_engine.sweep(41))
    assert ours.planes == jax_engine.planes


@pytest.mark.parametrize("build", ["port", "convert"])
def test_step_budget_stalls_like_jax(build):
    g, jax_engine = config("steps3")
    ours = port_engine("steps3", build)
    for k in (g.max_degree + 1, 5):
        ref = jax_engine.attempt(k)
        assert ref.status == AttemptStatus.STALLED
        assert_same_attempt(ours.attempt(k), ref)
    assert_same_pair(ours.sweep(g.max_degree + 1),
                     jax_engine.sweep(g.max_degree + 1))


@pytest.mark.parametrize("name", ["uniform", "rmat"])
def test_ring_miss_confirms_from_scratch_like_jax(name, monkeypatch):
    """A confirm that finds no ring entry starts over and still equals the
    JAX sweep (whose ring hits): supersteps count from the start."""
    g, jax_engine = config(name)
    ours = port_engine(name, "port")
    monkeypatch.setattr(ours, "_resume_point", lambda ring, c, k: None)
    assert_same_pair(ours.sweep(g.max_degree + 1),
                     jax_engine.sweep(g.max_degree + 1))
    assert ours.resumed_from_step is None


def test_resume_point_takes_the_latest_bracket():
    ours = port_engine("isolated", "port")
    v = ours.num_vertices
    ring = kc.new_ring(v, 1, "cpu")
    ring[0][:] = torch.arange(4)[:, None]
    ring[1][:] = torch.arange(10, 14)[:, None]
    meta = [[2, -1, 3, 0, 9], [3, 3, 5, 1, 7], [4, 5, 9, 0, 5],
            [5, 2, 6, 2, 4]]
    ring[2][:] = torch.tensor(meta, dtype=torch.int32)
    c = [0] * kc.CTRL_LEN
    c[kc.CTRL_REC_CNT] = 4
    assert ours._resume_point(ring, c, -1) is None       # under every bracket
    assert ours._resume_point(ring, c, 10) is None       # over every bracket
    state, ctrl, ba = ours._resume_point(ring, c, 6)     # slots 2 and 3: 3 wins
    assert ours.resumed_from_step == 5
    assert torch.equal(state[0], ring[0][3]) and torch.equal(state[1], ring[0][3])
    assert ctrl.tolist()[:5] == [0, 5, 4, 2, 0]
    assert ba.tolist() == [13]                           # the live counts too
    c[kc.CTRL_REC_CNT] = 2                               # slots 2, 3 unwritten
    assert ours._resume_point(ring, c, 6) is None


def test_cli_colors_a_hub_layout_like_jax(tmp_path):
    """A graph whose widest bucket passes flat_cap (256): the default
    backend colors it as ``dgc_tpu.cli`` does (the post-pass off: the
    sweep is what this case is about)."""
    from dgc_tpu import cli as jcli
    from dgc_tpu_torch import cli as tcli

    edges = np.array([[0, j] for j in range(1, 301)])
    JaxGraph(JaxArrays.from_edge_list(301, edges)).serialize(tmp_path / "g.json")
    common = ["--input", str(tmp_path / "g.json"), "--no-reduce-colors"]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_cpu_engine_never_counts_launches():
    kc.reset_launch_counts()
    g, _ = config("uniform")
    port_engine("uniform", "port").sweep(g.max_degree + 1)
    assert set(kc.launch_counts.values()) == {0}


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, _ = config("isolated")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.CompactFrontierEngine(convert.graph_from_numpy(g.indptr, g.indices))
