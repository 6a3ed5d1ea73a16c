"""The port's in-kernel superstep telemetry (``dgc_tpu_torch.obs.kernel``
and the recording kernels' plain versions) equals ``dgc_tpu``'s on the CPU.

- The layout constants, ``traj_cap_for``, the plain row write and the
  decoders equal ``dgc_tpu.layout`` and ``dgc_tpu.obs.kernel`` on seeded
  buffers (the bucket tails, a timestamp wrap and truncation included).
- With ``record_trajectory`` on, the ELL, bucketed and hub-free compact
  engines return trajectories equal to the JAX engines' byte for byte in
  cols 0-4 and both tails, with equal ``first_step`` and ``truncated``:
  attempts (success and failure), the fused sweep (its confirm resumed
  from the ring records from the resume step), the strict and jump
  attempt blocks at A = 4, and a buffer capped below the attempt.
- Col 5 is −1 on both sides with timing off; with ``record_timing`` the
  written rows carry timestamps on both sides (``step_us[0]`` −1, the rest
  non-negative; no duration is asserted to be positive or increasing),
  and every other column equals the timing-off trajectory.
- Telemetry on leaves colors and attempt tuples equal to telemetry off.

``tests/test_torch_telemetry_hub*.py`` hold the hub region's branches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dgc_tpu.engine.compact as jc  # noqa: E402
import dgc_tpu.layout as jlayout  # noqa: E402
import dgc_tpu.obs.devclock as jclock  # noqa: E402
import dgc_tpu.obs.kernel as jk  # noqa: E402
from dgc_tpu.engine.bucketed import BucketedELLEngine as JaxBucketed  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.engine.superstep import ELLEngine as JaxELL  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph_fast,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu_torch import convert, layout  # noqa: E402
from dgc_tpu_torch.engine import compact as tc  # noqa: E402
from dgc_tpu_torch.engine.bucketed import BucketedELLEngine  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring  # noqa: E402
from dgc_tpu_torch.engine.superstep import ELLEngine  # noqa: E402
from dgc_tpu_torch.obs import devclock, kernel as tk  # noqa: E402

GRAPHS = {
    "uniform": lambda: generate_random_graph_fast(1500, avg_degree=8.0,
                                                  seed=2),
    "rmat": lambda: generate_rmat_graph(600, avg_degree=8.0, seed=3,
                                        native=False),
}
# explicit ladders: the default one does not compact below 2^14 vertices
STAGES = {"uniform": ((None, 750), (750, 100), (100, 0)),
          "rmat": ((None, 300), (300, 40), (40, 0))}
_graphs: dict = {}


def _graph(name):
    if name not in _graphs:
        _graphs[name] = GRAPHS[name]()
    return _graphs[name]


def _port(g):
    return convert.graph_from_numpy(g.indptr, g.indices)


def _rec(engine, timing=False):
    engine.record_trajectory = True
    if timing:
        engine.record_timing = True
    return engine


def _same(ref, ours, timing=False):
    """Equal results and trajectories (``step_us`` by presence and sign
    when ``timing``)."""
    assert (ref is None) == (ours is None)
    if ref is None:
        return
    assert (ours.k, ours.status, ours.supersteps) == \
        (ref.k, ref.status, ref.supersteps)
    if ref.colors is not None:
        assert np.array_equal(ours.colors, ref.colors)
    a, b = ref.trajectory.to_dict(), ours.trajectory.to_dict()
    if timing:
        for d in (a, b):
            su = d.pop("step_us")
            assert su[0] == -1 and all(u >= 0 for u in su[1:])
    assert b == a


# ---- the layout, the row write and the decoders --------------------------

def test_layout_constants_equal_jax():
    names = ("COL_ACTIVE", "COL_FAIL", "COL_MC", "COL_GATHER_CALLS",
             "COL_MAX_UNCONF", "COL_TS_US", "TRAJ_COLS", "TRAJ_FILL",
             "US_MASK", "BK_TRAJ")
    assert {n: getattr(layout, n) for n in names} == \
        {n: getattr(jlayout, n) for n in names}


@pytest.mark.parametrize("max_steps", [0, 1, 7, 4095, 4096, 10 ** 7])
def test_traj_cap_for_equals_jax(max_steps):
    assert tk.traj_cap_for(max_steps) == jk.traj_cap_for(max_steps)
    assert tk.traj_cap_for(max_steps, cap=5) == jk.traj_cap_for(max_steps,
                                                                cap=5)


def test_traj_empty_equals_jax():
    for nb, unconf_b in ((0, False), (3, False), (3, True)):
        np.testing.assert_array_equal(
            tk.traj_empty(9, nb, unconf_b=unconf_b).numpy(),
            np.asarray(jk.traj_empty(9, nb, unconf_b=unconf_b)))


def test_clock_helpers():
    t = devclock.host_clock_us()
    assert 0 <= t <= layout.US_MASK
    assert devclock.kernel_clock_us("cpu") >= 0
    rng = np.random.default_rng(0)
    t0 = rng.integers(0, layout.US_MASK, 50)
    t1 = rng.integers(0, layout.US_MASK, 50)
    np.testing.assert_array_equal(devclock.wrap_delta_us(t0, t1),
                                  jclock.wrap_delta_us(t0, t1))


@pytest.mark.parametrize("unconf", ["none", "scalar", "vector"])
@pytest.mark.parametrize("step", [0, 3, 5, 9])
def test_trajstep_equals_jax_make_trajstep(step, unconf):
    """The plain row write equals ``make_trajstep(True)``'s, a step past
    the buffer dropped."""
    rng = np.random.default_rng(step)
    nb = 3
    ba = rng.integers(0, 100, nb).astype(np.int32)
    u = {"none": None, "scalar": 7,
         "vector": rng.integers(0, 50, nb).astype(np.int32)}[unconf]
    cols = layout.TRAJ_COLS + nb * (2 if unconf == "vector" else 1)
    jbuf = jnp.full((6, cols), -1, jnp.int32)
    ref = np.asarray(jk.make_trajstep(True)(
        jbuf, step, 42, True, mc=5, ba=ba, gcalls=3, unconf=u))
    ours = torch.full((6, cols), -1, dtype=torch.int32)
    tk.trajstep(ours, step, 42, True, mc=5, gcalls=3, ba=ba, unconf=u)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("case", ["empty", "plain", "tail", "unconf",
                                  "timing-wrap", "truncated"])
def test_decoders_equal_jax(case):
    rng = np.random.default_rng(len(case))
    nb = 0 if case in ("empty", "plain") else 2
    unconf_b = case in ("unconf", "timing-wrap", "truncated")
    cols = layout.TRAJ_COLS + nb * (2 if unconf_b else 1)
    buf = np.full((12, cols), -1, np.int32)
    if case != "empty":
        buf[3:9] = rng.integers(0, 1000, (6, cols))
        if case != "timing-wrap":
            buf[3:9, layout.COL_TS_US] = -1
        else:
            buf[5, layout.COL_TS_US] = layout.US_MASK - 3  # wraps at row 6
            buf[6, layout.COL_TS_US] = 10
    steps = 40 if case == "truncated" else 9
    ours = tk.decode_trajectory(buf, steps, unconf_b=unconf_b)
    ref = jk.decode_trajectory(buf, steps, unconf_b=unconf_b)
    assert ours.to_dict() == ref.to_dict()
    assert ours.truncated == (case == "truncated")
    stack = np.stack([buf, np.roll(buf, 2, axis=0), buf])
    a = tk.decode_block_trajectories(stack, [9, 11, 40], 2, unconf_b)
    b = jk.decode_block_trajectories(stack, [9, 11, 40], 2, unconf_b)
    assert [t.to_dict() for t in a] == [t.to_dict() for t in b]


# ---- the ELL and bucketed engines (K2's recording variant) ----------------

@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("engine", ["ell", "bucketed"])
def test_ell_and_bucketed_trajectories_equal_jax(engine, gname):
    g = _graph(gname)
    jcls, tcls = {"ell": (JaxELL, ELLEngine),
                  "bucketed": (JaxBucketed, BucketedELLEngine)}[engine]
    ref_e, ours_e = _rec(jcls(g)), _rec(tcls(_port(g), device="cpu"))
    plain = tcls(_port(g), device="cpu")
    k0 = g.max_degree + 1
    used = ref_e.attempt(k0).colors_used
    for k in (k0, used - 1, 2):  # success, failure, an early failure
        ref, ours = ref_e.attempt(k), ours_e.attempt(k)
        _same(ref, ours)
        t = ours.trajectory
        assert t.first_step + len(t) == ours.supersteps
        assert (t.mc == -1).all() and (t.max_unconf == -1).all()
        assert t.step_us is None and t.bucket_active is None
        off = plain.attempt(k)
        assert off.trajectory is None
        assert (off.status, off.supersteps) == (ours.status, ours.supersteps)
        assert np.array_equal(off.colors, ours.colors)


# ---- the hub-free compact engine (K5, K6; K9 and K10 in a block) ----------

def _compact_pair(gname="uniform", timing=False):
    g = _graph(gname)
    return (_rec(jc.CompactFrontierEngine(g, stages=STAGES[gname]), timing),
            _rec(tc.CompactFrontierEngine(_port(g), device="cpu",
                                          stages=STAGES[gname]), timing))


def test_compact_attempts_and_sweep_equal_jax():
    ref_e, ours_e = _compact_pair()
    g = _graph("uniform")
    k0 = g.max_degree + 1
    ref, ours = ref_e.sweep(k0), ours_e.sweep(k0)
    _same(ref[0], ours[0])
    _same(ref[1], ours[1])
    # the confirm resumed from the ring records from the resume step on
    assert ours_e.resumed_from_step is not None
    assert ours[1].trajectory.first_step == ours_e.resumed_from_step > 1
    t = ours[0].trajectory
    assert t.active[-1] == 0 and ours[1].trajectory.fail[-1] == 1
    assert (t.max_unconf == t.max_unconf_bucket.max(axis=1)).all()
    assert t.bucket_active.shape[1] == len(ours_e.init_bucket_active) == 1
    assert (t.step_us is None) and (ours[1].trajectory.step_us is None)
    for k in (k0, ref[0].colors_used - 1):
        _same(ref_e.attempt(k), ours_e.attempt(k))
    # telemetry off: the same tuples and colors, no trajectory
    plain = tc.CompactFrontierEngine(_port(g), device="cpu",
                                     stages=STAGES["uniform"])
    for a, b in zip(plain.sweep(k0), ours):
        assert a.trajectory is None
        assert (a.k, a.status, a.supersteps) == (b.k, b.status, b.supersteps)
        assert np.array_equal(a.colors, b.colors)


def test_compact_timing_on_both_sides():
    ref_e, ours_e = _compact_pair(timing=True)
    k0 = _graph("uniform").max_degree + 1
    ref, ours = ref_e.sweep(k0), ours_e.sweep(k0)
    for r, o in zip(ref, ours):
        _same(r, o, timing=True)
    # every column but the clock equals the timing-off recording
    _, off_e = _compact_pair()
    for o, f in zip(ours, off_e.sweep(k0)):
        a, b = o.trajectory.to_dict(), f.trajectory.to_dict()
        a.pop("step_us")
        assert a == b


def test_truncated_buffer_equals_jax(monkeypatch):
    """A buffer of fewer rows than the attempt's supersteps keeps the
    first rows and flags ``truncated`` on both sides."""
    for mod in (jc, tc):
        monkeypatch.setattr(mod, "traj_cap_for", lambda m: 4)
    ref_e, ours_e = _compact_pair()
    k0 = _graph("uniform").max_degree + 1
    ref, ours = ref_e.attempt(k0), ours_e.attempt(k0)
    _same(ref, ours)
    assert ours.trajectory.truncated and len(ours.trajectory) == 3


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "jump"])
def test_attempt_block_trajectories_equal_jax(strict):
    """The blocked driver at A = 4 (K9 closes each attempt's span, K10
    starts the next): every attempt's trajectory equals JAX's, resumed
    attempts included."""
    ref_e, ours_e = _compact_pair()
    g = _graph("uniform")
    k0 = 12 if strict else g.max_degree + 1
    ref = jax_find(ref_e, k0, strict_decrement=strict,
                   attempts_per_dispatch=4)
    ours = find_minimal_coloring(ours_e, k0, strict_decrement=strict,
                                 attempts_per_dispatch=4)
    assert len(ours.attempts) == len(ref.attempts) >= 2
    for r, o in zip(ref.attempts, ours.attempts):
        _same(r, o)
    assert any(o.trajectory.first_step > 1 for o in ours.attempts)
    assert np.array_equal(ours.colors, ref.colors)


def test_rmat_compact_sweep_equals_jax():
    """A heavy-tailed graph under the default knobs at test size: every
    bucket flat (no hub), one flat column."""
    ref_e, ours_e = _compact_pair("rmat")
    k0 = _graph("rmat").max_degree + 1
    ref, ours = ref_e.sweep(k0), ours_e.sweep(k0)
    _same(ref[0], ours[0])
    _same(ref[1], ours[1])
