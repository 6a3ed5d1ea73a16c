"""The serve kernels' plain versions (``dgc_tpu_torch.kernels.serve``:
K16 ``lane_reset``, K14 ``lane_compact``, K13 ``lane_superstep``, K15
``lane_finish``) against the JAX bodies they port
(``dgc_tpu.serve.batched._fresh_lanes``, ``_superstep_body``,
``_slice_kernel``), on seeded random carries: all 20 carry slots equal,
byte for byte (the two clock slots by rule under timing).

The cases cover lanes in every phase (first attempt, confirm, done,
idle), dead and reset lanes, lanes at different rungs and slot lists, a
forced staged rung, budgets and ``max_steps`` that end attempts, and
windows of 1 to 3 planes. The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py`` (phase 1, serve kernels).
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from dgc_tpu.engine.bucketed import initial_packed
from dgc_tpu.serve import batched as jb
from dgc_tpu_torch.kernels import serve as ks
from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_LEN, CARRY_PHASE,
                                  CARRY_RUNG, T_PREV, T_US, US_MASK)
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.serve.batched import batched_slice, resolve_stages, to_host

V = 256
# a 3-rung ladder valid for V = 256 (pads 128 and 32)
STAGES = ((None, 128), (128, 32), (32, 0))
CASES = (  # (name, lanes, width, stages)
    ("b1_w8", 1, 8, STAGES),
    ("b3_w8", 3, 8, STAGES),
    ("b8_w8", 8, 8, STAGES),
    ("b3_w64", 3, 64, STAGES),
    ("b3_w8_full", 3, 8, None),
)


def _words(rng, shape, colors: int, uncolored: float) -> np.ndarray:
    words = rng.integers(0, colors, size=shape) * 2 + rng.integers(0, 2, size=shape)
    return np.where(rng.random(shape) < uncolored, -1, words).astype(np.int32)


def random_case(seed: int, b: int, w: int, stages, staged: bool = False):
    """Seeded inputs and carry: ``(comb, degrees, k0, max_steps, carry)``,
    numpy, with random slot lists (sorted real rows, then the dummy V)."""
    rng = np.random.default_rng(seed)
    stages, pads, a0 = resolve_stages(stages, V)
    n = len(stages)
    degrees = rng.integers(0, w + 1, size=(b, V)).astype(np.int32)
    degrees[rng.random((b, V)) < 0.2] = 0
    # a row's degree real entries first, the pad sentinel V after them
    # (csr_to_ell's layout, which K13 walks up to the degree)
    nbr = rng.integers(0, V, size=(b, V, w))
    nbr[np.arange(w)[None, None, :] >= degrees[:, :, None]] = V
    comb = (nbr | rng.integers(0, 2, size=(b, V, w)) << 30).astype(np.int32)
    k = rng.integers(1, w + 2, size=b)
    step = rng.integers(1, 40, size=b)
    max_steps = rng.integers(2, 2 * V + 4, size=b)
    clamp = rng.random(b) < 0.25               # this step hits max_steps
    max_steps[clamp] = step[clamp] + 1
    idx = np.full((b, a0), V, np.int32)
    for lane in range(b):
        m = int(rng.integers(0, min(a0, V) + 1))
        idx[lane, :m] = np.sort(rng.choice(V, size=m, replace=False))
    rung = rng.integers(1 if staged and n > 1 else 0, n, size=b)
    carry = [
        rng.choice([0, 1, 2, 3], size=b, p=[0.4, 0.3, 0.2, 0.1]),
        k,
        _words(rng, (b, V), w + 4, 0.3),
        step,
        rng.integers(0, V + 2, size=b),
        rng.integers(0, 70, size=b),
        _words(rng, (b, V), w + 4, 0.1),
        rng.integers(0, 50, size=b),
        rng.integers(0, 4, size=b),
        rng.integers(0, w + 2, size=b),
        _words(rng, (b, V), w + 4, 0.1),
        rng.integers(0, 50, size=b),
        rng.integers(0, 4, size=b),
        rng.integers(0, 10_000, size=b),
        np.where(rng.random(b) < 0.5, 0, rng.integers(1, US_MASK, size=b)),
        rung,
        rng.integers(0, V + 1, size=b),
        rng.integers(0, n, size=b),
        idx,
        (rng.random(b) < 0.15).astype(np.int32),
    ]
    carry = [np.asarray(c, np.int32) for c in carry]
    return comb, degrees, k.astype(np.int32), max_steps.astype(np.int32), carry


def _lanes(comb, degrees, k0, max_steps, reset, carry, stages, w, budget):
    stages, _pads, _a0 = resolve_stages(stages, V)
    t = lambda x: torch.tensor(np.asarray(x, np.int32))
    return ks.new_lanes([t(c) for c in carry], t(comb), t(degrees), t(k0),
                        t(max_steps), t(reset), ks.ladder_ctrl(stages, "cpu"),
                        planes=num_planes_for(w + 1), stall_window=64,
                        budget=budget)


def _port_superstep(comb, degrees, k0, max_steps, carry, stages, w):
    """One batched superstep of the plain versions from ``carry``: K16
    with no lane flagged (it only seeds the buffers and the routing),
    then K14, K13, K15."""
    b = degrees.shape[0]
    L = _lanes(comb, degrees, k0, max_steps, np.zeros(b), carry, stages, w,
               budget=1)
    ks.lane_reset(L)
    if any(s is not None for s, _ in resolve_stages(stages, V)[0]):
        ks.lane_compact(L)
    ks.lane_superstep(L)
    ks.lane_finish(L)
    assert L.ctrl[ks.CTRL_LIVE] == 0  # the budget of one step is spent
    return [to_host(c) for c in L.carry], L


@pytest.fixture(scope="module")
def jax_body():
    cache = {}

    def body(b, w, stages):
        key = (b, w, stages)
        if key not in cache:
            st, pads, a0 = jb._resolve_stages(stages, V)
            cache[key] = jax.jit(partial(
                jb._superstep_body, v=V, planes=num_planes_for(w + 1),
                stall_window=64, stages=st, pads=pads, a0=a0))
        return cache[key]
    return body


@pytest.mark.parametrize("name,b,w,stages", CASES, ids=[c[0] for c in CASES])
def test_superstep_plain_versions_equal_superstep_body(jax_body, name, b, w,
                                                       stages):
    routed = set()
    for seed in range(4):
        comb, degrees, k0, max_steps, carry = random_case(
            seed, b, w, stages, staged=seed % 2 == 1)
        want = jax_body(b, w, stages)(tuple(carry), comb,
                                      initial_packed(degrees), max_steps)
        got, L = _port_superstep(comb, degrees, k0, max_steps, carry, stages, w)
        for j in range(CARRY_LEN):
            assert np.array_equal(got[j], np.asarray(want[j])), (seed, j)
        routed.add(int(L.ctrl[ks.CTRL_REXEC]))
        assert int(L.scratch[ks.SCR_MAXC].max()) == -1  # counters cleared
        live = carry[CARRY_PHASE] < 2
        # every lane's back buffer equals its state again
        assert torch.equal(L.nxt, L.carry[2]) or not live.any()
    if stages is not None:
        assert routed - {0}, "no case ran a staged rung"


def test_forced_staged_rung_rebuilds_the_slot_lists():
    """A staged rung with every live lane's list built shallower: K14
    rebuilds each (the first ``pad`` active rows in order, the dummy V
    after them) and leaves a dead lane's list alone."""
    comb, degrees, k0, max_steps, carry = random_case(11, 4, 8, STAGES,
                                                      staged=True)
    carry[CARRY_PHASE][:] = [0, 1, 0, 2]
    carry[CARRY_RUNG][:] = 2
    carry[17][:] = 0                       # idx_rung: built at rung 0
    b = 4
    L = _lanes(comb, degrees, k0, max_steps, np.zeros(b), carry, STAGES, 8, 1)
    ks.lane_reset(L)
    assert int(L.ctrl[ks.CTRL_REXEC]) == 2
    ks.lane_compact(L)
    idx = to_host(L.carry[CARRY_IDX])
    for lane in range(3):
        pk = carry[2][lane]
        act = np.flatnonzero((pk < 0) | ((pk & 1) == 1))[:32]
        assert np.array_equal(idx[lane, :len(act)], act)
        assert (idx[lane, len(act):] == V).all()
    assert np.array_equal(idx[3], carry[CARRY_IDX][3])   # a dead lane
    assert to_host(L.carry[17]).tolist() == [2, 2, 2, 0]


@pytest.mark.parametrize("b", (1, 4))
def test_lane_reset_equals_fresh_lanes(b):
    comb, degrees, k0, max_steps, carry = random_case(5, b, 8, STAGES)
    _st, _pads, a0 = resolve_stages(STAGES, V)
    want = jb._fresh_lanes(degrees, k0, a0)
    L = _lanes(comb, degrees, k0, max_steps, np.ones(b), carry, STAGES, 8, 4)
    ks.lane_reset(L)
    for j in range(CARRY_LEN):
        assert np.array_equal(to_host(L.carry[j]), np.asarray(want[j])), j
    assert torch.equal(L.nxt, L.carry[2])
    assert L.scratch.tolist() == [[0] * b, [0] * b, [-1] * b]


@pytest.fixture(scope="module")
def jax_slices():
    cache = {}

    def run(steps, timing, case):
        comb, degrees, k0, max_steps, reset, carry = case
        key = (steps, timing)
        if key not in cache:
            cache[key] = jax.jit(partial(
                jb._slice_kernel, planes=num_planes_for(9), slice_steps=steps,
                stall_window=64, timing=timing, stages=STAGES))
        return [np.asarray(x) for x in
                cache[key](comb, degrees, k0, max_steps, reset, tuple(carry))]
    return run


@pytest.mark.parametrize("steps", (1, 3))
def test_slice_with_reset_lanes_equals_slice_kernel(jax_slices, steps):
    """K16's select of the flagged lanes and the slice's rounds against
    ``_slice_kernel``, timing on and off: every slot but the clock equal,
    and equal between timing on and off."""
    comb, degrees, k0, max_steps, carry = random_case(21 + steps, 4, 8,
                                                      STAGES)
    carry[13][:] = 0                # the accumulators start at 0
    reset = np.array([1, 0, 1, 0], np.int32)
    outs = {}
    for timing in (False, True):
        want = jax_slices(steps, timing,
                          (comb, degrees, k0, max_steps, reset, carry))
        got = [to_host(x) for x in batched_slice(
            comb, degrees, k0, max_steps, reset, [c.copy() for c in carry],
            planes=num_planes_for(9), slice_steps=steps, timing=timing,
            stages=STAGES, device="cpu")]
        for j in range(CARRY_LEN):
            if timing and j in (T_US, T_PREV):
                continue
            assert np.array_equal(got[j], want[j]), (timing, j)
        outs[timing] = got
        if timing:
            # the clock: fresh and live lanes hold a masked reading, as
            # the JAX kernel's; lanes it left alone are left alone
            moved = want[T_PREV] != carry[T_PREV]
            assert np.array_equal(got[T_PREV] != carry[T_PREV], moved)
            assert ((got[T_PREV] >= 0) & (got[T_PREV] <= US_MASK)).all()
            assert np.array_equal(got[T_US][~moved], want[T_US][~moved])
    for j in range(CARRY_LEN):
        if j not in (T_US, T_PREV):
            assert np.array_equal(outs[False][j], outs[True][j]), j


def test_cpu_wrappers_count_no_launches():
    ks.reset_launch_counts()
    comb, degrees, k0, max_steps, carry = random_case(3, 2, 8, STAGES)
    batched_slice(comb, degrees, k0, max_steps, np.ones(2, np.int32), carry,
                  planes=1, slice_steps=4, stages=STAGES, device="cpu",
                  timing=True)
    assert set(ks.launch_counts.values()) == {0}
    assert set(ks.timing_launch_counts.values()) == {0}


def test_ladder_ctrl_layout():
    ctrl = ks.ladder_ctrl(((None, 100), (60, 20), (17, 0)), "cpu").tolist()
    assert len(ctrl) == ks.CTRL_LEN
    assert ctrl[ks.CTRL_NSTAGES] == 3
    assert ctrl[ks.CTRL_THRESH0:ks.CTRL_THRESH0 + 3] == [100, 20, 0]
    assert ctrl[ks.CTRL_PAD0:ks.CTRL_PAD0 + 3] == [0, 64, 32]
    with pytest.raises(ValueError):
        ks.ladder_ctrl(((None, 0),) * 9, "cpu")
