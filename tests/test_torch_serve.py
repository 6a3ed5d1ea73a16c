"""The port's batched serve sweeps (``dgc_tpu_torch.serve.batched``, the
plain versions of K13-K16 on the CPU) against ``dgc_tpu.serve.batched``'s
kernels and against the port's single-graph ``CompactFrontierEngine.sweep``
on the same graphs: uniform and RMAT draws, the full table and a 3-rung
staged ladder, byte for byte. Also: slicing invariance (one superstep a
slice equals the unsliced sweep), a lane reset mid-ladder, and timing on
against off.
"""

import numpy as np
import pytest

from dgc_tpu.serve.batched import batched_sweep_kernel
from dgc_tpu.serve.shape_classes import ShapeClass as JaxShapeClass
from dgc_tpu.serve.shape_classes import dummy_member as jax_dummy
from dgc_tpu.serve.shape_classes import pad_member as jax_pad
from dgc_tpu_torch.engine.compact import CompactFrontierEngine
from dgc_tpu_torch.layout import (CARRY_NC, CARRY_PHASE, CARRY_RUNG, N_OUT,
                                  OUT0, T_PREV, T_US)
from dgc_tpu_torch.models.generators import (generate_random_graph_fast,
                                             generate_rmat_graph)
from dgc_tpu_torch.serve.batched import (batched_slice, batched_sweep,
                                         finish_pair, idle_carry, run_slice,
                                         slice_lanes, stage_idx_width,
                                         to_host)
from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER, ShapeClass,
                                               dummy_member, pad_member)

# a 3-rung ladder valid for the v2048 classes: small graphs cross every
# stage transition in a handful of supersteps
STAGES = ((None, 512), (512, 128), (128, 0))


def _stack(members):
    return (np.stack([m.comb for m in members]),
            np.stack([m.degrees for m in members]),
            np.array([m.k0 for m in members], np.int32),
            np.array([m.max_steps for m in members], np.int32))


def _graphs(kind: str):
    if kind == "uniform":
        return [generate_random_graph_fast(700, avg_degree=8, seed=s)
                for s in range(3)]
    return [generate_rmat_graph(1200, avg_degree=8, seed=s) for s in (5, 6)]


@pytest.fixture(scope="module", params=("uniform", "rmat"))
def batch(request):
    """One class's batch (the graphs and a dummy lane), its inputs, and
    the JAX kernel's outputs with and without the ladder."""
    graphs = _graphs(request.param)
    cls = DEFAULT_LADDER.class_for(max(g.num_vertices for g in graphs),
                                   max(g.max_degree for g in graphs))
    members = [pad_member(g, cls) for g in graphs] + [dummy_member(cls)]
    inputs = _stack(members)
    jcls = JaxShapeClass(cls.v_pad, cls.w_pad)
    jmembers = [jax_pad(g, jcls) for g in graphs] + [jax_dummy(jcls)]
    for a, b in zip(inputs, _stack(jmembers)):
        assert np.array_equal(a, b)   # shape_classes is a verbatim copy
    want = {st: [np.asarray(o) for o in batched_sweep_kernel(
        *inputs, planes=cls.planes, stages=st)] for st in (None, STAGES)}
    return dict(kind=request.param, graphs=graphs, cls=cls, members=members,
                inputs=inputs, want=want)


@pytest.mark.parametrize("stages", (None, STAGES), ids=("full", "staged"))
def test_batched_sweep_equals_jax_kernel(batch, stages):
    got = [to_host(o) for o in batched_sweep(
        *batch["inputs"], planes=batch["cls"].planes, stages=stages,
        device="cpu")]
    for j, (g, w) in enumerate(zip(got, batch["want"][stages])):
        assert g.dtype == np.int32
        assert np.array_equal(g, w), j
    # the staged ladder changes which rows are gathered, never the result
    for a, b in zip(batch["want"][None], batch["want"][STAGES]):
        assert np.array_equal(a, b)


def test_batched_lanes_equal_single_graph_sweeps(batch):
    """The serve bit-identity contract: each lane's pair equals the port's
    single-graph ``CompactFrontierEngine.sweep`` at the same budget."""
    out = [to_host(o) for o in batched_sweep(
        *batch["inputs"], planes=batch["cls"].planes, stages=STAGES,
        device="cpu")]
    for lane, (g, m) in enumerate(zip(batch["graphs"], batch["members"])):
        lane_out = [o[lane] for o in out]
        got = finish_pair(m, *lane_out, attempt_fallback=None)
        want = CompactFrontierEngine(g, device="cpu").sweep(m.k0)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            assert (a.k, a.status, a.supersteps) == (b.k, b.status,
                                                     b.supersteps)
            assert np.array_equal(a.colors, b.colors)


def _slice_loop(inputs, b, planes, steps, stages, timing=False, reset=None,
                carry=None, limit=2000):
    carry = carry if carry is not None else idle_carry(
        b, inputs[1].shape[1], stage_idx_width(stages))
    reset = np.ones(b, np.int32) if reset is None else reset
    rungs = set()
    for _ in range(limit):
        carry = batched_slice(*inputs, reset, carry, planes=planes,
                              slice_steps=steps, stages=stages,
                              timing=timing, device="cpu")
        reset = np.zeros(b, np.int32)
        rungs.update(to_host(carry[CARRY_RUNG]).tolist())
        nc = to_host(carry[CARRY_NC])
        assert (nc >= 0).all() and (nc <= inputs[1].shape[1]).all()
        if (to_host(carry[CARRY_PHASE]) >= 2).all():
            return carry, rungs
    raise AssertionError("slice loop did not converge")


@pytest.mark.parametrize("steps", (1, 5))
def test_slicing_is_result_invariant(batch, steps):
    """Every superstep (or every fifth) a slice boundary, the stage
    transitions and the attempt boundary's rung reset included: the sliced
    staged sweep equals the unsliced one byte for byte; one superstep a
    slice shows it walking the ladder."""
    b = len(batch["members"])
    carry, rungs = _slice_loop(batch["inputs"], b, batch["cls"].planes,
                               steps, STAGES)
    if steps == 1:
        assert {0, 1, 2} <= rungs
    for j in range(N_OUT):
        assert np.array_equal(to_host(carry[OUT0 + j]),
                              batch["want"][STAGES][j]), j


def test_kept_lanes_equal_fresh_slices(batch):
    """The scheduler's way: one set of lanes kept from slice to slice,
    each slice's reset flags written into its tensors. After every slice
    the carry equals a fresh ``batched_slice`` from the same carry, and
    the back buffer equals ``packed`` again."""
    import torch

    b = len(batch["members"])
    planes = batch["cls"].planes
    comb, degrees, k0, max_steps = batch["inputs"]
    carry = idle_carry(b, degrees.shape[1], stage_idx_width(STAGES))
    reset = np.ones(b, np.int32)
    lanes = slice_lanes(comb, degrees, k0, max_steps, reset, carry,
                        planes=planes, stages=STAGES, device="cpu")
    for _ in range(2000):
        want = batched_slice(comb, degrees, k0, max_steps, reset,
                             [to_host(c).copy() for c in carry],
                             planes=planes, slice_steps=3, stages=STAGES,
                             device="cpu")
        lanes.reset.copy_(torch.from_numpy(reset))
        carry = run_slice(lanes, slice_steps=3, staged=True)
        for j, (g, w) in enumerate(zip(carry, want)):
            assert torch.equal(g, w), j
        assert torch.equal(lanes.nxt, carry[2])
        reset = np.zeros(b, np.int32)
        if (to_host(carry[CARRY_PHASE]) >= 2).all():
            break
    else:
        raise AssertionError("slice loop did not converge")
    for j in range(N_OUT):
        assert np.array_equal(to_host(carry[OUT0 + j]),
                              batch["want"][STAGES][j]), j


def test_reset_lane_reinit_mid_ladder():
    """A lane reset while it sits mid-ladder re-initializes to rung 0 and
    sweeps its new graph bit-identically; the co-resident lanes finish
    byte-identical to their own sweeps."""
    cls = ShapeClass(2048, 32)
    graphs = _graphs("uniform")
    members = [pad_member(g, cls) for g in graphs] + [dummy_member(cls)]
    comb, degrees, k0, max_steps = _stack(members)
    new_m = pad_member(generate_random_graph_fast(900, avg_degree=9, seed=77),
                       cls)
    want = [to_host(o) for o in batched_sweep(
        comb, degrees, k0, max_steps, planes=cls.planes, device="cpu")]
    want_new = [to_host(o) for o in batched_sweep(
        new_m.comb[None], new_m.degrees[None],
        np.array([new_m.k0], np.int32),
        np.array([new_m.max_steps], np.int32), planes=cls.planes,
        device="cpu")]
    carry = idle_carry(4, cls.v_pad, stage_idx_width(STAGES))
    reset = np.ones(4, np.int32)
    for _ in range(2000):
        carry = batched_slice(comb, degrees, k0, max_steps, reset, carry,
                              planes=cls.planes, slice_steps=1,
                              stages=STAGES, device="cpu")
        reset = np.zeros(4, np.int32)
        if int(to_host(carry[CARRY_RUNG])[0]) > 0:
            break
    else:
        raise AssertionError("lane 0 never climbed the ladder")
    comb[0], degrees[0] = new_m.comb, new_m.degrees
    k0[0], max_steps[0] = new_m.k0, new_m.max_steps
    carry, _ = _slice_loop((comb, degrees, k0, max_steps), 4, cls.planes, 1,
                           STAGES, reset=np.array([1, 0, 0, 0], np.int32),
                           carry=carry)
    got = [to_host(a) for a in carry[OUT0:OUT0 + N_OUT]]
    for j in range(N_OUT):
        assert np.array_equal(got[j][0], want_new[j][0])
        for lane in (1, 2, 3):
            assert np.array_equal(got[j][lane], want[j][lane])


def test_staged_timing_byte_identical(batch):
    """The clock feeds only the timing slots: the results equal timing
    off, and every lane that swept accumulated some microseconds."""
    b = len(batch["members"])
    outs = {}
    for timing in (False, True):
        outs[timing], _ = _slice_loop(batch["inputs"], b,
                                      batch["cls"].planes, 3, STAGES,
                                      timing=timing)
    for j in range(len(outs[True])):
        if j in (T_US, T_PREV):
            continue
        assert np.array_equal(to_host(outs[False][j]), to_host(outs[True][j]))
    assert (to_host(outs[True][T_US]) >= 0).all()
    assert (to_host(outs[False][T_US]) == 0).all()
