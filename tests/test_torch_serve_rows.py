"""K13 (``lane_superstep``) and K15 (``lane_finish``) under their row
contract, on the CPU: the plain versions walk a row only up to its degree
(``csr_to_ell`` puts a row's real entries first and the sentinel ``V``
after them) and skip a confirmed row, whose ``nxt`` word already holds it
(``nxt`` equals ``packed`` at every K13). Held byte for byte against
``dgc_tpu.serve.batched``: ``batched_sweep_kernel`` on seeded uniform and
mixed-degree requests at widths 8, 32 and 64 (the last a group of two
lanes a row on the card) in a full-table class (v2048) with a dummy lane,
and in a staged class (v32768, one request and a dummy); the slice with
the timing instance of K15 and with the speculation vectors; the lane
mesh's partial K15 (two shards, folded). The scheduler under
``device_carry`` seats, permutes and resizes mid-stream with the invariant
checked before every K13. A table whose degree cuts off a real entry, or
runs past them, is rejected, as is a lane whose ``nxt`` is not its
``packed``. The CUDA kernels are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from dgc_tpu.serve import batched as jb
from dgc_tpu_torch.engine.compact import CompactFrontierEngine
from dgc_tpu_torch.kernels import serve as ks
from dgc_tpu_torch.layout import CARRY_PACKED, T_PREV, T_US
from dgc_tpu_torch.models.generators import (generate_random_graph,
                                             generate_random_graph_fast)
from dgc_tpu_torch.serve import batched as B
from dgc_tpu_torch.serve import engine as se
from dgc_tpu_torch.serve.batched import (batched_slice, batched_sweep,
                                         idle_carry, stage_idx_width,
                                         to_host)
from dgc_tpu_torch.serve.engine import BatchMemberEngine, BatchScheduler
from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER, ShapeClass,
                                               dummy_member, pad_member)

STAGES = ((None, 512), (512, 128), (128, 0))  # a ladder of the v2048 class
WIDE_STAGES = ((None, 8192), (8192, 1024), (1024, 0))  # of v32768


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from contending with the test runner's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(kind: str, w: int, n: int = 3, v: int = 1500):
    if kind == "uniform":
        return [generate_random_graph_fast(v - 150 * i, avg_degree=w // 4 + 1,
                                           seed=10 + i, max_degree=w)
                for i in range(n)]
    # degrees spread from a few to the class width
    return [generate_random_graph(v - 150 * i, w, seed=20 + i)
            for i in range(n)]


def _inputs(graphs, cls, dummies: int = 1):
    members = [pad_member(g, cls) for g in graphs]
    members += [dummy_member(cls)] * dummies
    return (np.stack([m.comb for m in members]),
            np.stack([m.degrees for m in members]),
            np.array([m.k0 for m in members], np.int32),
            np.array([m.max_steps for m in members], np.int32))


def _equal(got, want, skip=()):
    for j, (g, w) in enumerate(zip(got, want)):
        if j not in skip:
            assert np.array_equal(to_host(g), np.asarray(w)), j


@pytest.mark.parametrize("kind,w", (("uniform", 8), ("uniform", 32),
                                    ("mixed", 64)))
def test_full_table_sweep_equals_jax(kind, w):
    cls = ShapeClass(2048, w)
    inputs = _inputs(_graphs(kind, w), cls)
    want = jb.batched_sweep_kernel(*inputs, planes=cls.planes)
    _equal(batched_sweep(*inputs, planes=cls.planes, device="cpu"), want)


def test_staged_class_sweep_equals_jax():
    """A v32768 lane (the class the card stages a lane's state for) and a
    dummy, through a three-rung ladder."""
    cls = ShapeClass(32768, 32)
    graphs = [generate_random_graph_fast(17000, avg_degree=8, seed=3,
                                         max_degree=32)]
    inputs = _inputs(graphs, cls)
    want = jb.batched_sweep_kernel(*inputs, planes=cls.planes,
                                   stages=WIDE_STAGES)
    _equal(batched_sweep(*inputs, planes=cls.planes, stages=WIDE_STAGES,
                         device="cpu"), want)


def _slices(inputs, cls, stages, n, rng, timing=False, armed=False):
    """``n`` slices of two supersteps from an idle carry, the port's and
    the JAX kernel's side by side, lanes reset at random (all first);
    with ``armed`` random spec and cancel vectors."""
    b = inputs[1].shape[0]
    port = jaxc = idle_carry(b, cls.v_pad, stage_idx_width(stages))
    for i in range(n):
        reset = ((rng.random(b) < 0.2) | (i == 0)).astype(np.int32)
        vecs = ((rng.random(b) < 0.5).astype(np.int32),
                (rng.random(b) < 0.3).astype(np.int32)) if armed else (None,
                                                                      None)
        jaxc = jb.batched_slice_kernel(*inputs, reset, tuple(jaxc), *vecs,
                                       planes=cls.planes, slice_steps=2,
                                       stages=stages)
        port = batched_slice(*inputs, reset, [to_host(c) for c in port],
                             *vecs, planes=cls.planes, slice_steps=2,
                             stages=stages, timing=timing, device="cpu")
        _equal(port, jaxc, skip=(T_US, T_PREV) if timing else ())
    return port


@pytest.mark.parametrize("timing,armed", ((True, False), (False, True)),
                         ids=("timing", "spec"))
def test_slices_equal_jax(timing, armed):
    cls = ShapeClass(2048, 32)
    inputs = _inputs(_graphs("mixed", 32, n=2, v=900), cls)
    port = _slices(inputs, cls, STAGES, 8, np.random.default_rng(4), timing,
                   armed)
    if timing:  # the clock moved on the lanes that ran
        assert (to_host(port[T_PREV]) > 0).any()


def test_mesh_partial_finish_equals_jax():
    """Two shards on the CPU: each shard's partial K15, folded by K26."""
    cls = ShapeClass(2048, 32)
    inputs = _inputs(_graphs("uniform", 32), cls)
    want = jb.batched_sweep_kernel(*inputs, planes=cls.planes, stages=STAGES)
    mesh = B.lane_mesh_over(["cpu", "cpu"])
    ks.reset_launch_counts()
    shards = B.batched_sweep_kernel_sharded(mesh, *inputs, planes=cls.planes,
                                            stages=STAGES)
    _equal(B.sharded_home(shards), want)


@pytest.fixture()
def invariant_checked(monkeypatch):
    """Every K13 entry: ``nxt`` equal to ``packed`` in every lane (counted)."""
    calls = []
    real = ks.lane_superstep

    def checked(L):
        assert torch.equal(L.nxt, L.carry[CARRY_PACKED])
        calls.append(L.b)
        return real(L)

    monkeypatch.setattr(ks, "lane_superstep", checked)
    return calls


def test_device_carry_seat_permute_resize(invariant_checked, monkeypatch):
    """Requests into a 4-lane device-carry pool, the first alone: the pool
    seats (K17), grows and shrinks (K18, K19) mid-stream, and each request
    equals its single-graph sweep."""
    moves = {"seat": 0, "permute": 0, "resize": 0}
    for name, fn in (("seat", "seat_lanes"), ("permute", "permute_carry"),
                     ("resize", "resize_inputs")):
        real = getattr(se, fn)

        def counted(*a, real=real, name=name):
            moves[name] += 1
            return real(*a)

        monkeypatch.setattr(se, fn, counted)
    graphs = [generate_random_graph_fast(700 - 60 * i, avg_degree=4 + i % 3,
                                         seed=60 + i) for i in range(5)]
    sched = BatchScheduler(batch_max=4, window_s=0.0, slice_steps=2,
                           device="cpu", device_carry=True).start()
    out = {}

    def run(i, g):
        cls = DEFAULT_LADDER.class_for(g.num_vertices, g.max_degree)
        out[i] = BatchMemberEngine(pad_member(g, cls), sched).sweep(
            g.max_degree + 1)

    try:
        threads = [threading.Thread(target=run, args=(i, g))
                   for i, g in enumerate(graphs)]
        threads[0].start()
        while sched.stats_snapshot()["slices"] < 1:  # lane 0 is live
            time.sleep(0.001)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sched.stop()
    assert all(moves.values()), moves
    assert invariant_checked
    for i, g in enumerate(graphs):
        want = CompactFrontierEngine(g, device="cpu").sweep(g.max_degree + 1)
        for a, b in zip(out[i], want):
            if b is None:
                assert a is None
                continue
            assert (a.k, a.status, a.supersteps) == (b.k, b.status,
                                                     b.supersteps), i
            assert np.array_equal(a.colors, b.colors), i


def _fresh_lanes(inputs, cls):
    b, v = inputs[1].shape
    L = B.slice_lanes(*inputs, np.ones(b, np.int32),
                      idle_carry(b, v, 1), planes=cls.planes, device="cpu")
    L.set_budget(4)
    ks.lane_reset(L)
    return L


@pytest.mark.parametrize("change", ("cut", "past"))
def test_rows_past_their_degree_are_rejected(change):
    """A degree one short of a row's real entries (a real entry cut off),
    or one past them (the sentinel inside the row): K13's plain version
    raises rather than give another result than the full row's."""
    cls = ShapeClass(2048, 8)
    inputs = _inputs(_graphs("uniform", 8, n=1), cls, dummies=0)
    degrees = inputs[1].copy()
    row = int(np.flatnonzero((degrees[0] > 0) & (degrees[0] < 8))[0])
    degrees[0, row] += -1 if change == "cut" else 1
    L = _fresh_lanes((inputs[0], degrees, *inputs[2:]), cls)
    with pytest.raises(ValueError, match="degree"):
        ks.lane_superstep(L)


def test_nxt_unlike_packed_is_rejected():
    cls = ShapeClass(2048, 8)
    L = _fresh_lanes(_inputs(_graphs("uniform", 8, n=1), cls), cls)
    ks.lane_superstep(L)
    ks.lane_finish(L)
    L.nxt[0, 5] = L.nxt[0, 5] + 2  # a row K13 would skip must hold its word
    with pytest.raises(ValueError, match="nxt differs"):
        ks.lane_superstep(L)


def test_confirmed_rows_are_not_walked():
    """Past the first supersteps a lane holds confirmed rows: K13 walks
    only the others, and a confirmed row's nxt word stays its packed
    word."""
    cls = ShapeClass(2048, 8)
    L = _fresh_lanes(_inputs(_graphs("uniform", 8, n=1), cls), cls)
    for _ in range(3):
        ks.lane_superstep(L)
        ks.lane_finish(L)
    pk = L.carry[CARRY_PACKED].clone()
    confirmed = (pk >= 0) & ((pk & 1) == 0)
    assert bool(confirmed[0].any()) and not bool(confirmed[0].all())
    walked = ks._walked_rows(L, 0, 0)
    assert not bool(confirmed[0, walked].any())
    assert len(walked) == int((~confirmed[0]).sum())
    ks.lane_superstep(L)
    assert torch.equal(L.nxt[confirmed], pk[confirmed])
