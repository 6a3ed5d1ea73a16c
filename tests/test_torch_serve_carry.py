"""The serve tier's device-resident carry (``--device-carry``): the plain
versions of K17 ``lane_seat``, K18 ``carry_permute`` and K19
``inputs_resize`` (``dgc_tpu_torch.kernels.carry``, through the
``serve.batched`` wrappers) against ``dgc_tpu.serve.batched``'s
``seat_lane_kernel``, ``permute_carry_kernel`` and
``resize_inputs_kernel`` on seeded random stacks and carries, exact (all
int32); and the port's scheduler with ``device_carry=True`` against its
host-mirror run on the CPU, request by request, with the transfer
accounting of each slice. The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py`` (phase 1).
"""

import threading
import time

import numpy as np
import pytest
import torch

from dgc_tpu.serve import batched as jb
from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                            make_reducer, make_validator)
from dgc_tpu_torch.kernels import carry as kcar
from dgc_tpu_torch.layout import CARRY_LEN
from dgc_tpu_torch.models.generators import generate_random_graph_fast
from dgc_tpu_torch.serve.batched import (idle_carry, permute_carry,
                                         resize_inputs, seat_lanes, to_host)
from dgc_tpu_torch.serve.engine import BatchMemberEngine, BatchScheduler
from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER, pad_member

V = 2048  # the v2048 classes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from contending with the test runner's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stacks(rng, b: int, w: int):
    comb = rng.integers(-(1 << 31), 1 << 31, size=(b, V, w), dtype=np.int64)
    return (comb.astype(np.int32),
            rng.integers(0, w + 1, size=(b, V)).astype(np.int32),
            rng.integers(1, w + 2, size=b).astype(np.int32),
            rng.integers(4, 2 * V + 4, size=b).astype(np.int32),
            (rng.random(b) < 0.5).astype(np.int32))


def _carry(rng, b: int, a0: int) -> list:
    return [rng.integers(-5, 1 << 20,
                         size=(b, a0) if j == 18 else
                         (b, V) if j in (2, 6, 10) else (b,)).astype(np.int32)
            for j in range(CARRY_LEN)]


def _t(stacks):
    return [torch.from_numpy(np.array(x)) for x in stacks]


SEAT_CASES = (  # (width, lanes, seat lanes in order)
    (8, 1, (0,)),
    (8, 4, (2,)),
    (8, 4, (0, 1, 2, 3)),
    (16, 8, (5, 1, 5, 7)),          # a lane seated twice: the last wins
    (16, 8, tuple(range(8))),
)


@pytest.mark.parametrize("w,b,lanes", SEAT_CASES)
def test_lane_seat_equals_seat_lane_kernel(w, b, lanes):
    rng = np.random.default_rng(100 + b + w)
    stacks = _stacks(rng, b, w)
    seats = [(lane, rng.integers(0, 1 << 30, size=(V, w)).astype(np.int32),
              rng.integers(0, w + 1, size=V).astype(np.int32),
              int(rng.integers(1, w + 2)), int(rng.integers(4, 4000)))
             for lane in lanes]
    want = tuple(stacks)
    for lane, m_comb, m_deg, k, ms in seats:
        want = jb.seat_lane_kernel(*want, np.int32(lane), m_comb, m_deg,
                                   np.int32(k), np.int32(ms))
    got = _t(stacks)
    nbytes = seat_lanes(got, seats)
    for j, (g, x) in enumerate(zip(got, want)):
        assert np.array_equal(to_host(g), np.asarray(x)), j
    # one lane's rows and its three scalars a seat go up
    assert nbytes == len(seats) * (V * w + V + 3) * 4


PERMUTE_CASES = (  # (old lanes, new lanes, kept old lanes in order)
    (1, 1, ()),
    (1, 2, (0,)),                   # grow x2, keep all
    (4, 8, (3, 0)),                 # grow x2, keep some, src out of order
    (8, 2, (6, 1)),                 # shrink /4
    (8, 8, (7, 6, 5, 4, 3, 2, 1, 0)),  # keep all, reversed
    (8, 4, ()),                     # keep none
)


@pytest.mark.parametrize("b_old,b_new,keep", PERMUTE_CASES)
def test_carry_permute_equals_permute_carry_kernel(b_old, b_new, keep):
    rng = np.random.default_rng(7 * b_old + b_new)
    a0 = 512
    old = _carry(rng, b_old, a0)
    src = np.asarray(keep, np.int32)
    dst = np.arange(len(keep), dtype=np.int32)
    want = jb.permute_carry_kernel(tuple(old), idle_carry(b_new, V, a0),
                                   src, dst)
    got = permute_carry([torch.from_numpy(c) for c in old], keep, b_new)
    for j in range(CARRY_LEN):
        assert got[j].dtype == torch.int32
        assert np.array_equal(to_host(got[j]), np.asarray(want[j])), j
    # a scattered destination order, straight through the kernel wrapper
    if len(keep) > 1:
        dst = rng.permutation(b_new)[:len(keep)].astype(np.int32)
        want = jb.permute_carry_kernel(tuple(old), idle_carry(b_new, V, a0),
                                       src, dst)
        got = kcar.carry_permute([torch.from_numpy(c) for c in old],
                                 list(keep), dst.tolist(), b_new)
        for j in range(CARRY_LEN):
            assert np.array_equal(to_host(got[j]), np.asarray(want[j])), j


RESIZE_CASES = (  # (width, old lanes, source of each new row)
    (8, 1, (0, 1)),                 # grow: the new row is the dummy
    (8, 4, (2, 0, 4, 4, 4, 4, 4, 4)),
    (16, 8, (7, 3)),                # shrink
    (16, 2, (9, 1, 0, 2)),          # past the width by more than one
)


@pytest.mark.parametrize("w,b_old,src", RESIZE_CASES)
def test_inputs_resize_equals_resize_inputs_kernel(w, b_old, src):
    rng = np.random.default_rng(300 + w + b_old)
    stacks = _stacks(rng, b_old, w)
    dummy = rng.integers(0, 1 << 30, size=(V, w)).astype(np.int32)
    want = jb.resize_inputs_kernel(*stacks[:4], np.asarray(src, np.int32),
                                   dummy, np.zeros(V, np.int32), np.int32(1),
                                   np.int32(777))
    got = resize_inputs(_t(stacks), src, torch.from_numpy(dummy), 777)
    for j, (g, x) in enumerate(zip(got, want)):
        assert np.array_equal(to_host(g), np.asarray(x)), j


def _graphs():
    return [generate_random_graph_fast(1100 - 130 * i, avg_degree=5 + i % 3,
                                       seed=40 + i) for i in range(7)]


def _serve(graphs, device_carry: bool):
    """The graphs through a 4-lane scheduler on the CPU (the first alone,
    the rest a moment later, so the pool grows from 1 live lane and
    shrinks as it drains); returns each graph's (attempt tuples, colors)
    and the slice events."""
    events = []
    sched = BatchScheduler(batch_max=4, window_s=0.0, slice_steps=2,
                           device="cpu", device_carry=device_carry,
                           on_event=lambda kind, rec: events.append(
                               (kind, rec))).start()
    out = {}

    def run(i, g):
        cls = DEFAULT_LADDER.class_for(g.num_vertices, g.max_degree)
        attempts = []
        res = find_minimal_coloring(
            BatchMemberEngine(pad_member(g, cls), sched),
            initial_k=g.max_degree + 1, validate=make_validator(g),
            on_attempt=lambda r, v: attempts.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(g))
        out[i] = (attempts, res.colors)

    try:
        threads = [threading.Thread(target=run, args=(i, g))
                   for i, g in enumerate(graphs)]
        threads[0].start()
        while sched.stats_snapshot()["slices"] < 1:   # lane 0 is live
            time.sleep(0.001)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sched.stop()
    return out, [rec for kind, rec in events if kind == "serve_slice"]


@pytest.fixture(scope="module")
def served():
    """Both runs, and each device-carry resize's (kept lanes, new width)."""
    from dgc_tpu_torch.serve import engine as se

    graphs = _graphs()
    resizes, permute = [], se.permute_carry

    def counted(carry, keep, b_new):
        resizes.append((len(keep), b_new))
        return permute(carry, keep, b_new)

    se.permute_carry = counted
    try:
        runs = {dc: _serve(graphs, dc) for dc in (False, True)}
    finally:
        se.permute_carry = permute
    return graphs, runs, resizes


def test_device_carry_equals_host_mirror(served):
    graphs, runs, resizes = served
    host, device = runs[False][0], runs[True][0]
    assert sorted(host) == sorted(device) == list(range(len(graphs)))
    for i in host:
        assert device[i][0] == host[i][0], i
        assert np.array_equal(device[i][1], host[i][1]), i
    # the device-carry pools grew and shrank with live lanes kept on the
    # device (K18/K19), pending seats re-seated after a growth
    widths = {rec["b_pad"] for rec in runs[True][1]}
    assert len(widths) > 1 and max(widths) > 1
    assert any(kept and b_new > kept for kept, b_new in resizes), resizes
    assert any(0 < b_new < 4 and kept for kept, b_new in resizes)


def test_device_carry_transfer_accounting(served):
    """Each device-carry slice brings home the three scheduling scalars a
    lane and (2·V_pad + 5) words per finished lane; a slice that seated
    nothing and did not resize uploads nothing. The host mirror brings the
    whole carry home on a slice where a lane finished."""
    _graphs_, runs, _resizes = served
    v_pad = 2048
    moved = 0
    for rec in runs[True][1]:
        assert rec["d2h_bytes"] == (3 * rec["b_pad"]
                                    + rec["done"] * (2 * v_pad + 5)) * 4
        moved += rec["h2d_bytes"]
    quiet = []
    for cls in {rec["shape_class"] for rec in runs[True][1]}:
        recs = [rec for rec in runs[True][1] if rec["shape_class"] == cls]
        quiet += [rec for prev, rec in zip(recs, recs[1:])
                  if rec["admitted"] == 0 and rec["b_pad"] == prev["b_pad"]]
    assert quiet and all(rec["h2d_bytes"] == 0 for rec in quiet)
    host_d2h = sum(rec["d2h_bytes"] for rec in runs[False][1])
    assert sum(rec["d2h_bytes"] for rec in runs[True][1]) < host_d2h
    assert 0 < moved < sum(rec["h2d_bytes"] for rec in runs[False][1])
