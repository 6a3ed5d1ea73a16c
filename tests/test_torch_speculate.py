"""Speculative minimal-k on the port (``dgc_tpu_torch.serve.speculate``
over the scheduler's speculation plane and K15/K16's spec and cancel
vectors), on the CPU, exact (all int32):

- the plain K15/K16 under random spec tags, cancel bits and reset flags
  against ``dgc_tpu.serve.batched.batched_slice_kernel(..., spec,
  cancel)``: every carry slot after every slice, full table and a 3-rung
  ladder (reset beats cancel, a cancelled spec-free or dead lane is left
  alone, a killed lane is frozen);
- ``SpeculativeMinimalKEngine`` at depths 1-3 (and the A/B's sequential
  arm, ``ServeSequentialMinimalKEngine``) against the port's sequential
  strict driver on uniform and RMAT graphs, attempt for attempt, and one
  graph against ``dgc_tpu``'s ``SpeculativeMinimalKEngine``;
- jump mode inert, ``close`` cancelling the window, real requests
  preempting speculative lanes, the front end's ``speculate_k``;
- ``auto_depth`` and the priced cap equal to ``dgc_tpu``'s for k0 in
  1..4096;
- ``python -m dgc_tpu_torch --strict-decrement --speculate-k 3 --device
  cpu`` writing the plain strict run's coloring JSON.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dgc_tpu.serve import batched as jb
from dgc_tpu.serve import speculate as jspec
from dgc_tpu.utils import schedule_model as jsm
from dgc_tpu_torch.engine.compact import CompactFrontierEngine
from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                            make_reducer, make_validator)
from dgc_tpu_torch.layout import CARRY_LEN, CARRY_PHASE, CARRY_SPEC
from dgc_tpu_torch.models.generators import (generate_random_graph_fast,
                                             generate_rmat_graph)
from dgc_tpu_torch.serve.batched import (batched_slice, idle_carry,
                                         stage_idx_width, to_host)
from dgc_tpu_torch.serve.engine import BatchMemberEngine, BatchScheduler
from dgc_tpu_torch.serve.queue import ServeFrontEnd
from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER, ShapeClass,
                                               dummy_member, pad_member)
from dgc_tpu_torch.serve.speculate import (ServeSequentialMinimalKEngine,
                                           SpeculativeMinimalKEngine,
                                           auto_depth)
from dgc_tpu_torch.utils import schedule_model as sm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from contending with the test runner's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- K15/K16 with the speculation vectors against the JAX slice -------------

# a 3-rung ladder valid for V = 256 (pads 128 and 32)
STAGES = ((None, 128), (128, 32), (32, 0))


@pytest.mark.parametrize("stages", (None, STAGES), ids=("full", "staged"))
def test_spec_cancel_slices_equal_jax(stages):
    cls = ShapeClass(256, 16)
    graphs = [generate_random_graph_fast(150 + 20 * i, avg_degree=4 + i % 3,
                                         seed=20 + i) for i in range(5)]
    members = [pad_member(g, cls) for g in graphs] + [dummy_member(cls)]
    comb = np.stack([m.comb for m in members])
    degrees = np.stack([m.degrees for m in members])
    k0 = np.array([m.k0 for m in members], np.int32)
    max_steps = np.array([m.max_steps for m in members], np.int32)
    b = len(members)
    rng = np.random.default_rng(5 if stages is None else 6)
    port = jaxc = idle_carry(b, cls.v_pad, stage_idx_width(stages))
    kinds = {"killed": 0, "reset_beats_cancel": 0, "spec_free": 0}
    for n in range(14):
        reset = ((rng.random(b) < 0.3) | (n == 0)).astype(np.int32)
        spec = (rng.random(b) < 0.6).astype(np.int32)
        cancel = (rng.random(b) < 0.35).astype(np.int32)
        before = [np.array(to_host(c)) for c in port]
        live = before[CARRY_PHASE] < 2
        tagged = before[CARRY_SPEC] != 0
        fresh = reset != 0
        kinds["killed"] += int((cancel.astype(bool) & tagged & live
                                & ~fresh).sum())
        kinds["reset_beats_cancel"] += int((cancel.astype(bool) & fresh
                                            & spec.astype(bool)).sum())
        kinds["spec_free"] += int((cancel.astype(bool) & ~tagged & live
                                   & ~fresh).sum())
        jaxc = jb.batched_slice_kernel(
            comb, degrees, k0, max_steps, reset, tuple(jaxc), spec, cancel,
            planes=cls.planes, slice_steps=3, stages=stages)
        port = batched_slice(comb, degrees, k0, max_steps, reset, before,
                             spec, cancel, planes=cls.planes, slice_steps=3,
                             stages=stages, device="cpu")
        for j in range(CARRY_LEN):
            assert np.array_equal(to_host(port[j]), np.asarray(jaxc[j])), \
                (n, j)
    assert all(v > 0 for v in kinds.values()), kinds


# ---- the speculative strict chain against the sequential one ----------------

def _graphs():
    uniform = [generate_random_graph_fast(260 + 70 * i, avg_degree=5 + i,
                                          seed=100 + i) for i in range(3)]
    rmat = [generate_rmat_graph(160 + 20 * i, avg_degree=2, seed=200 + i)
            for i in range(2)]
    return uniform + rmat


def _sequential(g):
    attempts = []
    res = find_minimal_coloring(
        CompactFrontierEngine(g, device="cpu"), initial_k=g.max_degree + 1,
        strict_decrement=True, validate=make_validator(g),
        on_attempt=lambda r, v: attempts.append(
            (int(r.k), r.status.name, int(r.supersteps))),
        post_reduce=make_reducer(g))
    return res, attempts


def _strict(engine, g):
    attempts = []
    try:
        res = find_minimal_coloring(
            engine, initial_k=engine.member.k0, strict_decrement=True,
            validate=make_validator(g),
            on_attempt=lambda r, v: attempts.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(g))
    finally:
        close = getattr(engine, "close", None)
        if close is not None:
            close()
    return res, attempts


@pytest.fixture(scope="module")
def scheduler():
    sched = BatchScheduler(batch_max=4, window_s=0.0, slice_steps=4,
                           device="cpu").start()
    yield sched
    sched.stop()


@pytest.mark.parametrize("i", range(5), ids=("u0", "u1", "u2", "r0", "r1"))
def test_speculative_strict_equals_sequential(scheduler, i):
    g = _graphs()[i]
    want, want_attempts = _sequential(g)
    assert len(want_attempts) > 2
    member = pad_member(g, DEFAULT_LADDER.class_for(g.num_vertices,
                                                    g.max_degree))
    # the A/B's sequential arm on the uniform graphs (the RMAT chains are
    # long)
    runs = [SpeculativeMinimalKEngine(member, scheduler, depth=d)
            for d in (1, 2, 3)]
    if i < 3:
        runs.append(ServeSequentialMinimalKEngine(member, scheduler))
    for engine in runs:
        got, got_attempts = _strict(engine, g)
        assert got_attempts == want_attempts, type(engine).__name__
        assert got.minimal_colors == want.minimal_colors
        assert np.array_equal(got.colors, want.colors)
    assert all(e.spec_stats["claims"] > 0 for e in runs[:3])
    assert scheduler.stats_snapshot()["spec_wins"] > 0


def test_speculative_strict_equals_dgc_tpu():
    from dgc_tpu.engine.minimal_k import find_minimal_coloring as jfind
    from dgc_tpu.engine.minimal_k import make_reducer as jreducer
    from dgc_tpu.engine.minimal_k import make_validator as jvalidator
    from dgc_tpu.serve.engine import BatchScheduler as JaxScheduler
    from dgc_tpu.serve.shape_classes import DEFAULT_LADDER as JAX_LADDER
    from dgc_tpu.serve.shape_classes import pad_member as jax_pad

    g = _graphs()[0]
    jsched = JaxScheduler(batch_max=3, window_s=0.0, slice_steps=4).start()
    want_attempts = []
    try:
        jeng = jspec.SpeculativeMinimalKEngine(
            jax_pad(g, JAX_LADDER.class_for(g.num_vertices, g.max_degree)),
            jsched, depth=2)
        try:
            want = jfind(jeng, initial_k=jeng.member.k0,
                         strict_decrement=True, validate=jvalidator(g),
                         on_attempt=lambda r, v: want_attempts.append(
                             (int(r.k), r.status.name, int(r.supersteps))),
                         post_reduce=jreducer(g))
        finally:
            jeng.close()
    finally:
        jsched.stop()
    sched = BatchScheduler(batch_max=3, window_s=0.0, slice_steps=4,
                           device="cpu", device_carry=True).start()
    try:
        got, got_attempts = _strict(SpeculativeMinimalKEngine(
            pad_member(g, DEFAULT_LADDER.class_for(g.num_vertices,
                                                   g.max_degree)),
            sched, depth=2), g)
    finally:
        sched.stop()
    assert got_attempts == want_attempts
    assert got.minimal_colors == want.minimal_colors
    assert np.array_equal(got.colors, np.asarray(want.colors))


def test_jump_mode_is_inert(scheduler):
    g = _graphs()[1]
    events = []
    sched = BatchScheduler(batch_max=4, window_s=0.0, device="cpu",
                           on_event=lambda k, r: events.append(k)).start()
    try:
        member = pad_member(g, DEFAULT_LADDER.class_for(g.num_vertices,
                                                        g.max_degree))
        engine = SpeculativeMinimalKEngine(member, sched, depth=3)
        try:
            got = find_minimal_coloring(engine, initial_k=member.k0,
                                        validate=make_validator(g),
                                        post_reduce=make_reducer(g))
        finally:
            engine.close()
        want = find_minimal_coloring(CompactFrontierEngine(g, device="cpu"),
                                     initial_k=g.max_degree + 1,
                                     validate=make_validator(g),
                                     post_reduce=make_reducer(g))
        assert np.array_equal(got.colors, want.colors)
        assert engine.spec_stats["speculated"] == 0
        assert sched.stats_snapshot()["spec_seated"] == 0
        assert not any(k.startswith("spec_") for k in events)
    finally:
        sched.stop()


def test_close_cancels_the_window():
    g = _graphs()[2]
    sched = BatchScheduler(batch_max=4, window_s=0.0, slice_steps=1,
                           device="cpu").start()
    try:
        member = pad_member(g, DEFAULT_LADDER.class_for(g.num_vertices,
                                                        g.max_degree))
        engine = SpeculativeMinimalKEngine(member, sched, depth=3)
        engine.attempt(member.k0)   # seeds the window below k0
        assert engine._window
        engine.close()
        assert not engine._window
        assert sched.stats_snapshot()["spec_cancelled"] >= 1
        deadline = time.time() + 60
        while any(p.live for p in sched._pools.values()):
            assert time.time() < deadline, "a cancelled lane stayed live"
            time.sleep(0.005)
    finally:
        sched.stop()


@pytest.mark.parametrize("device_carry", (False, True),
                         ids=("host", "device_carry"))
def test_real_requests_preempt_speculative_lanes(device_carry):
    slow = generate_random_graph_fast(900, avg_degree=12, seed=50)
    cls = DEFAULT_LADDER.class_for(slow.num_vertices, slow.max_degree)
    sched = BatchScheduler(batch_max=2, window_s=0.0, slice_steps=1,
                           device="cpu", device_carry=device_carry).start()
    try:
        member = pad_member(slow, cls)
        calls = [sched.speculate(member, member.k0 - 1 - i) for i in range(2)]
        deadline = time.time() + 60
        while sched.stats_snapshot()["spec_seated"] < 1:
            assert time.time() < deadline
            time.sleep(0.002)
        real = [generate_random_graph_fast(300 + 40 * i, avg_degree=5,
                                           seed=60 + i) for i in range(3)]
        results = {}

        def run(i, g):
            eng = BatchMemberEngine(pad_member(g, cls), sched)
            results[i] = find_minimal_coloring(
                eng, initial_k=eng.member.k0, validate=make_validator(g),
                post_reduce=make_reducer(g))

        threads = [threading.Thread(target=run, args=(i, g))
                   for i, g in enumerate(real)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert len(results) == 3
        for i, g in enumerate(real):
            want = find_minimal_coloring(
                CompactFrontierEngine(g, device="cpu"),
                initial_k=g.max_degree + 1, validate=make_validator(g),
                post_reduce=make_reducer(g))
            assert np.array_equal(results[i].colors, want.colors)
        assert sched.stats_snapshot()["spec_preempted"] >= 1
        assert any(c.cancelled and c.cancel_reason == "preempted"
                   for c in calls)
        for c in calls:
            sched.cancel_speculative(c, "test done")
    finally:
        sched.stop()


def test_frontend_speculate_k():
    with pytest.raises(ValueError):
        ServeFrontEnd(batch_max=2, speculate_k=0, device="cpu")
    g = _graphs()[0]
    front = ServeFrontEnd(batch_max=4, window_s=0.0, speculate_k="auto",
                          device_carry=True, device="cpu").start()
    try:
        assert front.speculate_k == auto_depth(4)
        res = front.submit(g).result(timeout=300)
    finally:
        front.shutdown()
    want = find_minimal_coloring(CompactFrontierEngine(g, device="cpu"),
                                 initial_k=g.max_degree + 1,
                                 validate=make_validator(g),
                                 post_reduce=make_reducer(g))
    assert res.ok and np.array_equal(res.colors, want.colors)


# ---- the pricing model ------------------------------------------------------

def test_auto_depth_and_cap_equal_dgc_tpu():
    for k0 in range(1, 4097):
        assert sm.strict_survival_curve(k0) == jsm.strict_survival_curve(k0)
        assert sm.speculation_auto_cap(k0) == jsm.speculation_auto_cap(k0), k0
    for b in (1, 2, 3, 4, 8, 16):
        for live in (0, 1, 5):
            assert auto_depth(b, live) == jspec.auto_depth(b, live)
            for k0 in (1, 2, 7, 12, 33, 4096):
                assert auto_depth(b, live, k0=k0) == jspec.auto_depth(
                    b, live, k0=k0)


# ---- the CLI ----------------------------------------------------------------

def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "dgc_tpu_torch", *args],
                          env=env, cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_cli_speculate_k_writes_the_strict_coloring(tmp_path):
    base = ["--node-count", "600", "--max-degree", "12", "--seed", "4",
            "--strict-decrement", "--device", "cpu"]
    out = {}
    for name, extra in (("plain", []), ("spec", ["--speculate-k", "3"])):
        r = _cli(base + extra + ["--output-coloring",
                                 str(tmp_path / f"{name}.json")], tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        out[name] = r.stdout
    assert (tmp_path / "plain.json").read_bytes() == \
        (tmp_path / "spec.json").read_bytes()
    attempts = lambda s: [x for x in s.splitlines()
                          if x.startswith("attempt:")]
    assert attempts(out["spec"]) == attempts(out["plain"])
    assert len(attempts(out["plain"])) > 2
    r = _cli(base + ["--speculate-k", "0", "--output-coloring",
                     str(tmp_path / "bad.json")], tmp_path)
    assert r.returncode == 2
    assert "--speculate-k must be a positive integer" in r.stderr
