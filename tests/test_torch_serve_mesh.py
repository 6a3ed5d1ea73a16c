"""The lane-sharded serve tier (``--mesh-devices``) of the port on the CPU,
against ``dgc_tpu.serve.batched``'s ``_sharded`` twins on the conftest's 8
host devices (``lane_mesh(8)`` and ``lane_mesh(2)``) and against the port's
own unsharded path: the sweep, the slice across a stage-ladder re-entry
and a mid-ladder re-init (with and without the spec/cancel vectors, a
shard of dead lanes included), the seat wave, the permute and the resize
(kept lanes crossing shards) exact in every carry slot but the clock's
``T_US``/``T_PREV`` (all int32); the plain K26 fold against ``min``/``any``
over the shards; the pool's floored pads and balanced seats; the front end
and the CLI end to end; a device loss's degrade, a collapse to the
unsharded path and a restore; the restore probe's backoff walk. The CUDA
kernels (K26, the partial K15/K16, the mesh K18/K19) are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from dgc_tpu.layout import LANES_AXIS as JAX_LANES_AXIS
from dgc_tpu.layout import MESH_AXIS as JAX_MESH_AXIS
from dgc_tpu.serve import batched as jb
from dgc_tpu.serve.queue import ServeFrontEnd as JaxFrontEnd
from dgc_tpu.serve.shape_classes import ShapeLadder as JaxLadder
from dgc_tpu_torch import convert
from dgc_tpu_torch.kernels import carry as kcar
from dgc_tpu_torch.kernels import serve as ks
from dgc_tpu_torch.layout import (CARRY_LEN, CARRY_PHASE, CARRY_RUNG,
                                  LANES_AXIS, MESH_AXIS, T_PREV, T_US)
from dgc_tpu_torch.models.generators import generate_random_graph
from dgc_tpu_torch.obs import MetricsRegistry, RunLogger
from dgc_tpu_torch.obs.schema import validate_record
from dgc_tpu_torch.resilience import faults
from dgc_tpu_torch.resilience.domains import DeviceHealth
from dgc_tpu_torch.resilience.faults import FaultSchedule
from dgc_tpu_torch.serve import ServeFrontEnd, ShapeLadder
from dgc_tpu_torch.serve import batched as B
from dgc_tpu_torch.serve.engine import BatchScheduler, _LanePool, _SweepCall
from dgc_tpu_torch.serve.shape_classes import (ShapeClass, dummy_member,
                                               pad_ladder, pad_member)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8 (virtual) host devices")

# the clock slots: the only ones two equal runs may differ in
CLOCK = (T_US, T_PREV)
CLS = ShapeClass(v_pad=512, w_pad=8)
STAGES = ((None, 256), (256, 64), (64, 0))
# one class (v256w8) for the front-end graphs
RUNGS = dict(v_rungs=(256,), w_rungs=(8,))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from contending with the test runner's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(graphs, b: int):
    """Padded members of ``CLS``, dummies past the graphs: the last shards
    of an 8-shard mesh hold dead lanes only."""
    members = [pad_member(g, CLS) for g in graphs]
    members += [dummy_member(CLS)] * (b - len(members))
    return (np.stack([m.comb for m in members]),
            np.stack([m.degrees for m in members]),
            np.array([m.k0 for m in members], np.int32),
            np.array([m.max_steps for m in members], np.int32))


@pytest.fixture(scope="module")
def batch():
    graphs = [generate_random_graph(240 + 40 * i, 8, seed=i) for i in range(6)]
    return _batch(graphs, 8)


@pytest.fixture(scope="module")
def meshes():
    return {n: (jb.lane_mesh(n), B.lane_mesh(n, device="cpu")) for n in (2, 8)}


def _whole(carry) -> list:
    """A carry as whole numpy slots: the port's sharded one gathered."""
    if isinstance(carry[0], (list, tuple)):
        return list(convert.carry_from_lane_shards(carry))
    return [np.asarray(a) for a in carry]


def _assert_carry_equal(a, b, what: str) -> None:
    a, b = _whole(a), _whole(b)
    for j in range(CARRY_LEN):
        if j not in CLOCK:
            assert np.array_equal(a[j], b[j]), f"{what}: slot {j}"


# ---- mesh resolution ---------------------------------------------------------

def test_mesh_resolution_auto_and_explicit():
    assert B.mesh_device_count("auto", "cpu") == 8 == jb.mesh_device_count()
    assert B.mesh_device_count(None, "cpu") == 8
    assert B.mesh_device_count(2, "cpu") == 2 == jb.mesh_device_count(2)
    with pytest.raises(ValueError, match="power of two"):
        B.mesh_device_count(3, "cpu")
    with pytest.raises(ValueError, match="exceeds"):
        B.mesh_device_count(16, "cpu")
    mesh = B.lane_mesh(4, device="cpu")
    assert mesh.n == 4 and mesh.axis_names == ("lanes",)
    assert (MESH_AXIS, LANES_AXIS) == (JAX_MESH_AXIS, JAX_LANES_AXIS)


def test_lane_mesh_over_repeated_devices():
    mesh = B.lane_mesh_over([torch.device("cpu")] * 4)
    assert mesh.n == 4 and mesh.per(8) == 2
    assert mesh.devices == B.lane_mesh(4, device="cpu").devices
    with pytest.raises(ValueError, match="power-of-two"):
        B.lane_mesh_over(["cpu"] * 3)
    with pytest.raises(ValueError, match="unsharded"):
        B.lane_mesh_over(["cpu"])
    with pytest.raises(ValueError):
        mesh.per(6)


# ---- the twins, against the reference's and the unsharded path --------------

@pytest.mark.parametrize("n", (2, 8))
def test_sharded_sweep_equals_reference_and_unsharded(n, batch, meshes):
    comb, degrees, k0, ms = batch
    jmesh, mesh = meshes[n]
    ref = jb.batched_sweep_kernel_sharded(jmesh, comb, degrees, k0, ms,
                                          planes=CLS.planes, stages=STAGES)
    out = B.sharded_home(B.batched_sweep_kernel_sharded(
        mesh, comb, degrees, k0, ms, planes=CLS.planes, stages=STAGES))
    flat = B.carry_home(B.batched_sweep(comb, degrees, k0, ms,
                                        planes=CLS.planes, stages=STAGES,
                                        device="cpu"))
    for j in range(7):
        assert np.array_equal(out[j], np.asarray(ref[j])), f"slot {j}"
        assert np.array_equal(out[j], flat[j]), f"slot {j}"


def _swap_lane0(inputs):
    g = generate_random_graph(300, 8, seed=99)
    m = pad_member(g, CLS)
    comb, degrees, k0, ms = (x.copy() for x in inputs)
    comb[0], degrees[0], k0[0], ms[0] = m.comb, m.degrees, m.k0, m.max_steps
    return comb, degrees, k0, ms


@pytest.mark.parametrize("n,spec", ((2, False), (2, True), (8, False),
                                    (8, True)))
def test_sharded_slice_reentry_and_reinit(n, spec, batch, meshes):
    """Slices of one superstep through a three-rung ladder: each slice's
    carry equal to the reference twin's and to the port's unsharded
    slice's. Lane 0 is re-initialized with a new graph once the ladder
    engaged; with ``spec`` lane 1 runs spec-tagged (no confirm) and lane 2
    is seated spec-tagged and cancelled later (killed at a slice entry)."""
    jmesh, mesh = meshes[n]
    inputs = batch
    a0 = B.stage_idx_width(STAGES)
    c_ref = jb.idle_carry(8, CLS.v_pad, a0)
    c_port = B.idle_carry(8, CLS.v_pad, a0)
    c_flat = B.idle_carry(8, CLS.v_pad, a0)
    reset = np.ones(8, np.int32)
    spec_v = np.zeros(8, np.int32)
    cancel_v = np.zeros(8, np.int32)
    if spec:
        spec_v[[1, 2]] = 1
    vecs = (spec_v, cancel_v) if spec else (None, None)
    swapped, max_rung = False, 0
    for it in range(400):
        kw = dict(planes=CLS.planes, slice_steps=1, stages=STAGES)
        c_ref = jb.batched_slice_kernel_sharded(jmesh, *inputs, reset, c_ref,
                                                *vecs, **kw)
        donate = it % 2 == 1   # both forms, in turn
        twin = (B.batched_slice_kernel_sharded_donated if donate
                else B.batched_slice_kernel_sharded)
        c_port = twin(mesh, *inputs, reset, c_port, *vecs, **kw)
        c_flat = B.batched_slice(*inputs, reset, c_flat, *vecs, device="cpu",
                                 **kw)
        _assert_carry_equal(c_port, c_ref, f"slice {it}, the reference")
        _assert_carry_equal(c_port, c_flat, f"slice {it}, unsharded")
        reset = np.zeros(8, np.int32)
        home = _whole(c_port)
        phase, rungs = home[CARRY_PHASE], home[CARRY_RUNG]
        live = phase < 2
        if live.any():
            max_rung = max(max_rung, int(rungs[live].max()))
        if spec and it == 3:
            cancel_v[2] = 1
        if not swapped and live.any() and rungs[live].max() >= 1:
            inputs = _swap_lane0(inputs)
            reset[0] = 1
            swapped = True
        if swapped and (phase >= 2).all():
            break
    else:
        pytest.fail("the batch never finished")
    assert swapped and max_rung >= 1
    if spec:
        # the spec-tagged lane ran no confirm; the cancelled one was killed
        # before its attempt finished
        assert int(home[7][1]) > 0 and int(home[11][1]) == 0
        assert int(home[7][2]) == 0 and int(home[CARRY_PHASE][2]) == 2


def _stacks(rng, b: int):
    return (rng.integers(0, 1 << 30, size=(b, CLS.v_pad, CLS.w_pad)
                         ).astype(np.int32),
            rng.integers(0, 9, size=(b, CLS.v_pad)).astype(np.int32),
            rng.integers(1, 10, size=b).astype(np.int32),
            rng.integers(4, 4000, size=b).astype(np.int32),
            np.zeros(b, np.int32))


def _jax_sharded(mesh, arrays):
    sh = jb.lane_sharding(mesh)
    return tuple(jax.device_put(a, sh) for a in arrays)


@pytest.mark.parametrize("n", (2, 8))
def test_seat_wave_over_shards_equals_reference(n, meshes):
    jmesh, mesh = meshes[n]
    rng = np.random.default_rng(7 + n)
    stacks = _stacks(rng, 8)
    lanes = (5, 1, 5, 7, 2)   # several shards, lane 5 twice (the last wins)
    seats = [(lane, rng.integers(0, 1 << 30, size=(CLS.v_pad, CLS.w_pad)
                                 ).astype(np.int32),
              rng.integers(0, 9, size=CLS.v_pad).astype(np.int32),
              int(rng.integers(1, 10)), int(rng.integers(4, 4000)))
             for lane in lanes]
    ref = _jax_sharded(jmesh, stacks)
    for lane, m_comb, m_deg, m_k0, m_ms in seats:
        ref = jb.seat_lane_kernel_sharded(jmesh, *ref, np.int32(lane), m_comb,
                                          m_deg, np.int32(m_k0),
                                          np.int32(m_ms))
    port = convert.lane_shards_from_carry(stacks, n)
    before = dict(kcar.launch_counts)
    B.seat_lane_kernel_sharded(mesh, port, seats)
    assert kcar.launch_counts == before   # the CPU runs no kernel
    got = convert.carry_from_lane_shards(port)
    for j in range(5):
        assert np.array_equal(got[j], np.asarray(ref[j])), f"stack {j}"


PERMUTES = (  # (old lanes, new lanes, src, dst): kept lanes cross shards
    (8, 8, (1, 4, 6), (0, 1, 2)),
    (8, 16, (7, 0, 3), (0, 1, 2)),
    (16, 8, (15, 9, 2, 12), (0, 1, 2, 3)),
)


@pytest.mark.parametrize("n", (2, 8))
@pytest.mark.parametrize("b_old,b_new,src,dst", PERMUTES)
def test_permute_carry_sharded_equals_reference(n, b_old, b_new, src, dst,
                                                meshes):
    jmesh, mesh = meshes[n]
    rng = np.random.default_rng(b_old + b_new + n)
    old = [rng.integers(-5, 1 << 20, size=(b_old, 4) if j == 18 else
                        (b_old, CLS.v_pad) if j in (2, 6, 10) else (b_old,)
                        ).astype(np.int32) for j in range(CARRY_LEN)]
    ref = jb.permute_carry_kernel_sharded(
        jmesh, _jax_sharded(jmesh, old),
        _jax_sharded(jmesh, jb.idle_carry(b_new, CLS.v_pad, 4)),
        np.asarray(src, np.int32), np.asarray(dst, np.int32))
    port = B.permute_carry_kernel_sharded(
        mesh, convert.lane_shards_from_carry(old, n), list(src), list(dst),
        b_new)
    assert len(port) == n
    _assert_carry_equal(port, [np.asarray(a) for a in ref], "permute")
    # the clock slots too: a permute moves them as any other
    assert np.array_equal(_whole(port)[T_US], np.asarray(ref[T_US]))


RESIZES = (  # (old lanes, the new rows' sources; >= old lanes: the dummy)
    (8, (0, 2, 8, 8, 8, 8, 8, 8)),
    (8, (5, 2, 7, 1) + (8,) * 12),
    (16, (13, 1, 16, 9, 16, 16, 16, 16)),
)


@pytest.mark.parametrize("n", (2, 8))
@pytest.mark.parametrize("b_old,src", RESIZES)
def test_resize_inputs_sharded_equals_reference(n, b_old, src, meshes):
    jmesh, mesh = meshes[n]
    rng = np.random.default_rng(b_old + len(src) + n)
    stacks = _stacks(rng, b_old)
    dummy = dummy_member(CLS)
    ref = jb.resize_inputs_kernel_sharded(
        jmesh, *_jax_sharded(jmesh, stacks[:4]), np.asarray(src, np.int32),
        dummy.comb, dummy.degrees, np.int32(1), np.int32(dummy.max_steps))
    port = B.resize_inputs_kernel_sharded(
        mesh, convert.lane_shards_from_carry(stacks, n), list(src),
        torch.from_numpy(dummy.comb), dummy.max_steps)
    got = convert.carry_from_lane_shards(port)
    for j in range(5):
        assert np.array_equal(got[j], np.asarray(ref[j])), f"stack {j}"


FOLDS = (  # (each shard's (rung, live), steps, budget)
    (((2, 1), (0, 1), (3, 0), (3, 0)), 3, 8),
    (((3, 0), (3, 0)), 1, 8),            # no live lane anywhere
    (((1, 1), (2, 1)), 4, 4),            # the slice's steps spent
    (((1, 0), (2, 1), (3, 0), (0, 0), (3, 0), (1, 1), (3, 0), (3, 0)), 0, 1),
)


@pytest.mark.parametrize("partials,steps,budget", FOLDS)
def test_plain_fold_equals_min_and_any(partials, steps, budget):
    ctrls = []
    for rung, live in partials:
        c = ks.ladder_ctrl(STAGES, "cpu")
        c[ks.CTRL_REXEC], c[ks.CTRL_LIVE] = rung, live
        c[ks.CTRL_STEPS], c[ks.CTRL_BUDGET], c[ks.CTRL_TICKET] = steps, budget, 3
        ctrls.append(c)
    ks.lane_mesh_fold_reference(ctrls)
    rung = min(r for r, _ in partials)
    live = int(any(v for _, v in partials) and steps < budget)
    for c in ctrls:
        assert c[ks.CTRL_REXEC] == rung and c[ks.CTRL_LIVE] == live
        assert c[ks.CTRL_STEPS] == steps and c[ks.CTRL_TICKET] == 0
    before = [c.clone() for c in ctrls]
    ks.lane_mesh_fold_reference(ctrls)   # folded words are a fixed point
    assert all(torch.equal(a, b) for a, b in zip(before, ctrls))


def test_convert_lane_shards_round_trip():
    rng = np.random.default_rng(3)
    carry = [a for a in B.idle_carry(8, 64, 4)]
    carry[2] = rng.integers(-9, 9, size=(8, 64)).astype(np.int32)
    for n in (1, 2, 8):
        shards = convert.lane_shards_from_carry(carry, n)
        assert len(shards) == n and shards[0][2].shape == (8 // n, 64)
        back = convert.carry_from_lane_shards(shards)
        assert all(np.array_equal(a, b) for a, b in zip(back, carry))


# ---- the pool ------------------------------------------------------------------

def test_pool_pads_mesh_multiples_and_balanced_seating():
    mesh = B.lane_mesh(8, device="cpu")
    pool = _LanePool(CLS, 1, dummy_member(CLS), torch.device("cpu"),
                     mesh=mesh)
    assert pool.b_pad == 8   # floored at the mesh size
    m = pad_member(generate_random_graph(200, 8, seed=1), CLS)
    lanes = [pool.fill(_SweepCall(m, m.k0)) for _ in range(4)]
    assert len({i // (pool.b_pad // pool.mesh_n) for i in lanes}) == 4
    assert pool.device_live() == [1, 1, 1, 1, 0, 0, 0, 0]
    pool.fill(_SweepCall(m, m.k0))
    assert sum(pool.device_live()) == 5 and max(pool.device_live()) == 1
    assert pad_ladder(8, min_pad=8) == (8,)
    assert pad_ladder(32, min_pad=8) == (32, 16, 8)
    assert pad_ladder(6, min_pad=4) == (8, 4)


def test_mesh_unset_or_one_keeps_the_unsharded_path():
    base = BatchScheduler(batch_max=4, device="cpu")
    one = BatchScheduler(batch_max=4, mesh_devices=1, device="cpu")
    assert base.mesh is None and one.mesh is None
    assert base.mesh_snapshot() is None and base.mesh_health() is None
    c = ShapeClass(v_pad=256, w_pad=8)
    base._kernel_for(c, 2)
    one._kernel_for(c, 2)
    assert set(base._kernels) == set(one._kernels)
    sharded = BatchScheduler(batch_max=4, mesh_devices=8, device="cpu")
    sharded._kernel_for(c, 8)
    (key,) = sharded._kernels
    assert key[-3:] == ("mesh", 8, 0)
    over = BatchScheduler(batch_max=4, device="cpu",
                          mesh_devices=B.lane_mesh_over(["cpu"] * 2))
    assert over.mesh_devices == 2


# ---- end to end --------------------------------------------------------------

def _graphs(n: int = 5, seed0: int = 0):
    return [generate_random_graph(90 + 30 * i, 8, seed=seed0 + i)
            for i in range(n)]


def _serve(front, graphs) -> dict:
    front.start()
    try:
        tickets = [front.submit(g, request_id=i, timeout=30)
                   for i, g in enumerate(graphs)]
        return {t.request.request_id: t.result(timeout=600) for t in tickets}
    finally:
        front.shutdown()


def _fields(res) -> tuple:
    return (res.status, res.minimal_colors, tuple(res.attempts),
            tuple(np.asarray(res.colors).tolist()), res.batched,
            res.shape_class)


@pytest.fixture(scope="module")
def jax_mesh_results():
    return {i: _fields(r) for i, r in _serve(JaxFrontEnd(
        ladder=JaxLadder(**RUNGS), batch_max=8, window_s=0.02,
        slice_steps=4, mesh_devices=8), _graphs()).items()}


@pytest.fixture(scope="module")
def port_flat_results():
    return {i: _fields(r) for i, r in _serve(ServeFrontEnd(
        ladder=ShapeLadder(**RUNGS), batch_max=8, window_s=0.02,
        slice_steps=4, device="cpu"), _graphs()).items()}


def _events(records) -> list:
    for r in records:
        assert validate_record(r) == [], r
    return records


@pytest.mark.parametrize("mode,device_carry", (("continuous", False),
                                               ("continuous", True),
                                               ("sync", False)))
def test_front_end_mesh_equals_reference(mode, device_carry,
                                         jax_mesh_results, port_flat_results):
    logger = RunLogger(echo=False)
    records = []
    logger.add_sink(records.append)
    front = ServeFrontEnd(ladder=ShapeLadder(**RUNGS), batch_max=8,
                          window_s=0.02, slice_steps=4, mode=mode,
                          device_carry=device_carry, mesh_devices=8,
                          device="cpu", logger=logger)
    got = {i: _fields(r) for i, r in _serve(front, _graphs()).items()}
    assert got == jax_mesh_results
    assert got == port_flat_results
    assert all(f[0] == "ok" and f[4] for f in got.values())
    snap = front.scheduler.mesh_snapshot()
    assert snap["mesh_devices"] == 8 and len(snap["device_occupancy"]) == 8
    events = _events(records)
    start = next(e for e in events if e["event"] == "serve_start")
    assert start["mesh_devices"] == 8
    kind = "serve_slice" if mode == "continuous" else "serve_batch"
    dispatches = [e for e in events if e["event"] == kind]
    assert dispatches
    for e in dispatches:
        assert e["mesh_devices"] == 8 and e["b_pad"] % 8 == 0
        assert len(e["device_occupancy"]) == 8
        if mode == "continuous":
            assert abs(sum(x * (e["b_pad"] // 8)
                           for x in e["device_occupancy"]) - e["live"]) < 1e-6


def test_mesh_off_emits_no_mesh_fields():
    logger = RunLogger(echo=False)
    records = []
    logger.add_sink(records.append)
    _serve(ServeFrontEnd(ladder=ShapeLadder(**RUNGS), batch_max=2,
                         window_s=0.0, device="cpu", logger=logger),
           _graphs(2))
    text = json.dumps(records)
    assert "mesh_devices" not in text and "device_occupancy" not in text
    assert '"mesh"' not in text


def _requests(tmp_path, n: int = 3):
    req = tmp_path / "reqs.jsonl"
    req.write_text("".join(json.dumps({"id": i, "node_count": 150,
                                       "max_degree": 5, "seed": i}) + "\n"
                           for i in range(n)))
    return req


def test_serve_cli_mesh_devices(tmp_path, capsys):
    from dgc_tpu_torch.serve.cli import serve_main
    from tools.validate_runlog import validate_file

    req = _requests(tmp_path)
    log, out = tmp_path / "log.jsonl", tmp_path / "results.jsonl"
    assert serve_main(["--requests", str(req), "--results", str(out),
                       "--device", "cpu", "--mesh-devices", "8",
                       "--batch-max", "4", "--log-json", str(log)]) == 0
    assert validate_file(str(log)) == []
    summary = next(json.loads(x) for x in log.read_text().splitlines()
                   if '"serve_summary"' in x)
    assert summary["mesh_devices"] == 8
    assert len(summary["device_occupancy"]) == 8
    assert "mesh_degrades" not in summary
    assert all(json.loads(x)["status"] == "ok"
               for x in out.read_text().splitlines())


@pytest.mark.parametrize("value,message", (("3", "--mesh-devices"),
                                           ("lots", "--mesh-devices"),
                                           ("16", "exceeds")))
def test_serve_cli_bad_mesh_devices_exits_2(tmp_path, capsys, value,
                                            message):
    from dgc_tpu_torch.serve.cli import serve_main

    assert serve_main(["--requests", str(_requests(tmp_path, 1)), "--device",
                       "cpu", "--mesh-devices", value]) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("device_carry", (False, True))
def test_speculation_on_the_mesh_equals_sequential(device_carry):
    """The speculation plane through the mesh's pools: a depth-3 strict
    chain's window seated over 4 shards (the spec and cancel vectors split
    per shard) gives the sequential chain's attempts and colors."""
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_reducer,
                                                make_validator)
    from dgc_tpu_torch.serve.speculate import SpeculativeMinimalKEngine

    g = generate_random_graph(200, 8, seed=5)

    def strict(engine):
        attempts = []
        res = find_minimal_coloring(
            engine, initial_k=g.max_degree + 1, strict_decrement=True,
            validate=make_validator(g),
            on_attempt=lambda r, v: attempts.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(g))
        return res, attempts

    want, want_attempts = strict(CompactFrontierEngine(g, device="cpu"))
    sched = BatchScheduler(batch_max=4, window_s=0.0, slice_steps=4,
                           device_carry=device_carry, mesh_devices=4,
                           device="cpu").start()
    try:
        engine = SpeculativeMinimalKEngine(
            pad_member(g, ShapeClass(v_pad=256, w_pad=8)), sched, depth=3)
        try:
            got, got_attempts = strict(engine)
        finally:
            engine.close()
    finally:
        sched.stop()
    assert got_attempts == want_attempts and len(want_attempts) > 2
    assert got.minimal_colors == want.minimal_colors
    assert np.array_equal(got.colors, want.colors)
    assert engine.spec_stats["claims"] > 0


# ---- the failure-domain plane ------------------------------------------------

@pytest.mark.parametrize("mode", ("continuous", "sync"))
def test_device_loss_degrades_and_serves_identical_colors(
        mode, port_flat_results):
    logger = RunLogger(echo=False)
    registry = MetricsRegistry()
    records = []
    logger.add_sink(records.append)
    plane = faults.FaultPlane(FaultSchedule.parse("mesh@1=device_loss:5"))
    with faults.injected(plane):
        front = ServeFrontEnd(ladder=ShapeLadder(**RUNGS), batch_max=8,
                              window_s=0.02, slice_steps=4, mode=mode,
                              mesh_devices=8, device="cpu", logger=logger,
                              registry=registry)
        got = _serve(front, _graphs())
        health = front.health(emit=True)
    assert plane.fired_snapshot()
    assert {i: _fields(r) for i, r in got.items()} == port_flat_results
    sched = front.scheduler
    assert sched.mesh_devices == 4   # 8 -> lose one -> pow2(7) = 4
    stats = sched.stats_snapshot()
    assert stats["mesh_degrades"] == 1 and stats["lanes_evacuated"] >= 1
    assert health["mesh"]["devices_surviving"] == 7
    assert health["mesh"]["degraded"] is True
    assert health["mesh"]["devices"][5] == "lost"
    events = _events(records)
    (degrade,) = [e for e in events if e["event"] == "mesh_degrade"]
    assert (degrade["devices_before"], degrade["devices_after"],
            degrade["lost_device"]) == (8, 4, 5)
    assert registry.to_dict()["dgc_serve_mesh_devices"]["value"] == 4


def test_device_loss_below_two_survivors_collapses(port_flat_results):
    plane = faults.FaultPlane(FaultSchedule.parse("mesh@1=device_loss:1"))
    with faults.injected(plane):
        front = ServeFrontEnd(ladder=ShapeLadder(**RUNGS), batch_max=8,
                              window_s=0.02, slice_steps=4, device_carry=True,
                              mesh_devices=2, device="cpu")
        got = _serve(front, _graphs())
    assert {i: _fields(r) for i, r in got.items()} == port_flat_results
    assert front.scheduler.mesh is None
    assert front.scheduler.mesh_health()["degraded"] is True


def test_restore_after_degrade():
    records = []
    logger = RunLogger(echo=False)
    logger.add_sink(records.append)
    graphs = _graphs(3, seed0=60)
    plane = faults.FaultPlane(FaultSchedule.parse("mesh@1=device_loss:1"))
    with faults.injected(plane):
        front = ServeFrontEnd(ladder=ShapeLadder(**RUNGS), batch_max=4,
                              window_s=0.0, mesh_devices=8, device="cpu",
                              logger=logger).start()
        try:
            assert [front.submit(g).result(timeout=300).status
                    for g in graphs[:2]] == ["ok", "ok"]
            sched = front.scheduler
            assert sched.mesh_devices == 4
            sched.request_restore()   # dropped: the slot is still lost
            time.sleep(0.2)
            assert sched.mesh_devices == 4
            sched.device_health.mark_healthy(1)
            sched.request_restore()
            deadline = time.time() + 10
            while sched.mesh_devices != 8 and time.time() < deadline:
                time.sleep(0.02)
            assert sched.mesh_devices == 8
            assert front.submit(graphs[2]).result(timeout=300).status == "ok"
            health = front.health()
        finally:
            front.shutdown()
    assert health["mesh"]["degraded"] is False
    assert front.scheduler.stats_snapshot()["mesh_restores"] == 1
    (restore,) = [e for e in _events(records)
                  if e["event"] == "mesh_restore"]
    assert restore["devices_after"] == 8


class _SchedStub:
    """Just enough scheduler for the probe: a health plane and a restore
    hook."""

    def __init__(self, n=4):
        self.device_health = DeviceHealth(n)
        self.restores = 0

    def request_restore(self):
        self.restores += 1


def test_probe_backoff_walk_then_restore():
    from dgc_tpu_torch.resilience.probe import HealthProbe, canary_probe

    records = []
    logger = RunLogger(echo=False)
    logger.add_sink(records.append)
    registry = MetricsRegistry()
    sched = _SchedStub(4)
    sched.device_health.mark_lost(2)
    clock = [0.0]
    verdicts = [False, False, True]
    probe = HealthProbe(sched, interval_s=1.0, backoff_base=2.0,
                        probe_fn=lambda d: verdicts.pop(0), logger=logger,
                        registry=registry, clock=lambda: clock[0])
    assert probe.tick() == 1                    # fail 1: back off 1 s
    assert probe.snapshot()["benched"][2]["backoff_s"] == 1.0
    assert probe.tick() == 0                    # not due yet
    clock[0] = 1.0
    assert probe.tick() == 1                    # fail 2: back off 2 s
    clock[0] = 2.0
    assert probe.tick() == 0
    clock[0] = 3.0
    assert probe.tick() == 1                    # ok: healthy, restore armed
    assert sched.device_health.lost() == () and sched.restores == 1
    acts = [(e["action"], e["ok"]) for e in _events(records)
            if e["event"] == "mesh_probe"]
    assert acts == [("probed", False), ("probed", False), ("probed", True),
                    ("restore_requested", True)]
    assert registry.to_dict()['dgc_mesh_probe_total{ok="false"}'][
        "value"] == 2.0
    assert canary_probe("cpu") is True and canary_probe("nowhere") is False


def test_probe_canary_runs_on_the_slots_device(monkeypatch):
    """The default canary of a mesh that repeats a device (four slots on
    one CPU) runs on each benched slot's own device, also where the host
    has fewer cards than slots (one card here, made up): slot 3 is probed
    on the CPU and restored."""
    from dgc_tpu_torch.resilience.probe import HealthProbe

    sched = BatchScheduler(mesh_devices=B.lane_mesh_over(["cpu"] * 4),
                           device="cpu")
    assert [sched.slot_device(i) for i in (0, 3, 4)] == [
        torch.device("cpu"), torch.device("cpu"), None]
    sched.device_health.mark_lost(3)
    restores = []
    monkeypatch.setattr(sched, "request_restore",
                        lambda: restores.append(True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    probe = HealthProbe(sched, interval_s=1.0, clock=lambda: 0.0)
    assert probe.tick() == 1
    assert sched.device_health.lost() == () and restores == [True]
