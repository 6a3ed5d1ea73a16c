"""The port's serve front end (``dgc_tpu_torch.serve.ServeFrontEnd`` over
the batch scheduler, on the CPU) against ``dgc_tpu.serve.ServeFrontEnd``
on the same twelve small graphs, one of them beyond the shape ladder (the
single-graph fallback): every request's status, colors, minimal color
count, attempt tuples, ``batched`` and ``shape_class`` equal, in
continuous and sync mode, affinity on and off. The events validate under
the port's schema copy and ``tools/validate_runlog.py``; a failing
fallback rung flips ``health()``; the retry classifier maps PyTorch's CUDA
out-of-memory message to a resource error.
"""

import json
import os
import sys

import numpy as np
import pytest

from dgc_tpu.serve.queue import ServeFrontEnd as JaxFrontEnd
from dgc_tpu.serve.shape_classes import ShapeLadder as JaxLadder
from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                            make_reducer, make_validator)
from dgc_tpu_torch.models.generators import generate_random_graph
from dgc_tpu_torch.obs import MetricsRegistry, RunLogger
from dgc_tpu_torch.obs.schema import validate_record
from dgc_tpu_torch.resilience.retry import ErrorClass, classify_error
from dgc_tpu_torch.serve import ServeFrontEnd, ShapeLadder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one class (v256w8) for the in-ladder graphs; max degree 24 is beyond it
RUNGS = dict(v_rungs=(256,), w_rungs=(8,))


def _graphs():
    gs = [generate_random_graph(60 + 17 * i, 8, seed=i) for i in range(11)]
    return gs + [generate_random_graph(150, 24, seed=99)]


def _serve(front, graphs) -> dict:
    front.start()
    try:
        tickets = [front.submit(g, request_id=i, timeout=30)
                   for i, g in enumerate(graphs)]
        return {t.request.request_id: t.result(timeout=600) for t in tickets}
    finally:
        front.shutdown()


def _fields(res) -> tuple:
    return (res.status, res.minimal_colors, tuple(res.attempts), res.batched,
            res.shape_class, res.error)


@pytest.fixture(scope="module")
def jax_results():
    graphs = _graphs()
    out = {}
    for mode in ("continuous", "sync"):
        out[mode] = _serve(JaxFrontEnd(ladder=JaxLadder(**RUNGS), batch_max=4,
                                       window_s=0.02, slice_steps=4,
                                       mode=mode), graphs)
    return graphs, out


@pytest.mark.parametrize("mode", ("continuous", "sync"))
@pytest.mark.parametrize("affinity", (True, False))
def test_front_end_equals_dgc_tpu(jax_results, tmp_path, mode, affinity):
    graphs, want = jax_results
    log = tmp_path / "run.jsonl"
    logger = RunLogger(jsonl_path=str(log), echo=False)
    registry = MetricsRegistry()
    got = _serve(ServeFrontEnd(ladder=ShapeLadder(**RUNGS), batch_max=4,
                               window_s=0.02, slice_steps=4, mode=mode,
                               affinity=affinity, timing=True, logger=logger,
                               registry=registry, device="cpu"), graphs)
    logger.close()
    assert sorted(got) == sorted(want[mode])
    for rid, res in got.items():
        ref = want[mode][rid]
        assert _fields(res) == _fields(ref), rid
        assert np.array_equal(res.colors, ref.colors), rid
    assert got[11].batched is False and got[11].shape_class is None
    assert all(got[i].batched for i in range(11))

    records = [json.loads(x) for x in log.read_text().splitlines()]
    for rec in records:
        assert validate_record(rec) == [], rec
    kinds = {r["event"] for r in records}
    assert {"serve_start", "serve_request", "serve_done"} <= kinds
    assert ("serve_slice" if mode == "continuous" else "serve_batch") in kinds
    assert "fallback" not in kinds and "retry" not in kinds
    if mode == "continuous":
        recycled = [r for r in records if r["event"] == "lane_recycled"]
        assert recycled and all(r["device_us"] >= 0 for r in recycled)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from validate_runlog import validate_file

    assert validate_file(str(log)) == []


def test_failing_fallback_rung_flips_health():
    tiny = ShapeLadder(v_rungs=(8,), w_rungs=(4,))

    def factories(arrays):
        def broken():
            raise RuntimeError("primary engine down")

        def bucketed():
            from dgc_tpu_torch.engine.bucketed import BucketedELLEngine

            return BucketedELLEngine(arrays, device="cpu")

        return [("ell-compact", broken), ("ell-bucketed", bucketed)]

    front = ServeFrontEnd(ladder=tiny, batch_max=2, queue_depth=8,
                          fallback_factories=factories, device="cpu").start()
    try:
        assert front.health()["ready"] and not front.health()["degraded"]
        g = generate_random_graph(60, 6, seed=1)
        res = front.submit(g).result(timeout=300)
        assert res.ok and not res.batched
        h = front.health()
        assert h["degraded"] is True
        assert h["backend"] == "ell-bucketed" and h["rung"] == 1
        assert h["ready"] is True      # degraded but still serving
    finally:
        front.shutdown()
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine

    want = find_minimal_coloring(CompactFrontierEngine(g, device="cpu"),
                                 initial_k=g.max_degree + 1,
                                 validate=make_validator(g),
                                 post_reduce=make_reducer(g))
    assert res.minimal_colors == want.minimal_colors
    assert np.array_equal(res.colors, want.colors)


def test_cuda_out_of_memory_classifies_as_resource():
    err = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert classify_error(err) is ErrorClass.RESOURCE
    assert classify_error(RuntimeError("lane_superstep launch failed: CUDA "
                                       "error 700")) is ErrorClass.FATAL


def test_front_end_refuses_a_card_that_is_not_there():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeFrontEnd()
