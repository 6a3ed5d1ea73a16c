"""The port's attempt block (``CompactFrontierEngine.attempt_block``, K9
``block_record`` and K10 ``block_start`` on their plain versions) and its
blocked minimal-k driver equal ``dgc_tpu``'s on the CPU, exactly.

- The blocked driver against the port's sequential driver and
  ``dgc_tpu``'s blocked and sequential drivers (attempt tuples,
  ``minimal_colors``, the colors' bytes): 400-vertex uniform graphs (seeds
  3, 11) at A ∈ {2, 3, 5}, strict and jump; the 1,500-vertex RMAT strict
  chain at A = 4 (the port with a compacting ladder, which moves work,
  never results); a forced ladder with forced hub knobs, where the blocks
  resume from a ring holding live counts and the prune tiers move.
- Intermediate block results are scalar-only; ``attempts_per_dispatch=1``
  never calls ``attempt_block``; a STALLED attempt leaves the block
  through ``attempt``'s widen loop with the sequential result.
- K10's plain version against ``dgc_tpu.engine.compact.restore_from_ring``
  on random rings (``convert.ring_from_jax``); K9's against the block
  body's epilogue rules.
- ``auto_attempts_per_dispatch`` equals ``dgc_tpu``'s.
- The CLI with ``--attempts-per-dispatch`` (and ``auto``) writes the JAX
  CLI's coloring; a bad value exits 2 with its message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_hub_cases as hub  # noqa: E402

from dgc_tpu.engine import compact as jc  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.engine.minimal_k import make_validator as jax_validator  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import (generate_random_graph_fast,  # noqa: E402
                                       generate_rmat_graph)
from dgc_tpu.ops.reduce_colors import reduce_color_count as jax_reduce  # noqa: E402
from dgc_tpu.utils import schedule_model as jsm  # noqa: E402
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine import compact as tc  # noqa: E402
from dgc_tpu_torch.engine.base import (AttemptStatus,  # noqa: E402
                                       BlockAttemptResult)
from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,  # noqa: E402
                                            make_reducer, make_validator)
from dgc_tpu_torch.kernels import block as kb  # noqa: E402
from dgc_tpu_torch.kernels import compact as kc  # noqa: E402
from dgc_tpu_torch.utils.schedule_model import \
    auto_attempts_per_dispatch  # noqa: E402

_graphs: dict = {}
_runs: dict = {}


def graph(seed: int):
    if seed not in _graphs:
        _graphs[seed] = generate_random_graph_fast(400, avg_degree=6.0,
                                                   seed=seed)
    return _graphs[seed]


def key(res) -> tuple:
    return ([(a.k, int(a.status), a.supersteps, a.colors_used)
             for a in res.attempts], res.minimal_colors, res.colors.tobytes())


def jax_sweep(g, strict: bool, attempts: int = 1, k0=None, **knobs):
    return key(jax_find(
        jc.CompactFrontierEngine(g, **knobs),
        g.max_degree + 1 if k0 is None else k0, strict_decrement=strict,
        validate=jax_validator(g),
        post_reduce=lambda c: jax_reduce(g.indptr, g.indices, c,
                                         native=False),
        attempts_per_dispatch=attempts))


def port_sweep(g, strict: bool, attempts: int = 1, k0=None, engine=None,
               **knobs):
    tg = convert.graph_from_numpy(g.indptr, g.indices)
    if engine is None:
        engine = tc.CompactFrontierEngine(tg, device="cpu", **knobs)
    return key(find_minimal_coloring(
        engine, g.max_degree + 1 if k0 is None else k0,
        strict_decrement=strict, validate=make_validator(tg),
        post_reduce=make_reducer(tg), attempts_per_dispatch=attempts))


def sequential(seed: int, strict: bool) -> tuple:
    """The JAX and the port's sequential sweeps, once per module; they
    must agree."""
    if (seed, strict) not in _runs:
        want = jax_sweep(graph(seed), strict)
        assert port_sweep(graph(seed), strict) == want
        _runs[seed, strict] = want
    return _runs[seed, strict]


@pytest.mark.parametrize("attempts", [2, 3, 5])
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "jump"])
@pytest.mark.parametrize("seed", [3, 11])
def test_blocked_driver_equals_jax(seed, strict, attempts):
    want = sequential(seed, strict)
    assert port_sweep(graph(seed), strict, attempts) == want
    assert jax_sweep(graph(seed), strict, attempts) == want


def test_blocked_rmat_strict_chain_equals_jax():
    # Δ+1 far above the answer: many full blocks, then a ragged tail
    g = generate_rmat_graph(1500, avg_degree=8, seed=5)
    want = jax_sweep(g, True)
    assert len(want[0]) > 12
    assert jax_sweep(g, True, 4) == want
    assert port_sweep(g, True, 4, stages=((None, 750), (750, 188),
                                          (188, 24), (24, 0))) == want


def test_blocked_forced_ladder_and_hub_knobs(monkeypatch):
    name = "rmat-tier2"  # forced stages, flat_cap=8, prune_u_min=4, ...
    g = hub.graph(name)
    seen = {"hits": 0, "ring_ba": 0, "tiers": 0}
    start, finish = kb.block_start_reference, kc.stage_finish

    def spy_start(ctrl, blk, state, live, ring, degrees, init_ba, **kw):
        b, c, meta = blk.tolist(), ctrl.tolist(), ring[2].tolist()
        seen["hits"] += kb.block_open(b) and any(
            j < c[kc.CTRL_REC_CNT] and m[1] < b[kb.BLK_K] <= m[2]
            for j, m in enumerate(meta))
        seen["ring_ba"] = max(seen["ring_ba"], int(ring[1].max()))
        start(ctrl, blk, state, live, ring, degrees, init_ba, **kw)

    def spy_finish(ctrl, state, ring, live, *args, **kw):
        finish(ctrl, state, ring, live, *args, **kw)
        seen["tiers"] = max(seen["tiers"], int(live[kc.LIVE_TIER].max()))

    monkeypatch.setattr(kb, "block_start_reference", spy_start)
    monkeypatch.setattr(kc, "stage_finish", spy_finish)
    first_used = None
    for strict, attempts in ((False, 3), (True, 2)):
        # the strict chain starts two above the jump sweep's first count;
        # the port's sequential sweeps equal JAX's here
        # (tests/test_torch_hub_engine.py)
        k0 = min(g.max_degree + 1, first_used + 2) if strict \
            else g.max_degree + 1
        want = key(find_minimal_coloring(hub.port_engine(name), k0,
                                         strict_decrement=strict))
        first_used = want[0][0][3]
        assert key(find_minimal_coloring(
            hub.port_engine(name), k0, strict_decrement=strict,
            attempts_per_dispatch=attempts)) == want
        if strict:
            assert key(jax_find(hub.jax_engine(name), k0, strict_decrement=True,
                                attempts_per_dispatch=attempts)) == want
    # blocks resumed from the ring, its live counts held, and the prune
    # tiers moved
    assert seen["hits"] > 0 and seen["ring_ba"] > 0 and seen["tiers"] > 0


def test_block_results_are_scalar_until_boundary():
    g = graph(3)
    eng = tc.CompactFrontierEngine(convert.graph_from_numpy(g.indptr,
                                                            g.indices),
                                   device="cpu")
    out = eng.attempt_block(g.max_degree + 1, 3, strict_decrement=True)
    assert len(out.results) == 3 and not out.done
    assert out.k_next == g.max_degree - 2 and out.best_colors is None
    for res in out.results[:-1]:
        assert isinstance(res, BlockAttemptResult) and res.colors is None
        assert res.status is AttemptStatus.SUCCESS
        assert res.colors_used == res.used > 0
    assert out.results[-1].colors is not None
    assert out.results[-1].colors_used == out.results[-1].used
    # the carry resumes the next block; want_best brings the best row home
    nxt = eng.attempt_block(out.k_next, 2, strict_decrement=True,
                            carry=out.carry, want_best=True)
    assert nxt.best_colors is not None
    assert [r.k for r in nxt.results] == [out.k_next, out.k_next - 1]
    r = BlockAttemptResult(AttemptStatus.SUCCESS, None, 5, 8, used=6)
    assert r.colors_used == 6
    r.colors = np.array([0, 1, 2], np.int32)
    assert r.colors_used == 3


def test_block_below_one_is_the_empty_budget():
    g = graph(3)
    eng = tc.CompactFrontierEngine(convert.graph_from_numpy(g.indptr,
                                                            g.indices),
                                   device="cpu")
    out = eng.attempt_block(0, 4)
    assert out.done and out.k_next == 0 and out.carry is None
    assert [(r.k, r.status, r.supersteps) for r in out.results] == \
        [(0, AttemptStatus.FAILURE, 0)]
    assert (out.results[0].colors == -1).all()


def test_attempts_one_never_calls_attempt_block():
    g = graph(11)
    calls = []

    class Spy(tc.CompactFrontierEngine):
        def attempt_block(self, *a, **kw):
            calls.append(a)
            return super().attempt_block(*a, **kw)

    tg = convert.graph_from_numpy(g.indptr, g.indices)
    assert port_sweep(g, True, 1, engine=Spy(tg, device="cpu")) == \
        sequential(11, True)
    assert calls == []
    assert port_sweep(g, True, 2, engine=Spy(tg, device="cpu")) == \
        sequential(11, True)
    assert calls


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "jump"])
def test_stalled_tail_leaves_the_block(strict):
    # K40 under a 1-plane window cap stalls and widens; a full-table-only
    # ladder, since compaction stages use uncapped planes
    k40 = JaxArrays.from_edge_list(
        40, np.array([[i, j] for i in range(40) for j in range(i + 1, 40)]))
    knobs = dict(max_window_planes=1, stages=((None, 0),))
    want = key(jax_find(jc.CompactFrontierEngine(k40, **knobs), 41,
                        strict_decrement=strict))
    calls = []

    class Spy(tc.CompactFrontierEngine):
        def attempt(self, k):
            calls.append(k)
            return super().attempt(k)

    eng = Spy(convert.graph_from_numpy(k40.indptr, k40.indices),
              device="cpu", **knobs)
    assert key(find_minimal_coloring(eng, 41, strict_decrement=strict,
                                     attempts_per_dispatch=3)) == want
    assert calls  # the STALLED budget re-ran through attempt()


# ---- K10 and K9: the plain versions against the JAX rules --------------------

def _random_rec(rng, v: int, nb: int, k: int, mode: str):
    """A JAX-layout ring whose (best, mc] brackets hold ``k`` in no slot,
    one slot or several; ``count`` above 4 in the last mode."""
    meta = np.empty((kc.REC_SLOTS, kc.META_COLS), np.int32)
    for j in range(kc.REC_SLOTS):
        lo = int(rng.integers(k, k + 20))  # a bracket above k
        meta[j] = (rng.integers(1, 90), lo, lo + rng.integers(1, 9),
                   rng.integers(0, 60), rng.integers(0, v + 2))
    hits = {"none": [], "one": [int(rng.integers(0, 4))],
            "several": [0, 2, 3], "wrapped": [1, 3]}[mode]
    for j in hits:
        meta[j, 1], meta[j, 2] = k - rng.integers(1, 4), k + rng.integers(0, 4)
    cnt = 9 if mode == "wrapped" else int(rng.integers(max(hits, default=0)
                                                       + 1, 5))
    return (rng.integers(-1, 99, (kc.REC_SLOTS, v + 2)).astype(np.int32),
            rng.integers(0, 99, (kc.REC_SLOTS, nb)).astype(np.int32), meta,
            np.int32(cnt), np.int32(rng.integers(-1, 60)))


@pytest.mark.parametrize("mode", ["none", "one", "several", "wrapped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_start_plain_equals_restore_from_ring(seed, mode):
    rng = np.random.default_rng(seed)
    v, nb = 300, 3
    degrees = np.where(rng.random(v) < 0.1, 0, rng.integers(1, 9, v))
    init_ba = rng.integers(0, v, nb).astype(np.int32)
    for _ in range(6):
        k = int(rng.integers(2, 40))
        rec = _random_rec(rng, v, nb, k, mode)
        best_pe, ring, rec_t = convert.ring_from_jax(rec, device="cpu")
        assert best_pe.shape == (v + 2,) and (best_pe == 0).all()
        buf, ctrl, blk = kb.new_block(k, 2, rec_t)
        state = torch.zeros((2, v + 2), dtype=torch.int32)
        live = torch.full((kc.LIVE_ROWS, nb), 7, dtype=torch.int32)
        kb.block_start(ctrl, blk, state, live, ring,
                       torch.from_numpy(degrees.astype(np.int32)),
                       torch.from_numpy(init_ba))
        head = jc._default_init(jnp.asarray(degrees, jnp.int32),
                                tuple(int(x) for x in init_ba))
        pe, ba, step, stall, act = jc.restore_from_ring(
            tuple(jnp.asarray(x) for x in rec), jnp.int32(k),
            jnp.bool_(False), head[0], head[4], head[1], head[3], head[2])
        np.testing.assert_array_equal(state[0].numpy(), np.asarray(pe))
        np.testing.assert_array_equal(state[1].numpy(), np.asarray(pe))
        np.testing.assert_array_equal(live[kc.LIVE_BA].numpy(),
                                      np.asarray(ba))
        assert (live[1:] == 0).all()
        assert ctrl.tolist() == [0, int(step), int(act), int(stall), 0, 0, 0,
                                 -1, int(rec[3]), int(rec[4]), 0]
    # a block that is done or full starts nothing
    blk[kb.BLK_DONE] = 1
    before = (ctrl.clone(), state.clone(), live.clone())
    kb.block_start(ctrl, blk, state, live, ring, torch.zeros(v, dtype=torch.int32),
                   torch.from_numpy(init_ba))
    assert all(torch.equal(a, b) for a, b in zip((ctrl, state, live), before))


def _epilogue(k, steps, status, used, k_min, strict):
    """``_block_kernel_body``'s epilogue (compact.py:1799-1808): the row,
    the next budget and the stop flag."""
    success = status == int(AttemptStatus.SUCCESS)
    k_dec = (k - 1) if strict else (used - 1)
    stop = (not success) or (k_dec < k_min)
    return [k, steps, status, used], (k_dec if success else k), stop


@pytest.mark.parametrize("case", ["success", "failure", "floor", "fixup",
                                  "closed"])
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "jump"])
def test_block_record_plain_follows_the_epilogue(case, strict):
    rng = np.random.default_rng(hash((case, strict)) % 2**32)
    v, attempts = 500, 3
    for trial in range(8):
        words = np.where(rng.random((2, v)) < 0.2, -1,
                         rng.integers(0, 60, (2, v))).astype(np.int32)
        state = torch.from_numpy(np.concatenate(
            [words, np.array([[-1, 0], [-1, 0]], np.int32)], axis=1))
        cur = int(rng.integers(0, 2))
        status = {"success": 1, "failure": 2, "floor": 1,
                  "fixup": 0, "closed": 1}[case]
        prev = int(rng.choice([0, 5])) if case == "fixup" else 3
        k = int(rng.integers(5, 40))
        ctrl = kc.new_ctrl(step=int(rng.integers(1, 50)), prev_active=prev,
                           device="cpu")
        ctrl[kc.CTRL_STATUS], ctrl[kc.CTRL_CUR] = status, cur
        buf, _, blk = kb.new_block(k, attempts,
                                   torch.tensor([0, -1], dtype=torch.int32))
        ai = int(rng.integers(0, attempts))
        blk[kb.BLK_N_ATT] = attempts if case == "closed" else ai
        best = torch.full((v + 2,), 5, dtype=torch.int32)
        pe = state[cur].clone()
        used = int(np.where(words[cur] >= 0, words[cur] >> 1, -1).max()) + 1
        k_min = k + 5 if case == "floor" else int(rng.integers(-1, 3))
        before = blk.clone()
        kb.block_record(ctrl, state, blk, best, k_min, strict)
        if case == "closed":
            assert torch.equal(blk, before) and (best == 5).all()
            continue
        final = status if status else (1 if prev == 0 else 3)
        row, k_next, stop = _epilogue(k, int(ctrl[kc.CTRL_STEP]), final,
                                      used, k_min, strict)
        got = blk.tolist()
        assert kb.attempt_rows(got)[ai] == row
        assert (got[kb.BLK_N_ATT], got[kb.BLK_K], got[kb.BLK_DONE]) == \
            (ai + 1, k_next, int(stop))
        assert torch.equal(best, pe) == (final == 1)
        if final != 1:
            assert (best == 5).all()


def test_auto_attempts_per_dispatch_equals_jax():
    # k0 = 12 is the one exact tie (saved(4) is 90 % of saved(6)): the JAX
    # original multiplies by its 65 ms first and rounds it to 5; priced in
    # units of the overhead it is 4 at any overhead
    want = [jsm.auto_attempts_per_dispatch(k0) for k0 in range(1, 5001)]
    assert want[11] == 5
    want[11] = 4
    for overhead in (1e-6, tcli.ATTEMPT_HOST_COST_S, 65e-3, 3.0):
        assert [auto_attempts_per_dispatch(k0, overhead_s=overhead)
                for k0 in range(1, 5001)] == want
    assert auto_attempts_per_dispatch(2, overhead_s=65e-3, compile_s=1.0) == \
        jsm.auto_attempts_per_dispatch(2, compile_s=1.0) == 1


# ---- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--attempts-per-dispatch", "3"],
    ["--attempts-per-dispatch", "3", "--strict-decrement"],
    ["--attempts-per-dispatch", "auto", "--strict-decrement"],
    ["--attempts-per-dispatch", "2", "--strict-decrement",
     "--compat-failed-output"],
], ids=["jump-3", "strict-3", "strict-auto", "strict-2-compat"])
def test_cli_blocked_writes_the_jax_cli_coloring(tmp_path, capsys, extra):
    from dgc_tpu import cli as jcli

    common = ["--node-count", "150", "--max-degree", "9", "--seed", "7",
              "--backend", "ell-compact", *extra]
    assert jcli.main(common + ["--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output-coloring",
                               str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert "Minimal number of colors:" in capsys.readouterr().out


def test_cli_bad_attempts_per_dispatch_exits_2(tmp_path, capsys):
    from dgc_tpu import cli as jcli

    for bad in ("0", "-3", "two"):
        args = ["--node-count", "50", "--max-degree", "5", "--seed", "1",
                "--attempts-per-dispatch", bad, "--output-coloring",
                str(tmp_path / "c.json")]
        assert jcli.main(args) == 2
        jax_err = capsys.readouterr().err
        assert tcli.main(args + ["--device", "cpu"]) == 2
        err = capsys.readouterr().err.strip()
        assert err in jax_err and f"got {bad!r}" in err
    assert not (tmp_path / "c.json").exists()
