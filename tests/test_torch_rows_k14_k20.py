"""K14 (``lane_compact``) and K20 (``shard_superstep``) under the contracts
of their redesigned kernels, on the CPU, held byte for byte against
``dgc_tpu``:

- K14's plain version against ``dgc_tpu.serve.batched._rebuild_idx``, lane
  by lane, on lanes of random phases, ``idx_rung``s and active counts above
  and below the executed rung's pad, at every staged rung, in batches
  where only some lanes rebuild; a launch past the live word or on the
  full-table rung changes nothing. The scratch K14 takes
  (``new_compact_scratch``, made with the lanes): its epoch counts the
  launches that rebuilt, two in a row included, and lanes made again for
  a resized pool start a scratch of their own.
- K20's plain version, given the plan (each row's real length,
  ``real_lengths``), against ``dgc_tpu.engine.sharded._shard_superstep``
  with the loop-invariant ``pre_beats`` of ``_flat_pipeline``, on every
  shard of a 4-device mesh (row offsets 0 to 3 V_l): ragged rows,
  isolated vertices, equal-degree ties, a capped window with the fail
  gate off. A plan whose length cuts off a real entry is rejected.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` (``_k14_cases``, ``_k20_team_cases``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgc_tpu.engine.fused import _SHARD_MAP_KW, _shard_map
from dgc_tpu.engine.sharded import _shard_superstep
from dgc_tpu.ops.speculative import beats_rule
from dgc_tpu.parallel.mesh import VERTEX_AXIS, make_mesh
from dgc_tpu.serve import batched as jb
from dgc_tpu_torch.kernels import serve as ks
from dgc_tpu_torch.kernels import shard as ksh
from dgc_tpu_torch.kernels.superstep import real_lengths
from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_IDX_RUNG, CARRY_LEN,
                                  CARRY_P1, CARRY_P2, CARRY_PACKED,
                                  CARRY_PHASE)
from dgc_tpu_torch.serve import batched as B

STAGES = ((None, 1024), (1024, 256), (256, 64), (64, 0))  # of v2048
V = 2048


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from contending with the test runner's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- K14 --------------------------------------------------------------------

def _words(rng, b: int, v: int, counts) -> np.ndarray:
    """``b`` lanes of packed words with ``counts[lane]`` active rows
    (uncolored or fresh) at random places, the rest confirmed."""
    out = np.empty((b, v), dtype=np.int32)
    for lane in range(b):
        active = np.zeros(v, dtype=bool)
        active[rng.choice(v, size=int(counts[lane]), replace=False)] = True
        col = rng.integers(0, 40, v)
        out[lane] = np.where(active, np.where(rng.random(v) < 0.5, -1,
                                              col * 2 + 1), col * 2)
    return out


def _lanes(rng, b: int, rung: int, counts, phase, idx_rung):
    """CPU lanes of the v2048 class at ``rung`` of ``STAGES``: the live
    word set, the given active counts, phases and ``idx_rung``s, slot
    lists of random stale contents."""
    stages, _pads, a0 = B.resolve_stages(STAGES, V)
    carry = [np.zeros((b, a0) if j == CARRY_IDX else
                      (b, V) if j in (CARRY_PACKED, CARRY_P1, CARRY_P2)
                      else (b,), dtype=np.int32) for j in range(CARRY_LEN)]
    carry[CARRY_PACKED][:] = _words(rng, b, V, counts)
    carry[CARRY_IDX][:] = rng.integers(0, V + 1, (b, a0))
    carry[CARRY_PHASE][:] = phase
    carry[CARRY_IDX_RUNG][:] = idx_rung
    ctrl = ks.ladder_ctrl(stages, "cpu")
    ctrl[ks.CTRL_LIVE] = 1
    ctrl[ks.CTRL_REXEC] = rung
    t = lambda x: torch.tensor(np.asarray(x, np.int32))
    zeros = np.zeros(b, np.int32)
    return ks.new_lanes([t(c) for c in carry],
                        t(np.full((b, V, 8), V)), t(np.zeros((b, V))),
                        t(zeros), t(zeros), t(zeros), ctrl, planes=1,
                        stall_window=64, budget=1)


def _jax_rebuild(L, before: list) -> list:
    """Each lane's slot list after the stage-entry recompaction as
    ``dgc_tpu.serve.batched`` runs it (``_superstep_body``'s staged
    branch): ``_rebuild_idx`` where the lane is live and its list was
    built at a shallower rung, its old list elsewhere."""
    ctrl = L.ctrl.tolist()
    s = ctrl[ks.CTRL_REXEC]
    pad = ctrl[ks.CTRL_PAD0 + s]
    packed, phase, idx_rung, idx = before
    out = []
    for lane in range(L.b):
        if ctrl[ks.CTRL_LIVE] and pad and phase[lane] < 2 and \
                idx_rung[lane] < s:
            out.append(np.asarray(jb._rebuild_idx(
                jnp.asarray(packed[lane]), v=L.v, pad=pad, a0=L.a0)))
        else:
            out.append(idx[lane])
    return out


def _held_k14(L) -> bool:
    """K14 (its plain version, on the CPU) on ``L`` against
    ``_jax_rebuild``; True iff a lane rebuilt."""
    before = [L.carry[j].numpy().copy() for j in (CARRY_PACKED, CARRY_PHASE,
                                                  CARRY_IDX_RUNG, CARRY_IDX)]
    want = _jax_rebuild(L, before)
    ctrl = L.ctrl.tolist()
    s = ctrl[ks.CTRL_REXEC]
    rebuilt = [lane for lane in range(L.b)
               if ctrl[ks.CTRL_LIVE] and ctrl[ks.CTRL_PAD0 + s]
               and before[1][lane] < 2 and before[2][lane] < s]
    ks.lane_compact(L)
    for lane in range(L.b):
        assert np.array_equal(L.carry[CARRY_IDX][lane].numpy(), want[lane]), \
            lane
    new_rung = L.carry[CARRY_IDX_RUNG].numpy()
    for lane in range(L.b):
        assert new_rung[lane] == (s if lane in rebuilt else before[2][lane])
    assert torch.equal(L.carry[CARRY_PACKED], torch.from_numpy(before[0]))
    return bool(rebuilt)


@pytest.mark.parametrize("rung", (1, 2, 3))
def test_k14_rebuild_equals_jax(rung):
    """Lanes of every phase and ``idx_rung``, active counts from none
    past the pad to every row: the rebuilding lanes' lists are
    ``_rebuild_idx``'s, the others' untouched."""
    rng = np.random.default_rng(100 + rung)
    pad = 1024 >> (2 * (rung - 1))
    counts = [0, 1, pad - 1, pad, pad + 1, 3 * pad // 2, V,
              int(rng.integers(0, V + 1)), 5, pad, pad + 7, 0]
    b = len(counts)
    phase = rng.integers(0, 3, b)
    phase[:4] = 0
    idx_rung = rng.integers(0, 4, b)
    idx_rung[:3] = rung - 1
    L = _lanes(rng, b, rung, counts, phase, idx_rung)
    assert _held_k14(L)
    assert not _held_k14(L)  # every live list is now at the rung


def test_k14_does_nothing_off_a_staged_live_rung():
    """Past the live word, or on the full-table rung (pad 0), no lane
    rebuilds and the epoch stays."""
    rng = np.random.default_rng(7)
    L = _lanes(rng, 4, 1, [10, 600, 2000, 3], [0, 1, 0, 1], [0, 0, 0, 0])
    L.ctrl[ks.CTRL_LIVE] = 0
    assert not _held_k14(L)
    L.ctrl[ks.CTRL_LIVE] = 1
    L.ctrl[ks.CTRL_REXEC] = 0
    assert not _held_k14(L)
    assert int(L.compact_scratch[0]) == 0


def test_k14_scratch_epoch_and_pool_resize():
    """The lanes' scratch is made with them (zeros); each launch that
    rebuilds takes the next epoch, two in a row included, one that
    rebuilds nothing leaves it; lanes made again for a resized pool
    (``slice_lanes``) have a scratch of their own, from zero, and the old
    one is left as it was. Every rebuild equals ``_rebuild_idx``."""
    rng = np.random.default_rng(9)
    L = _lanes(rng, 3, 1, [100, 1500, 0], [0, 0, 1], [0, 0, 0])
    assert L.compact_scratch.dtype == torch.int64
    assert L.compact_scratch.tolist() == [0, 0]
    assert _held_k14(L)
    L.ctrl[ks.CTRL_REXEC] = 2
    assert _held_k14(L)
    assert int(L.compact_scratch[0]) == 2
    assert not _held_k14(L)
    assert int(L.compact_scratch[0]) == 2
    # the epoch wraps past 2^32 - 1 to 1, never to 0
    L.compact_scratch[0] = (1 << 32) - 1
    L.ctrl[ks.CTRL_REXEC] = 3
    assert _held_k14(L)
    assert int(L.compact_scratch[0]) == 1

    # the pool resized to 5 lanes: new lanes through slice_lanes
    old = L.compact_scratch.clone()
    stages, _pads, a0 = B.resolve_stages(STAGES, V)
    b = 5
    carry = [torch.zeros((b, a0) if j == CARRY_IDX else
                         (b, V) if j in (CARRY_PACKED, CARRY_P1, CARRY_P2)
                         else (b,), dtype=torch.int32)
             for j in range(CARRY_LEN)]
    carry[CARRY_PACKED].copy_(torch.from_numpy(
        _words(rng, b, V, [300, 0, 1024, 1025, 2048])))
    carry[CARRY_IDX].fill_(V)
    z = np.zeros(b, np.int32)
    R = B.slice_lanes(np.full((b, V, 8), V, np.int32),
                      np.zeros((b, V), np.int32), z, z, z, carry,
                      planes=1, stages=STAGES, device="cpu")
    assert R.compact_scratch is not L.compact_scratch
    assert R.compact_scratch.tolist() == [0, 0]
    R.ctrl[ks.CTRL_LIVE] = 1
    R.ctrl[ks.CTRL_REXEC] = 1
    assert _held_k14(R)
    assert int(R.compact_scratch[0]) == 1
    assert torch.equal(L.compact_scratch, old)


# ---- K20 --------------------------------------------------------------------

N_SHARDS = 4


def _shard_case(rng, vl: int, width: int):
    """A 4-shard state: ragged rows of plain ids (real entries first, the
    sentinel V past them; rows of none among them, isolated vertices of
    degree 0), each row's degree its real length (ties throughout), words
    uncolored, fresh and confirmed with colors mostly low and some past a
    one-plane window."""
    v = N_SHARDS * vl
    real = rng.integers(0, width + 1, v)
    real[rng.random(v) < 0.1] = 0
    nbrs = np.where(np.arange(width) < real[:, None],
                    rng.integers(0, v, (v, width)), v).astype(np.int32)
    cols = np.where(rng.random(v) < 0.8, rng.integers(0, 5, v),
                    rng.integers(0, 80, v))
    kind = rng.random(v)
    packed = np.where(kind < 0.25, -1, np.where(kind < 0.65, cols * 2 + 1,
                                                cols * 2)).astype(np.int32)
    packed[real == 0] = 0
    return nbrs, real.astype(np.int32), packed


def _jax_step(nbrs, deg, packed, k: int, planes: int):
    """``_shard_superstep`` on a 4-device mesh with ``_flat_pipeline``'s
    ``pre_beats``: (new words, any fail, active, mc)."""
    mesh = make_mesh(N_SHARDS)

    def body(packed_l, nbrs_l, deg_l, deg_g):
        vl = nbrs_l.shape[0]
        shard = jax.lax.axis_index(VERTEX_AXIS)
        my_ids = (shard * vl + jnp.arange(vl, dtype=jnp.int32)).astype(
            jnp.int32)
        deg_g_pad = jnp.concatenate([deg_g, jnp.array([-1], jnp.int32)])
        pre_beats = beats_rule(deg_g_pad[nbrs_l], nbrs_l, deg_l[:, None],
                               my_ids[:, None])
        return _shard_superstep(packed_l, nbrs_l, pre_beats,
                                jnp.asarray(k, jnp.int32), planes)

    fn = jax.jit(_shard_map(body, mesh=mesh,
                            in_specs=(P(VERTEX_AXIS), P(VERTEX_AXIS, None),
                                      P(VERTEX_AXIS), P()),
                            out_specs=(P(VERTEX_AXIS), P(), P(), P()),
                            **_SHARD_MAP_KW))
    new, any_fail, active, mc = fn(packed, nbrs, deg, deg)
    return np.asarray(new), bool(any_fail), int(active), int(mc)


def _port_step(nbrs, deg, packed, k: int, planes: int, fail_valid: bool):
    """K20's plain version on every shard, each with its own control
    block and plan: (new words, fail count, active count, mc)."""
    v = len(deg)
    vl = v // N_SHARDS
    deg_g = torch.from_numpy(np.concatenate([deg, [-1]]).astype(np.int32))
    new = np.empty(v, np.int32)
    fail = active = 0
    mc = -1
    for s in range(N_SHARDS):
        rows = torch.from_numpy(nbrs[s * vl:(s + 1) * vl])
        lens = real_lengths(rows, v)
        state = ksh.new_shard_state(v, "cpu")
        state[0, :v] = torch.from_numpy(packed)
        ctrl = ksh.new_shard_ctrl(3, v, k, -1, "cpu")
        ksh.shard_superstep(ctrl, state, rows, lens, deg_g, s * vl, planes,
                            k, fail_valid)
        new[s * vl:(s + 1) * vl] = state[1, s * vl:(s + 1) * vl].numpy()
        fail += int(ctrl[ksh.CTRL_FAIL])
        active += int(ctrl[ksh.CTRL_ACTIVE])
        mc = max(mc, int(ctrl[ksh.CTRL_MC]))
    return new, fail, active, mc


@pytest.mark.parametrize("width,planes,k", [
    (6, 1, 7), (6, 1, 3), (12, 1, 40), (40, 2, 41), (40, 2, 64),
    (33, 3, 90)])
def test_k20_equals_jax(width, planes, k):
    """Every shard's new words and the reduced counters equal
    ``_shard_superstep``'s, row offsets 0 to 3 V_l; ``k`` past a one-plane
    window (capped, the fail gate off: no fail counted) and inside it."""
    rng = np.random.default_rng(width * 100 + k)
    if jax.device_count() < N_SHARDS:
        pytest.skip("needs the conftest's host devices")
    nbrs, deg, packed = _shard_case(rng, 37, width)
    fail_valid = k <= 32 * planes
    want = _jax_step(nbrs, deg, packed, k, planes)
    got = _port_step(nbrs, deg, packed, k, planes, fail_valid)
    assert np.array_equal(got[0], want[0])
    assert (got[1] > 0) == (want[1] and fail_valid)
    if not fail_valid:
        assert got[1] == 0
    assert got[2:] == want[2:]


def test_k20_plan_must_hold_every_real_entry():
    """A plan whose length cuts off a real entry is rejected; one that
    runs past the last real entry (over sentinels) is not."""
    rng = np.random.default_rng(3)
    nbrs, deg, packed = _shard_case(rng, 20, 8)
    v = len(deg)
    rows = torch.from_numpy(nbrs[:20])
    lens = real_lengths(rows, v)
    r = int(torch.nonzero(lens > 0)[0])
    deg_g = torch.from_numpy(np.concatenate([deg, [-1]]).astype(np.int32))

    def step(plan):
        state = ksh.new_shard_state(v, "cpu")
        state[0, :v] = torch.from_numpy(packed)
        ctrl = ksh.new_shard_ctrl(3, v, 9, -1, "cpu")
        ksh.shard_superstep(ctrl, state, rows, plan, deg_g, 0, 1, 9, True)
        return state, ctrl

    cut = lens.clone()
    cut[r] -= 1
    with pytest.raises(AssertionError, match="cut off a real entry"):
        step(cut)
    assert lens.tolist() == [int(x) for x in deg[:20]]
    past = torch.full_like(lens, 8)
    a, b = step(lens), step(past)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
