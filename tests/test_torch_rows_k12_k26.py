"""K12 (``dense_resolve``) and the lane mesh's fold (K26, the tail of the
partial K15/K16) on the CPU, against ``dgc_tpu``.

- K12's plain version against the resolve lines of the JAX dense body
  (``dgc_tpu.engine.dense_engine._attempt_kernel_dense``, :76-92: the
  priority conflict mask, the new colors, the status) on the rows the
  card's layout makes special: a row whose only beater sits in the last
  16-byte word of its row, one beaten by the neighbor in its own word, equal
  degrees decided by id, a hub row of thousands of neighbors, a
  same-candidate neighbor that is colored (cand -1 in the port), V off a
  16-byte word and off the 256-vertex tile, V = 16,384 with candidates and
  degrees near 16,383 (the card keeps candidates as int16), and a failed
  step, which leaves both buffers as they were. The JAX lines run over
  blocks of rows, so no V x V intermediate is made.
- The fold: the plain partial K15/K16 with their mesh (``mesh=``: each
  shard's partial, then the last shard's fold in its tail) equal the JAX
  package's ``_sharded`` twins at n = 1, 2 and 4 (a shard of dead lanes
  among them), slice by slice; the last shard's fold and its count; a round
  past the live word is a fixed point that folds nothing.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.serve import batched as jb
from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels import dense as kd
from dgc_tpu_torch.kernels import serve as ks
from dgc_tpu_torch.layout import CARRY_LEN, CARRY_PHASE, T_PREV, T_US
from dgc_tpu_torch.models.generators import generate_random_graph
from dgc_tpu_torch.serve import batched as B
from dgc_tpu_torch.serve.shape_classes import (ShapeClass, dummy_member,
                                               pad_member)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from contending with the test runner's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- K12 ------------------------------------------------------------------------

BLOCK = 1024  # rows of the JAX lines at a time


@jax.jit
def _jax_keep(adj_rows, rows, degrees, colors, cand):
    """``keep`` of :76-79 for the rows ``rows`` (their adjacency rows
    ``adj_rows``), line for line with ``beats`` (:55) cut to those rows."""
    ids = jnp.arange(degrees.shape[0], dtype=jnp.int32)
    d_rows = degrees[rows]
    beats = (degrees[None, :] > d_rows[:, None]) | (
        (degrees[None, :] == d_rows[:, None]) & (ids[None, :] < rows[:, None]))
    uncol = colors < 0
    same_cand = cand[None, :] == cand[rows][:, None]
    beaten = (adj_rows > 0) & uncol[None, :] & same_cand & beats
    return ~jnp.any(beaten, axis=1)


@partial(jax.jit, static_argnames=("max_steps",))
def _jax_new(keep, colors, cand, fail_v, step, max_steps: int):
    """:80-92: the new colors and the status."""
    uncol = colors < 0
    any_fail = jnp.any(uncol & fail_v)
    new_colors = jnp.where(uncol & keep & ~fail_v, cand, colors)
    uncol_after = jnp.sum(new_colors < 0)
    status = jnp.where(any_fail, int(AttemptStatus.FAILURE), jnp.where(
        uncol_after == 0, int(AttemptStatus.SUCCESS),
        jnp.where(step + 1 >= max_steps, int(AttemptStatus.STALLED),
                  int(AttemptStatus.RUNNING)))).astype(jnp.int32)
    return jnp.where(any_fail, colors, new_colors), status


def _adj_rows(edges: np.ndarray, r0: int, r1: int, v: int) -> np.ndarray:
    """Rows [r0, r1) of the symmetric 0/1 adjacency of ``edges``."""
    out = np.zeros((r1 - r0, v), np.float32)
    for a, b in (edges.T, edges[:, ::-1].T):
        m = (a >= r0) & (a < r1)
        out[a[m] - r0, b[m]] = 1
    return out


def _jax_resolve(edges, v, degrees, colors, cand, fail_v, step, max_steps):
    keep = np.concatenate([np.asarray(_jax_keep(
        jnp.asarray(_adj_rows(edges, r0, min(v, r0 + BLOCK), v),
                    jnp.bfloat16),
        jnp.arange(r0, min(v, r0 + BLOCK), dtype=jnp.int32),
        degrees, colors, cand)) for r0 in range(0, v, BLOCK)])
    new, status = _jax_new(jnp.asarray(keep), colors, cand, fail_v,
                           jnp.int32(step), max_steps)
    return np.asarray(new), int(status)


def _port_resolve(edges, v, degrees, colors, cand, fail_v, step, max_steps):
    """K12's plain version on the port's buffers: colors in buffer ``step
    % 2``, cand -1 for the colored rows and the pads, K11's fail count in
    the control block. Returns (new colors, status, both buffers before,
    both after)."""
    vp = kd.padded_size(v)
    adj = kd.dense_adjacency(*_csr(edges, v), vp, "cpu")
    cur = step % 2
    state = torch.full((2, vp), -1, dtype=torch.int32)
    state[cur, :v] = torch.from_numpy(colors)
    state[1 - cur, :v] = 7  # the other buffer's stale words
    c = torch.full((vp,), -1, dtype=torch.int32)
    c[:v] = torch.from_numpy(np.where(colors < 0, cand, -1))
    deg = torch.zeros(vp, dtype=torch.int32)
    deg[:v] = torch.from_numpy(degrees)
    ctrl = kd.new_dense_ctrl("cpu")
    ctrl[kd.DCTRL_CUR], ctrl[kd.DCTRL_STEP] = cur, step
    ctrl[kd.DCTRL_FAIL] = int(((colors < 0) & fail_v).sum())
    before = state.clone()
    kd.dense_resolve(ctrl, state, adj, c, deg, v, max_steps)
    now = int(ctrl[kd.DCTRL_CUR])
    return (state[now, :v].numpy(), int(ctrl[kd.DCTRL_STATUS]), before,
            state)


def _csr(edges: np.ndarray, v: int):
    both = np.concatenate([edges, edges[:, ::-1]])
    both = np.unique(both, axis=0)
    indptr = np.zeros(v + 1, np.int64)
    np.add.at(indptr, both[:, 0] + 1, 1)
    return np.cumsum(indptr), both[:, 1]


def _draw(rng, v: int, hubs: int, lo: int, hi: int, dlo: int, dhi: int):
    """A random graph on the rows below ``base`` (v - 16 down to a multiple
    of 8: about 12 neighbors a row, ``hubs`` rows of a third of the graph),
    degrees from [dlo, dhi), 60 % of the rows uncolored, every row's
    candidate from [lo, hi) (the JAX body's cand holds one for a colored
    row too), colors below ``hi``; then the edge rows past ``base``:

    - a = base: its only same-candidate neighbor is v - 1 (the last 16-byte
      word of the row where v is a multiple of 8), which beats it;
    - b = base + 5: beaten by base + 4, in its own word, at an equal degree
      and a lower id; c = base + 6: not beaten by base + 7 (a higher id);
    - d = base + 9: its neighbor base + 2 is colored with d's candidate as
      its candidate and its color: no beater.

    Returns (edges, degrees, colors, cand, rows a-d)."""
    base = (v - 16) & ~7
    src = [rng.integers(0, base, 6 * v)]
    dst = [rng.integers(0, base, 6 * v)]
    for _ in range(hubs):
        n = v // 3
        src.append(np.full(n, rng.integers(0, base)))
        dst.append(rng.choice(base, size=n, replace=False))
    edges = np.stack([np.concatenate(src), np.concatenate(dst)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    degrees = rng.integers(dlo, dhi, v).astype(np.int32)
    colors = np.where(rng.random(v) < 0.6, -1,
                      rng.integers(0, hi, v)).astype(np.int32)
    cand = rng.integers(lo, hi, v).astype(np.int32)
    a, b, c, d, e = base, base + 5, base + 6, base + 9, base + 2
    extra = []
    for row, nb, both, d_row, d_nb in ((a, v - 1, hi - 1, dlo, dhi - 1),
                                       (b, base + 4, lo, dlo, dlo),
                                       (c, base + 7, lo + 1, dlo, dlo)):
        extra.append((row, nb))
        cand[row] = cand[nb] = both
        degrees[row], degrees[nb] = d_row, d_nb
        colors[row] = colors[nb] = -1
    extra.append((d, e))
    cand[d] = cand[e] = hi - 2
    colors[d], colors[e] = -1, hi - 2
    return (np.concatenate([edges, np.array(extra)]), degrees, colors, cand,
            (a, b, c, d))


# (v, hub rows, candidates from [lo, hi), degrees from [dlo, dhi))
K12_DRAWS = {
    "v512 on the tile": (512, 0, 0, 5, 0, 3),
    "v1003 off the word and tile": (1003, 1, 0, 6, 0, 4),
    "v5000 hub rows": (5000, 3, 0, 40, 0, 9),
    "v16384 int16 edge": (16384, 2, 16376, 16384, 16370, 16384),
}


@pytest.mark.parametrize("name", sorted(K12_DRAWS))
def test_plain_resolve_equals_the_jax_lines(name):
    v, hubs, lo, hi, dlo, dhi = K12_DRAWS[name]
    rng = np.random.default_rng(sorted(K12_DRAWS).index(name))
    edges, degrees, colors, cand, (a, b, c, d) = _draw(rng, v, hubs, lo, hi,
                                                       dlo, dhi)
    fail_v = np.zeros(v, bool)
    for step, max_steps in ((0, 64), (3, 4)):  # the second stalls
        want, status = _jax_resolve(edges, v, jnp.asarray(degrees),
                                    jnp.asarray(colors), jnp.asarray(cand),
                                    jnp.asarray(fail_v), step, max_steps)
        got, got_status, _b, _a = _port_resolve(edges, v, degrees, colors,
                                                cand, fail_v, step, max_steps)
        np.testing.assert_array_equal(got, want)
        assert got_status == status
        assert [int(got[r]) for r in (a, b, c, d)] == [-1, -1, cand[c],
                                                      cand[d]]
    if hubs:
        assert np.bincount(edges[:, 0], minlength=v).max() >= v // 3


def test_failed_resolve_writes_nothing():
    v = 1003
    rng = np.random.default_rng(5)
    edges, degrees, colors, cand, _rows = _draw(rng, v, 1, 0, 6, 0, 4)
    fail_v = np.zeros(v, bool)
    fail_v[np.flatnonzero(colors < 0)[:3]] = True  # K11 found no color
    want, status = _jax_resolve(edges, v, jnp.asarray(degrees),
                                jnp.asarray(colors), jnp.asarray(cand),
                                jnp.asarray(fail_v), 2, 64)
    got, got_status, before, after = _port_resolve(edges, v, degrees, colors,
                                                   cand, fail_v, 2, 64)
    assert status == got_status == int(AttemptStatus.FAILURE)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, colors)
    assert torch.equal(before, after)


# ---- the fold --------------------------------------------------------------------

CLS = ShapeClass(v_pad=512, w_pad=8)
STAGES = ((None, 256), (256, 64), (64, 0))


def _batch(n_graphs: int, b: int = 8):
    """Padded members of ``CLS``, dummies past the graphs: the last shards
    of a 4-shard mesh hold dead lanes only."""
    graphs = [generate_random_graph(240 + 40 * i, 8, seed=30 + i)
              for i in range(n_graphs)]
    members = [pad_member(g, CLS) for g in graphs]
    members += [dummy_member(CLS)] * (b - len(members))
    return (np.stack([m.comb for m in members]),
            np.stack([m.degrees for m in members]),
            np.array([m.k0 for m in members], np.int32),
            np.array([m.max_steps for m in members], np.int32))


def _whole(carry) -> list:
    if isinstance(carry[0], (list, tuple)) and isinstance(
            carry[0][0], torch.Tensor):
        return [np.concatenate([B.to_host(c[j]) for c in carry])
                for j in range(CARRY_LEN)]
    return [np.asarray(a) for a in carry]


@pytest.mark.skipif(jax.device_count() < 4,
                    reason="needs 4 (virtual) host devices")
@pytest.mark.parametrize("n", (1, 2, 4))
def test_plain_partial_and_fold_equal_the_sharded_twins(n):
    """Slices of two supersteps through a three-rung ladder: the port's
    sharded slice (each shard's plain partial K16/K15, the last one's fold
    in its tail) equal to ``dgc_tpu``'s ``batched_slice_kernel_sharded``
    slice by slice; the folds counted, one a round that ran."""
    inputs = _batch(5)
    jmesh, mesh = jb.lane_mesh(n), B.lane_mesh(n, device="cpu")
    a0 = B.stage_idx_width(STAGES)
    c_ref = jb.idle_carry(8, CLS.v_pad, a0)
    c_port = B.idle_carry(8, CLS.v_pad, a0)
    reset = np.ones(8, np.int32)
    ks.reset_launch_counts()
    for it in range(200):
        kw = dict(planes=CLS.planes, slice_steps=2, stages=STAGES)
        c_ref = jb.batched_slice_kernel_sharded(jmesh, *inputs, reset, c_ref,
                                                **kw)
        c_port = B.batched_slice_kernel_sharded(mesh, *inputs, reset, c_port,
                                                **kw)
        got, want = _whole(c_port), _whole(c_ref)
        for j in range(CARRY_LEN):
            if j not in (T_US, T_PREV):
                assert np.array_equal(got[j], want[j]), (it, j)
        reset = np.zeros(8, np.int32)
        if (got[CARRY_PHASE] >= 2).all():
            break
    else:
        pytest.fail("the batch never finished")
    # a fold for every slice entry and every live round
    assert ks.mesh_folds() > it + 1
    assert set(ks.launch_counts.values()) == {0}  # the CPU launches nothing


def _mesh(n: int):
    comb, degrees, k0, ms = _batch(3)
    a0 = B.stage_idx_width(STAGES)
    carry = B.idle_carry(8, CLS.v_pad, a0)
    return B.mesh_lanes(B.lane_mesh(n, device="cpu"), comb, degrees, k0, ms,
                        np.ones(8, np.int32), carry, planes=CLS.planes,
                        stages=STAGES)


@pytest.mark.parametrize("n", (1, 2, 4))
def test_tail_fold_by_the_last_shard(n):
    """The plain tail: each shard's partial in turn, the last one folding
    (``lane_mesh_fold_reference`` over the partials) and counting one fold;
    the same as the partials alone followed by the plain fold. No mesh
    ticket is taken on one device."""
    M, P = _mesh(n), _mesh(n)
    ks.reset_launch_counts()
    for i, (L, Q) in enumerate(zip(M.shards, P.shards)):
        ks.lane_reset(L, mesh=M)
        ks.lane_reset_reference(Q, False, partial=True)
        assert ks.mesh_folds() == int(i == n - 1)
    ks.lane_mesh_fold_reference([Q.ctrl for Q in P.shards])
    assert int(M.shards[0].ctrl[ks.CTRL_MESH_TICKET]) == 0
    for L, Q in zip(M.shards, P.shards):
        assert torch.equal(L.ctrl, Q.ctrl)
        assert torch.equal(L.ctrl, M.ctrl)


@pytest.mark.parametrize("n", (2, 4))
def test_round_past_the_live_word_is_a_fixed_point(n):
    """Once a whole sweep's live word has dropped, one more round (the
    rounds continuous mode enqueues past it) changes no word and folds
    nothing; the plain fold of folded words changes nothing either."""
    M = _mesh(n)
    M.set_budget(ks.INT32_MAX)
    ks.mesh_reset(M)
    while int(M.ctrl[ks.CTRL_LIVE]):
        ks.mesh_superstep(M, staged=True)
    before = [[t.clone() for t in L.carry] + [L.ctrl.clone()]
              for L in M.shards]
    folds = ks.mesh_folds()
    ks.mesh_superstep(M, staged=True)
    ks.lane_mesh_fold_reference([L.ctrl for L in M.shards])
    assert ks.mesh_folds() == folds
    for L, b in zip(M.shards, before):
        assert all(torch.equal(x, y) for x, y in zip(list(L.carry) + [L.ctrl],
                                                       b))
