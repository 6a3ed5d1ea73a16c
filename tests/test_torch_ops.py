"""The port's plain superstep ops equal ``dgc_tpu``'s, bit for bit.

Inputs are drawn with numpy from fixed seeds and go through the JAX
function and its PyTorch counterpart; every comparison is exact (the rule
is int32 and bit work). The JAX package keeps its planes as uint32; the
port keeps the same 32 bits as int32, so planes are compared as int32 bit
patterns.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dgc_tpu.engine import bucketed as jbk  # noqa: E402
from dgc_tpu.models.generators import generate_random_graph  # noqa: E402
from dgc_tpu.ops import bitmask as jbm  # noqa: E402
from dgc_tpu.ops import speculative as jsp  # noqa: E402
from dgc_tpu_torch.engine.base import AttemptStatus  # noqa: E402
from dgc_tpu_torch.kernels import superstep as ks  # noqa: E402
from dgc_tpu_torch.ops import bitmask as tbm  # noqa: E402
from dgc_tpu_torch.ops import speculative as tsp  # noqa: E402

PLANES = (1, 2, 3, 32)
CASES = sorted({(p, k) for p in PLANES
                for k in (0, 1, 31, 32, 33, 32 * p, 32 * p + 7)})


def bits(x) -> np.ndarray:
    """A uint32 JAX array as int32 bit patterns."""
    return np.asarray(x).astype(np.uint32).view(np.int32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def packed_block(rng, v: int, w: int, planes: int):
    """(packed int32[v], gathered int32[v, w], beats bool[v, w]) with colors
    reaching past the window, uncolored entries and whole pad rows."""
    def words(shape):
        col = rng.integers(0, 32 * planes + 40, size=shape)
        fresh = rng.integers(0, 2, size=shape)
        return np.where(rng.random(shape) < 0.3, -1,
                        col * 2 + fresh).astype(np.int32)
    gathered = words((v, w))
    gathered[rng.random(v) < 0.1] = -1
    return words(v), gathered, rng.random((v, w)) < 0.5


@pytest.mark.parametrize("planes,k", CASES)
def test_plane_masks(planes, k):
    np.testing.assert_array_equal(tbm.plane_masks(k, planes).numpy(),
                                  bits(jbm.plane_masks(k, planes)))


@pytest.mark.parametrize("planes", PLANES)
def test_forbidden_planes(planes):
    rng = np.random.default_rng(planes)
    nc = rng.integers(-3, 32 * planes + 40, size=(60, 24)).astype(np.int32)
    nc[5] = -1
    np.testing.assert_array_equal(
        tbm.forbidden_planes(t(nc), planes).numpy(),
        bits(jbm.forbidden_planes(jnp.asarray(nc), planes)))


@pytest.mark.parametrize("planes,k", CASES)
def test_first_fit(planes, k):
    rng = np.random.default_rng(1000 + 7 * planes + k)
    forb = rng.integers(0, 1 << 32, size=(80, planes), dtype=np.uint64)
    forb[rng.random((80, planes)) < 0.4] = 0xFFFFFFFF   # full planes
    forb[:8] = 0xFFFFFFFF                               # fully forbidden rows
    forb32 = forb.astype(np.uint32)
    cand, fail = tbm.first_fit(t(forb32.view(np.int32)), k)
    jc, jf = jbm.first_fit(jnp.asarray(forb32), k)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(fail.numpy(), np.asarray(jf))


@pytest.mark.parametrize("planes", PLANES)
def test_neighbor_stats(planes):
    rng = np.random.default_rng(2000 + planes)
    packed, gathered, beats = packed_block(rng, 70, 20, planes)
    mycol = packed >> 1
    ours = tsp.neighbor_stats(t(gathered), t(beats), t(mycol), planes)
    ref = jsp.neighbor_stats(jnp.asarray(gathered), jnp.asarray(beats),
                             jnp.asarray(mycol), planes)
    np.testing.assert_array_equal(ours[0].numpy(), bits(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), bits(ref[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("planes,k", CASES)
def test_apply_update_mc(planes, k):
    rng = np.random.default_rng(3000 + 7 * planes + k)
    packed, gathered, beats = packed_block(rng, 90, 16, planes)
    fa, fo, clash = jsp.neighbor_stats(jnp.asarray(gathered),
                                       jnp.asarray(beats),
                                       jnp.asarray(packed >> 1), planes)
    ref = jsp.apply_update_mc(jnp.asarray(packed), fa, fo, clash, k)
    ours = tsp.apply_update_mc(t(packed), t(bits(fa)), t(bits(fo)),
                               t(np.asarray(clash)), k)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("planes,k", [(2, 33), (3, 70), (1, 5)])
def test_speculative_update_mc(planes, k):
    rng = np.random.default_rng(4000 + k)
    packed, gathered, beats = packed_block(rng, 64, 12, planes)
    ours = tsp.speculative_update_mc(t(packed), t(gathered), t(beats), k,
                                     planes)
    ref = jsp.speculative_update_mc(jnp.asarray(packed), jnp.asarray(gathered),
                                    jnp.asarray(beats), k, planes)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_apply_update_mc_empty_block():
    z = torch.zeros((0, 2), dtype=torch.int32)
    out = tsp.apply_update_mc(torch.zeros(0, dtype=torch.int32), z, z,
                              torch.zeros(0, dtype=torch.bool), 5)
    assert out[0].shape == (0,) and int(out[3]) == -1


_bucketed_superstep = jax.jit(jbk.bucketed_superstep,
                              static_argnames=("planes",))


@pytest.mark.parametrize("seed,k", [(0, 13), (1, 4), (2, 2)])
def test_superstep_plain_equals_bucketed_superstep(seed, k):
    """K1's plain version over every bucket (one state buffer read, the
    other written) equals ``bucketed_superstep``: BSP across buckets."""
    g = generate_random_graph(150, 10, seed=0, native=False)
    b = jbk.build_degree_buckets(g, native=False)
    planes = jbk.bucket_planes(b.combined)
    rng = np.random.default_rng(seed)
    packed = np.where(rng.random(150) < 0.4, -1,
                      rng.integers(0, 12, 150) * 2
                      + rng.integers(0, 2, 150)).astype(np.int32)
    new, fail_count, active = _bucketed_superstep(
        jnp.asarray(packed), tuple(jnp.asarray(c) for c in b.combined),
        jnp.int32(k), planes=planes)
    state = ks.new_state(t(packed))
    ctrl = ks.new_ctrl(step=1, prev_active=151, device="cpu")
    for r0, cb, p in zip(b.row0, b.combined, planes):
        fv = 32 * p >= cb.shape[1] + 1 or k <= 32 * p
        ks.superstep_rows(ctrl, state, t(cb), r0, p, k, fv,
                          ks.row_plan(t(cb), 150))
    np.testing.assert_array_equal(state[1, :150].numpy(), np.asarray(new))
    np.testing.assert_array_equal(state[0, :150].numpy(), packed)
    assert int(ctrl[ks.CTRL_FAIL]) == int(fail_count)
    assert int(ctrl[ks.CTRL_ACTIVE]) == int(active)
    assert int(state[0, 150]) == int(state[1, 150]) == -1


@pytest.mark.parametrize("any_fail", [False, True])
def test_status_step(any_fail):
    for active in (0, 1, 7):
        for stall in (0, 63, 64, 65):
            ours = ks.status_step(any_fail, active, stall, 64)
            ref = jbk.status_step(jnp.asarray(any_fail), jnp.int32(active),
                                  jnp.int32(stall), 64)
            assert int(ours) == int(ref)


@pytest.mark.parametrize("fail,active,prev,stall,step,max_steps,status", [
    (0, 5, 9, 0, 3, 100, AttemptStatus.RUNNING),   # progress: stall resets
    (0, 9, 9, 63, 3, 100, AttemptStatus.STALLED),  # 64 rounds, no progress
    (0, 0, 9, 0, 3, 100, AttemptStatus.SUCCESS),
    (2, 0, 9, 0, 3, 100, AttemptStatus.FAILURE),   # FAILURE beats SUCCESS
    (0, 5, 9, 0, 99, 100, AttemptStatus.STALLED),  # the ELL max_steps rule
])
def test_superstep_finish_plain(fail, active, prev, stall, step, max_steps,
                                status):
    ctrl = torch.tensor([0, step, prev, stall, 1, fail, active, 4],
                        dtype=torch.int32)
    ks.superstep_finish(ctrl, max_steps, 64)
    cur = 1 if fail else 0  # a failed step keeps the pre-step buffer
    new_stall = 0 if active < prev else stall + 1
    assert ctrl.tolist() == [int(status), step + 1, active, new_stall, cur,
                             0, 0, -1]
    before = ctrl.clone()
    if status != AttemptStatus.RUNNING:  # a finished attempt stays as it is
        ks.superstep_finish(ctrl, max_steps, 64)
        assert torch.equal(ctrl, before)
