"""The port's segmented-gather plan (``dgc_tpu_torch.ops.segmented_gather``)
equals ``dgc_tpu.ops.segmented_gather``, bit for bit.

Random states and tables drawn with numpy from fixed seeds go through the
JAX function and its PyTorch counterpart over two plans, one collapsible
and one with capped windows (planes 1, 2 and 33, an empty segment), at
budgets 1, 31, 32, 33 and past every window, with rows holding only pad
sentinels. Every comparison is exact (the rule is int32 and bit work).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dgc_tpu.engine.bucketed import decode_combined as jax_decode  # noqa: E402
from dgc_tpu.ops import segmented_gather as jsg  # noqa: E402
from dgc_tpu_torch.ops import segmented_gather as tsg  # noqa: E402

BUDGETS = (1, 31, 32, 33, 5000)


# (sizes, widths, planes): windows covering their widths (planes 1, 2 and
# 33, an empty segment), and the same with every other window capped
PLANS = {
    False: ((37, 0, 3, 25), (60, 8, 1040, 31), (2, 1, 33, 1)),
    True: ((37, 5, 3, 25), (90, 8, 1100, 31), (2, 1, 33, 1)),
}


def random_inputs(rng, n: int, plan_rows: int, size: int, max_color: int):
    """(pe_src int32[n+2], seg int32[size], pk_rows int32[plan_rows])."""
    def words(count):
        col = rng.integers(0, max_color, size=count)
        w = col * 2 + rng.integers(0, 2, size=count)
        return np.where(rng.random(count) < 0.3, -1, w).astype(np.int32)
    pe = np.concatenate([words(n), [-1, 0]]).astype(np.int32)
    nb = rng.integers(0, n + 1, size=size)
    nb[rng.random(size) < 0.15] = n  # pad sentinels
    beats = rng.integers(0, 2, size=size)
    seg = (nb | (beats << 30)).astype(np.int32)
    return pe, seg, words(plan_rows)


def sentinel_rows(seg: np.ndarray, plan, n: int) -> np.ndarray:
    """Turn the first row of every segment into a row of pad sentinels."""
    seg = seg.copy()
    for s in plan:
        if s.rows:
            seg[s.flat0: s.flat0 + s.width] = n
    return seg


def run_both(pe, seg, plan_t, plan_j, pk, k):
    ours = tsg.segmented_update(torch.from_numpy(pe), torch.from_numpy(seg),
                                plan_t, torch.from_numpy(pk), k)
    ref = jsg.segmented_update(jnp.asarray(pe), jnp.asarray(seg), plan_j,
                               jnp.asarray(pk), jnp.int32(k), jax_decode)
    return ours, ref


@pytest.mark.parametrize("k", BUDGETS)
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_update_equals_jax(seed, capped, k):
    rng = np.random.default_rng(seed)
    sizes, widths, planes = PLANS[capped]
    plan_t = tsg.plan_from_parts(sizes, widths, planes)
    plan_j = jsg.plan_from_parts(sizes, widths, planes)
    assert tuple(map(tuple, plan_t)) == tuple(map(tuple, plan_j))
    assert tsg.plan_collapsible(plan_t) == jsg.plan_collapsible(plan_j)
    assert tsg.plan_collapsible(plan_t) != capped
    n = 700
    pe, seg, pk = random_inputs(rng, n, tsg.plan_rows(plan_t),
                                tsg.plan_size(plan_t),
                                32 * max(planes) + 40)
    seg = sentinel_rows(seg, plan_t, n)
    ours, ref = run_both(pe, seg, plan_t, plan_j, pk, k)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    assert [int(x) for x in ours[1:]] == [int(x) for x in ref[1:]]

    parts_t = tsg.segmented_update_parts(
        torch.from_numpy(pe), torch.from_numpy(seg), plan_t,
        torch.from_numpy(pk), k)
    parts_j = jsg.segmented_update_parts(
        jnp.asarray(pe), jnp.asarray(seg), plan_j, jnp.asarray(pk),
        jnp.int32(k), jax_decode)
    assert len(parts_t) == len(parts_j)
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        assert [int(x) for x in a[1:]] == [int(x) for x in b[1:]]


@pytest.mark.parametrize("k", BUDGETS)
def test_collapsed_and_per_segment_paths_agree(k):
    """On a collapsible plan the collapsed update equals the per-segment
    updates (the module's exactness argument)."""
    rng = np.random.default_rng(7)
    sizes, widths, planes = PLANS[False]
    plan = tsg.plan_from_parts(sizes, widths, planes)
    assert tsg.plan_collapsible(plan)
    pe, seg, pk = random_inputs(rng, 500, tsg.plan_rows(plan),
                                tsg.plan_size(plan), 32 * max(planes) + 40)
    args = (torch.from_numpy(pe), torch.from_numpy(seg), plan,
            torch.from_numpy(pk), k)
    new, fail, act, mc = tsg.segmented_update(*args)
    parts = tsg.segmented_update_parts(*args)
    np.testing.assert_array_equal(new.numpy(),
                                  torch.cat([p[0] for p in parts]).numpy())
    assert int(fail) == sum(int(p[1]) for p in parts)
    assert int(act) == sum(int(p[2]) for p in parts)
    assert int(mc) == max(int(p[3]) for p in parts)


def test_plan_helpers_equal_jax():
    ranges = ((0, 3, 40, 2), (3, 3, 8, 1), (3, 10, 4, 1))
    assert tuple(map(tuple, tsg.plan_from_ranges(ranges))) == \
        tuple(map(tuple, jsg.plan_from_ranges(ranges)))
    plan = tsg.plan_from_ranges(ranges)
    assert (tsg.plan_rows(plan), tsg.plan_size(plan),
            tsg.plan_max_planes(plan)) == (10, 3 * 40 + 7 * 4, 2)
    for w, p, k in ((40, 2, 5), (40, 1, 32), (40, 1, 33), (31, 1, 500),
                    (32, 1, 500), (1056, 33, 2000), (2000, 33, 1056)):
        assert tsg.fail_gate(w, p, k) == bool(jsg.fail_gate(w, p,
                                                            jnp.int32(k)))
    for bad in (((0, 2, 4, 1), (3, 5, 4, 1)),   # a gap
                ((0, 2, 0, 1),),                 # width 0
                ((0, 2, 4, 0),)):                # planes 0
        with pytest.raises(ValueError) as ours:
            tsg.plan_from_ranges(bad)
        with pytest.raises(ValueError) as ref:
            jsg.plan_from_ranges(bad)
        assert str(ours.value).split(":")[0] == str(ref.value).split(":")[0]
