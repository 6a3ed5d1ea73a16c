"""K1 (``superstep_rows``) under its plan on the CPU, against ``dgc_tpu``.

- (a) ``kernels.superstep.row_plan``: each row's real length equals a
  NumPy brute force (one past its last entry that is not the pad
  sentinel, sentinels inside a row included), and the teams of K1's grid
  (``k1_teams``: a group of ``team_lanes(width)`` lanes, or a block a row
  from ``K1_BLOCK_WIDTH``) walk every row exactly once. A plan whose
  length cuts off a real entry fails the plain version.
- (b) K1's plain version under the plan equals
  ``dgc_tpu.ops.speculative.speculative_update_mc`` over the table, byte
  for byte (the new words, the fail count where ``fail_valid``, the active
  count and ``mc``), at widths 1 to 8,192 (every team), 1, 2 and 32
  planes, budgets 1 to the window, uncolored, fresh and confirmed rows.
- (c) The ELL and bucketed engines' jump and strict sweeps equal
  ``dgc_tpu``'s on a seeded graph with a 4,097-entry hub row (K1's block
  team on the card). Both ELL engines run there at a one-plane window:
  ``dgc_tpu``'s full window would reduce [V, W, 129] elements a superstep
  on the CPU, and the port's plain version would build [V, 129, 32]
  words. A window only clamps budgets past it, so the attempts are the
  same as at the full window while every color stays below 32, which the
  test asserts.

Every value compared is an int32; intra-op threads are pinned to 1.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgc_tpu.engine.bucketed import BucketedELLEngine as JaxBucketed  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_minimal  # noqa: E402
from dgc_tpu.engine.superstep import ELLEngine as JaxELL  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.ops import speculative as jspec  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine.bucketed import BucketedELLEngine  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring  # noqa: E402
from dgc_tpu_torch.engine.superstep import ELLEngine  # noqa: E402
from dgc_tpu_torch.kernels import superstep as ks  # noqa: E402
from dgc_tpu_torch.ops.speculative import NBR_MASK  # noqa: E402

V = 3000  # the state's vertices in (a) and (b)
_update = jax.jit(jspec.speculative_update_mc, static_argnames=("num_planes",))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _table(rng, rows: int, width: int) -> np.ndarray:
    """Combined entries (neighbor id | beats bit 30) of random real
    lengths, pad sentinels among them, the sentinel ``V`` past each row's
    length; one row full and one empty."""
    nb = rng.integers(0, V, size=(rows, width))
    nb[rng.random((rows, width)) < 0.1] = V
    real = rng.integers(0, width + 1, rows)
    real[0] = width
    real[-1] = 0
    nb[np.arange(width)[None, :] >= real[:, None]] = V
    return (nb | rng.integers(0, 2, size=(rows, width)) << 30).astype(np.int32)


def _words(rng, n: int, max_color: int) -> np.ndarray:
    """A fifth uncolored, two fifths fresh, two fifths confirmed; most
    colors below 8, the rest anywhere below ``max_color``."""
    col = np.where(rng.random(n) < 0.8, rng.integers(0, 8, n),
                   rng.integers(0, max_color, n))
    kind = rng.integers(0, 5, n)
    return np.where(kind == 0, -1, col * 2 + kind % 2).astype(np.int32)


def _brute_lengths(table: np.ndarray) -> list[int]:
    out = []
    for row in table:
        real = [j for j, e in enumerate(row) if (e & NBR_MASK) != V]
        out.append(real[-1] + 1 if real else 0)
    return out


@pytest.mark.parametrize("width,rows", [
    (1, 50), (4, 70), (32, 257), (33, 100), (1024, 9), (1025, 9),
    (4095, 3), (4096, 3), (8192, 2)])
def test_row_plan_lengths_and_teams(width, rows):
    rng = np.random.default_rng(width)
    table = _table(rng, rows, width)
    plan = ks.row_plan(torch.from_numpy(table), V)
    assert plan.lens.tolist() == _brute_lengths(table)
    lanes = 1
    while lanes < 32 and 32 * lanes < width:
        lanes *= 2
    assert (plan.lanes, plan.block) == (lanes, width >= 4096)
    teams = ks.k1_teams(rows, width)
    seen = teams[teams >= 0]
    assert sorted(seen.tolist()) == list(range(rows))  # each row once
    per_block = 1 if plan.block else 8 * (32 // lanes)
    grid = ks.k1_grid(rows, width)
    assert len(teams) == grid * per_block and grid == -(-rows // per_block)


def test_a_plan_that_cuts_off_an_entry_fails():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(_table(rng, 20, 40))
    plan = ks.row_plan(table, V)
    cut = plan._replace(lens=plan.lens - (plan.lens > 0).to(torch.int32))
    state = ks.new_state(torch.full((V,), -1, dtype=torch.int32))
    ctrl = ks.new_ctrl(3, V, "cpu")
    with pytest.raises(AssertionError):
        ks.superstep_rows(ctrl, state, table, 0, 2, 10, True, cut)


@pytest.mark.parametrize("planes", [1, 2, 32])
@pytest.mark.parametrize("width", [1, 4, 32, 33, 4096, 8192])
def test_plain_k1_equals_speculative_update_mc(width, planes):
    rng = np.random.default_rng(100 * width + planes)
    rows = max(2, min(300, 12_000 // width))
    table = _table(rng, rows, width)
    words = _words(rng, V, 32 * planes + 40)
    row0 = int(rng.integers(0, V - rows + 1))
    padded = np.concatenate([words, [-1]]).astype(np.int32)
    nb = table & NBR_MASK
    gathered = jnp.asarray(padded[nb])
    beats = jnp.asarray((table >> 30) == 1)
    t = torch.from_numpy(table)
    plan = ks.row_plan(t, V)
    for k in (1, 32, 33, 64, 32 * planes):
        new, fail, active, mc = _update(jnp.asarray(words[row0: row0 + rows]),
                                        gathered, beats, jnp.int32(k),
                                        num_planes=planes)
        for fv in (False, True):
            cur = int(rng.integers(0, 2))
            state = torch.full((2, V + 1), -1, dtype=torch.int32)
            state[cur, :V] = torch.from_numpy(words)
            state[1 - cur, :V] = torch.from_numpy(rng.permutation(words))
            before = state[1 - cur].clone()
            ctrl = ks.new_ctrl(3, V, "cpu")
            ctrl[ks.CTRL_CUR] = cur
            ks.superstep_rows(ctrl, state, t, row0, planes, k, fv, plan)
            np.testing.assert_array_equal(
                state[1 - cur, row0: row0 + rows].numpy(), np.asarray(new))
            # the rest of the buffer and the current one untouched
            assert torch.equal(state[1 - cur, :row0], before[:row0])
            assert torch.equal(state[1 - cur, row0 + rows:],
                               before[row0 + rows:])
            assert torch.equal(state[cur, :V], torch.from_numpy(words))
            c = ctrl.tolist()
            assert c[ks.CTRL_FAIL] == (int(np.asarray(fail).sum()) if fv
                                       else 0)
            assert c[ks.CTRL_ACTIVE] == int(np.asarray(active).sum())
            assert c[ks.CTRL_MC] == max(-1, int(mc))


def _hub_graph() -> JaxArrays:
    """4,098 vertices: vertex 5 joined to every other one, and 300 random
    edges among those."""
    rng = np.random.default_rng(17)
    n = 4098
    leaves = np.setdiff1d(np.arange(n), [5])
    hub = np.stack([np.full(n - 1, 5), leaves], axis=1)
    rest = rng.integers(0, n, size=(300, 2))
    rest = rest[(rest[:, 0] != rest[:, 1]) & (rest != 5).all(axis=1)]
    return JaxArrays.from_edge_list(n, np.concatenate([hub, rest]))


_graph: list = []


def hub_graph() -> JaxArrays:
    if not _graph:
        _graph.append(_hub_graph())
    return _graph[0]


def _rows(result) -> list:
    return [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in result.attempts]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("kind", ["ell", "bucketed"])
def test_engines_with_a_wide_hub_row_equal_jax(kind, strict):
    g = hub_graph()
    assert g.max_degree == 4097
    arrays = convert.graph_from_numpy(g.indptr, g.indices)
    if kind == "ell":
        ref, ours = JaxELL(g), ELLEngine(arrays, device="cpu")
        ref.num_planes = ours.num_planes = 1  # see the module docstring
        assert ours.plan.lens.max() == 4097
    else:
        ref, ours = JaxBucketed(g), BucketedELLEngine(arrays, device="cpu")
        assert [p.block for p in ours.plans].count(True) == 1
        assert max(int(p.lens.max()) for p in ours.plans) == 4097
    k0 = g.max_degree + 1
    if strict:  # one by one from the jump's first count
        k0 = ref.attempt(k0).colors_used
    theirs = jax_minimal(ref, k0, strict_decrement=strict)
    mine = find_minimal_coloring(ours, k0, strict_decrement=strict)
    assert _rows(mine) == _rows(theirs)
    assert len(mine.attempts) >= 2 and mine.attempts[-1].status.name == \
        "FAILURE"
    assert max(a.colors_used for a in mine.attempts) < 32
    for a, b in zip(mine.attempts, theirs.attempts):
        np.testing.assert_array_equal(a.colors, b.colors)
    np.testing.assert_array_equal(mine.colors, theirs.colors)
