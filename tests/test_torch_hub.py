"""The hub region's branches (``dgc_tpu_torch.engine.hub``) equal
``dgc_tpu.engine.compact``'s on the CPU, byte for byte.

- Each branch function — the full bucket, the row-compacted core, rebase
  with its capture, pruned on a capture, shrink with its tier-2 capture —
  against its JAX function, on every hub bucket of the K48 clique and of a
  2,000-vertex RMAT under the forced knobs of ``tests/test_compact.py``,
  from seeded random states and the fresh state; pads below and above the
  active count, ``ok`` both ways.
- The branch index (``hub_branch``) against the branch ``_hub_dispatch``
  takes, read off the JAX branch functions (each tagged through its
  ``mc``), over live counts, tiers and every ladder: no config (with and
  without a compaction pad), (P, U), (P, U, P2), pads that cover the
  bucket, unconditioned; every branch is reached.
- ``hub_dispatch`` against ``_hub_dispatch`` on real captures, all outputs.
- The plain hub kernels (``kernels.hub``) on the pool layout run the same
  branches as ``engine.hub`` on a bucket's own tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dgc_tpu.engine import compact as jc  # noqa: E402
from dgc_tpu.models.arrays import GraphArrays as JaxArrays  # noqa: E402
from dgc_tpu.models.generators import generate_rmat_graph  # noqa: E402
from dgc_tpu_torch.engine import hub as th  # noqa: E402
from dgc_tpu_torch.kernels import compact as kc  # noqa: E402
from dgc_tpu_torch.kernels import hub as kh  # noqa: E402


def _clique(n: int = 48) -> JaxArrays:
    return JaxArrays.from_edge_list(
        n, np.array([[i, j] for i in range(n) for j in range(i + 1, n)]))


GRAPHS = {
    "k48": (_clique, dict(flat_cap=4, prune_u_min=8, hub_uncond_entries=0,
                          stages=((None, 0),))),
    "rmat": (lambda: generate_rmat_graph(2000, avg_degree=10.0, seed=5,
                                         native=False),
             dict(flat_cap=8, prune_u_min=4, prune_p2_min=4,
                  hub_uncond_entries=0)),
}
_cache: dict = {}


def jax_engine(name: str):
    if name not in _cache:
        make, kw = GRAPHS[name]
        _cache[name] = jc.CompactFrontierEngine(make(), **kw)
    return _cache[name]


def _t(x) -> torch.Tensor:
    """A JAX array as a torch tensor, uint32 planes as their int32 bits."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def assert_same(ours, ref):
    """Nested tuples of tensors / JAX arrays, equal value for value."""
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert_same(a, b)
        return
    np.testing.assert_array_equal(np.asarray(_t(ref)), ours.numpy())


def _states(v: int, seed: int) -> list[np.ndarray]:
    """``packed_ext`` states: the fresh one (every vertex fresh color 0),
    then random mixes of uncolored, fresh and confirmed words at active
    shares from all to a few."""
    rng = np.random.default_rng(seed)
    out = [np.ones(v, np.int32)]
    for active in (1.0, 0.6, 0.2, 0.03):
        col = rng.integers(0, 70, size=v)
        act = rng.random(v) < active
        out.append(np.where(act, np.where(rng.random(v) < 0.4, -1,
                                          col * 2 + 1), col * 2)
                   .astype(np.int32))
    return [np.concatenate([s, [-1, 0]]).astype(np.int32) for s in out]


def _hub_cases(name: str):
    """(bucket index, cb, planes, row0, cfg) of the hub buckets under
    test: the widest, the one with the most rows, and the first with a
    tier-2 config (every one of the clique's)."""
    eng = jax_engine(name)
    rows = [cb.shape[0] for cb in eng.combined_buckets[:eng.hub_buckets]]
    tier2 = [bi for bi, cfg in enumerate(eng.hub_prune) if cfg and len(cfg) == 3]
    for bi in sorted({0, rows.index(max(rows))} | set(tier2[:1])):
        yield (bi, eng.combined_buckets[bi], eng.planes[bi], eng.row0s[bi],
               eng.hub_prune[bi])


# the JAX branch functions, compiled once per shape (eager calls would
# compile every op for every shape)
_jit = {name: jax.jit(getattr(jc, name), static_argnums=static)
        for name, static in (("_bucket_update", (3, 5)),
                             ("_compact_core", (3, 5, 6)),
                             ("_bucket_update_rebase", (3, 5, 6, 7)),
                             ("_bucket_update_pruned", (3, 5, 6)),
                             ("_bucket_update_shrink", (3, 5, 6, 7)),
                             ("_hub_dispatch", (4, 6, 8)))}


# ---- the branch functions ---------------------------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_full_and_compact_equal_jax(name):
    eng = jax_engine(name)
    v = eng.arrays.num_vertices
    k = np.int32(40)
    for bi, cb, p_b, row0, _ in _hub_cases(name):
        vb = cb.shape[0]
        cb_t = _t(cb)
        for pe in _states(v, bi):
            pk_b = pe[row0: row0 + vb]
            pe_t, pk_t = torch.from_numpy(pe), torch.from_numpy(pk_b)
            pe_j, pk_j = jnp.asarray(pe), jnp.asarray(pk_b)
            assert_same(th.bucket_update(pe_t, pk_t, cb_t, p_b, k, v),
                        _jit["_bucket_update"](pe_j, pk_j, cb, p_b, k, v))
            for pad in sorted({1, max(vb // 3, 1), 2 * vb}):
                assert_same(th.compact_core(pe_t, pk_t, cb_t, p_b, k, v, pad),
                            _jit["_compact_core"](pe_j, pk_j, cb, p_b, k, v,
                                                  pad))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_rebase_pruned_shrink_equal_jax(name):
    """Rebase (``ok`` both ways), then pruned and shrink on its capture
    from a later state, and pruned on the tier-2 capture."""
    eng = jax_engine(name)
    v = eng.arrays.num_vertices
    oks = set()
    for bi, cb, p_b, row0, cfg in _hub_cases(name):
        vb, w = cb.shape
        cb_t = _t(cb)
        states = _states(v, 100 + bi)
        for k in (np.int32(40), np.int32(3)):
            for u in sorted({max(w // 8, 1), w}):
                pad = cfg[0] if cfg else min(64, vb)
                pe0 = states[2]
                args = (pe0[row0: row0 + vb], cb, p_b, k, v, pad, u)
                ref = _jit["_bucket_update_rebase"](jnp.asarray(pe0),
                                               *map(jnp.asarray, args[:1]),
                                               *args[1:])
                ours = th.bucket_update_rebase(
                    torch.from_numpy(pe0), torch.from_numpy(args[0]), cb_t,
                    *args[2:])
                assert_same(ours, ref)
                oks.add(int(ours[4][0]))
                tier1_j = ref[4][1:4]
                tier1_t = tuple(_t(x) for x in tier1_j)
                for pe in states[3:]:
                    pk_b = pe[row0: row0 + vb]
                    pe_t, pk_t = torch.from_numpy(pe), torch.from_numpy(pk_b)
                    pe_j, pk_j = jnp.asarray(pe), jnp.asarray(pk_b)
                    assert_same(
                        th.bucket_update_pruned(pe_t, pk_t, tier1_t, p_b, k,
                                                w, v),
                        _jit["_bucket_update_pruned"](pe_j, pk_j, tier1_j,
                                                      p_b, k, w, v))
                    for p2 in sorted({1, max(pad // 4, 1)}):
                        ref2 = _jit["_bucket_update_shrink"](
                            pe_j, pk_j, tier1_j, p_b, k, w, v, p2)
                        ours2 = th.bucket_update_shrink(
                            pe_t, pk_t, tier1_t, p_b, k, w, v, p2)
                        assert_same(ours2, ref2)
                        assert_same(
                            th.bucket_update_pruned(pe_t, pk_t, ours2[4],
                                                    p_b, k, w, v),
                            _jit["_bucket_update_pruned"](pe_j, pk_j, ref2[4],
                                                          p_b, k, w, v))
    assert oks == {0, 1}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_fresh_prune_equals_jax(name):
    eng = jax_engine(name)
    v = eng.arrays.num_vertices
    ours = th.fresh_prune(eng.combined_buckets, eng.hub_buckets, eng.planes,
                          eng.hub_prune, v)
    ref = jc._fresh_prune(eng.combined_buckets, eng.hub_buckets, eng.planes,
                          eng.hub_prune, v)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if b is not None:
            assert_same(a, b)


# ---- the branch index -------------------------------------------------------

# each JAX branch function, tagged: the branch index it stands for
_TAGGED = {"_bucket_update": th.BRANCH_FULL,
           "_bucket_update_compact": th.BRANCH_COMPACT,
           "_bucket_update_rebase": th.BRANCH_REBASE,
           "_bucket_update_pruned": th.BRANCH_PRUNED,
           "_bucket_update_shrink": th.BRANCH_SHRINK}
_TAG = 1000


@pytest.fixture
def tagged_jax(monkeypatch):
    """``_hub_dispatch`` with each branch function returning ``mc`` =
    TAG + its branch index (a tier-2 pruned call: PRUNED2), so the branch
    the switch ran reads off its ``mc``; skip leaves −1."""
    for fname, branch in _TAGGED.items():
        orig = getattr(jc, fname)

        def tagged(*args, _orig=orig, _branch=branch, **kw):
            out = _orig(*args, **kw)
            b = _branch
            if b == th.BRANCH_PRUNED and args[2][0].shape[0] == _p2[0]:
                b = th.BRANCH_PRUNED2
            return out[:3] + (jnp.int32(_TAG + b),) + out[4:]

        monkeypatch.setattr(jc, fname, tagged)

    def dispatch(pe, ba, pk_b, cb, p_b, k, v, ps, cfg, uncond):
        # a function of its own: jit traces it anew, through the tags
        return jc._hub_dispatch(pe, ba, pk_b, cb, p_b, k, v, ps, cfg,
                                uncond=uncond)

    return jax.jit(dispatch, static_argnums=(4, 6, 8, 9))


_p2 = [0]  # the tier-2 pad of the ladder under test (tells pruned2 apart)


def _jax_prune_state(vb: int, v: int, p_b: int, cfg, tier: int):
    p, u = cfg[0], cfg[1]
    ps = (jnp.int32(tier), jnp.full((p,), vb, jnp.int32),
          jnp.full((p, u), v, jnp.int32), jnp.zeros((p, p_b), jnp.uint32))
    if len(cfg) == 3:
        ps += (jnp.full((cfg[2],), vb, jnp.int32),
               jnp.full((cfg[2], u), v, jnp.int32),
               jnp.zeros((cfg[2], p_b), jnp.uint32))
    return ps


def _ladders(vb: int):
    """(cfg, uncond) of every ladder shape for a bucket of ``vb`` rows;
    P2 ≠ P so a tier-2 call is told apart by its shape."""
    return [(None, True), (None, False), ((16, 2), False),
            ((vb, 2), False), ((16, 2, 4), False), ((2 * vb, 2, 8), False)]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_hub_branch_is_the_jax_dispatch_index(name, tagged_jax):
    eng = jax_engine(name)
    v = eng.arrays.num_vertices
    # the widest-row bucket (its ladder reaches compact when rows > 4·pad)
    bi = max(range(eng.hub_buckets), key=lambda b: eng.combined_buckets[b].shape[0])
    cb, p_b = eng.combined_buckets[bi], eng.planes[bi]
    vb = cb.shape[0]
    pe = jnp.asarray(_states(v, 7)[1])
    pk_b = pe[eng.row0s[bi]: eng.row0s[bi] + vb]
    seen = set()
    for cfg, uncond in _ladders(vb):
        _p2[0] = cfg[2] if cfg and len(cfg) == 3 else -1
        tiers = (0, 1, 2) if cfg and len(cfg) == 3 else (0, 1) if cfg else (0,)
        for tier in tiers:
            for ba in sorted({0, 1, 4, 5, 16, 17, 32, 33, vb // 2, vb}):
                ps = (_jax_prune_state(vb, v, p_b, cfg, tier) if cfg
                      else None)
                out = tagged_jax(pe, jnp.int32(ba), pk_b, cb, p_b,
                                 np.int32(40), v, ps, cfg, uncond)
                mc = int(out[3])
                jax_branch = mc - _TAG if mc >= _TAG else th.BRANCH_SKIP
                ours = th.hub_branch(ba, tier, vb, cfg, uncond)
                assert ours == jax_branch, (cfg, uncond, tier, ba)
                seen.add(ours)
    reached = {th.BRANCH_NAMES[b] for b in seen}
    want = set(th.BRANCH_NAMES)
    if th.hub_pad_for(vb) == 0:  # no compaction pad: compact unreachable
        want.discard("compact")
    assert reached == want


@pytest.mark.parametrize("name", list(GRAPHS))
def test_hub_dispatch_equals_jax(name):
    """Every output of the ladder on real captures: a rebase from an
    early state, a shrink from a later one, then each branch."""
    eng = jax_engine(name)
    v = eng.arrays.num_vertices
    k = np.int32(40)
    for bi, cb, p_b, row0, cfg in _hub_cases(name):
        vb, w = cb.shape
        if cfg is None:
            cfg = (min(16, vb), max(w // 4, 1))
        states = _states(v, 200 + bi)
        pe0 = jnp.asarray(states[3])
        ps = jc._fresh_prune([cb], 1, (p_b,), (cfg,), v)[0]
        # a rebase (live count 1 fits every pad) captures tier 1
        ps = _jit["_hub_dispatch"](pe0, jnp.int32(1), pe0[row0: row0 + vb],
                                   cb, p_b, k, v, ps, cfg)[4]
        for pe_np in states[3:]:
            pe = jnp.asarray(pe_np)
            pk_b = pe[row0: row0 + vb]
            act = int(np.sum((pe_np[row0: row0 + vb] < 0)
                             | (pe_np[row0: row0 + vb] & 1 == 1)))
            for ba in sorted({0, 1, act}):
                ref = _jit["_hub_dispatch"](pe, jnp.int32(ba), pk_b, cb, p_b,
                                            k, v, ps, cfg)
                ours = th.hub_dispatch(
                    torch.from_numpy(pe_np), ba,
                    torch.from_numpy(pe_np[row0: row0 + vb]), _t(cb), p_b, k,
                    v, tuple(_t(x) for x in ps), cfg)
                assert_same(ours, ref)
            ps = ref[4]  # carry the capture on (tier 1 → 2 as it shrinks)


# ---- the plain hub kernels on the pool layout ---------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_plain_kernels_run_the_branches(name):
    """K7 then K8's plain versions over the pool equal ``hub_dispatch`` on
    each bucket's own tensors, superstep after superstep, tiers and live
    counts carried as K6 commits them."""
    eng = jax_engine(name)
    v = eng.arrays.num_vertices
    hub = eng.hub_buckets
    sizes = [cb.shape[0] for cb in eng.combined_buckets[:hub]]
    widths = [cb.shape[1] for cb in eng.combined_buckets[:hub]]
    cfgs = tuple(eng.hub_prune[:hub])
    plan = kh.hub_plan(eng.row0s[:hub], sizes, widths, eng.planes[:hub], cfgs,
                       (), "cpu")
    pool = kh.new_pool(plan, "cpu")
    table = torch.cat([_t(cb).reshape(-1) for cb in eng.combined_buckets[:hub]])
    pe = torch.from_numpy(_states(v, 9)[1])
    state = kc.new_state(pe)
    pk = pe[:v]
    ba = torch.tensor([int(((pk[r: r + n] < 0) | (pk[r: r + n] & 1 == 1)).sum())
                       for r, n in zip(eng.row0s[:hub], sizes)], dtype=torch.int32)
    live = kc.new_live(ba)
    ps = [th.fresh_prune([torch.empty(n, 1)], 1, (p,), (c,), v)[0]
          for n, p, c in zip(sizes, eng.planes[:hub], cfgs)]
    branches = set()
    for _ in range(6):
        ctrl = kc.new_ctrl(step=2, prev_active=v + 1, device="cpu")
        src = state[0].clone()
        kh.hub_slots(ctrl, state, live, plan, pool, 0, 1 << 30)
        kh.hub_superstep(ctrl, state, table, live, plan, pool, 40, 0, 1 << 30)
        fail = act = 0
        mc = -1
        for bi, b in enumerate(plan.buckets):
            branches.add(int(live[kc.LIVE_BRANCH, bi]))
            cb = table[b.cb: b.cb + b.rows * b.width].view(b.rows, b.width)
            out = th.hub_dispatch(src, int(ba[bi]), src[b.row0: b.row0 + b.rows],
                                  cb, b.planes, 40, v, ps[bi], b.cfg)
            assert torch.equal(state[1, b.row0: b.row0 + b.rows], out[0])
            assert int(live[kc.LIVE_BA_NEXT, bi]) == int(out[2])
            if b.cfg is not None:
                assert int(live[kc.LIVE_TIER_NEXT, bi]) == int(out[4][0])
            fail, act, mc = fail + int(out[1]), act + int(out[2]), max(mc, int(out[3]))
            ba[bi], ps[bi] = out[2], out[4]
        c = ctrl.tolist()
        assert (c[kc.CTRL_FAIL], c[kc.CTRL_ACTIVE], c[kc.CTRL_MC]) == (fail, act, mc)
        # K6's commit, and the next superstep from the new state
        live[kc.LIVE_BA] = live[kc.LIVE_BA_NEXT]
        live[kc.LIVE_TIER] = live[kc.LIVE_TIER_NEXT]
        state[0] = state[1]
    assert th.BRANCH_REBASE in branches
