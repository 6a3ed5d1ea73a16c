"""The port's compact engine on hub layouts equals ``dgc_tpu``'s on the
CPU, byte for byte (status, supersteps, k, colors of every attempt), built
by the port and from the JAX engine's tables:

- the forced-knob RMAT with compaction stages, tier 2 included;
- K48 forced into a pruned hub under a 1-plane window cap, which stalls,
  widens (the pool's ``[P, planes]`` captures rebuilt) and succeeds;

in attempts, fused sweeps (confirms resumed from the ring, its live
counts included, and one that misses it), and jump and strict
``find_minimal_coloring``. Every branch of the ladder runs on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_hub_cases as cases  # noqa: E402

from dgc_tpu_torch.engine import hub as th  # noqa: E402
from dgc_tpu_torch.kernels import hub as kh  # noqa: E402

NAMES = ["rmat-tier2", "k48-cap1"]


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", NAMES)
def test_hub_tables_equal_jax(name, build):
    cases.check_tables(name, build)


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", NAMES)
def test_hub_runs_equal_jax(name, build):
    resumed = cases.check_runs(name, build)
    assert resumed[0] is not None  # the confirm at k0 resumed from the ring


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_hub_find_minimal_coloring_equals_jax(name, strict):
    cases.check_find(name, strict)


def test_hub_ring_miss_confirms_from_scratch_like_jax(monkeypatch):
    name = "rmat-tier2"
    k0, _, ref = cases.jax_calls(name)
    ours = cases.port_engine(name)
    monkeypatch.setattr(ours, "_resume_point", lambda ring, c, k: None)
    pair = ours.sweep(k0)
    assert tuple(cases.row(r) for r in pair) == ref[3]
    assert ours.resumed_from_step is None


def test_capped_hub_window_widens():
    ours = cases.port_engine("k48-cap1")
    assert ours.planes == (1,) and ours._hub_plan.buckets[0].cfg is not None
    pool = ours._hub_pool
    res = ours.attempt(48)
    ref = cases.jax_engine("k48-cap1")
    ref.attempt(48)
    assert res.success and ours.planes == ref.planes
    assert ours.planes[0] > 1
    # the captures follow the window: [P, planes] planes in a new pool
    assert ours._hub_pool is not pool
    assert ours._hub_plan.buckets[0].planes == ours.planes[0]


def test_every_branch_runs_on_the_cpu(monkeypatch):
    """The forced-knob RMAT and the uniform graph at flat_cap=4 between
    them take every branch of the ladder."""
    seen = set()

    def recording(*args, **kw):
        b = th.hub_branch(*args, **kw)
        seen.add(th.BRANCH_NAMES[b])
        return b

    monkeypatch.setattr(kh, "hub_branch", recording)
    for name in ("rmat-tier2", "uniform-compact"):
        eng = cases.port_engine(name)
        eng.sweep(cases.graph(name).max_degree + 1)
    assert seen == set(th.BRANCH_NAMES)
