"""The port's trajectories on hub layouts equal ``dgc_tpu``'s on the CPU
(the recording variants' plain versions of K5, K8 and K6): cols 0-4, the
bucket-active tail (hub buckets, then the flat region's total) and the
unconf tail, ``first_step`` and ``truncated``, in fused sweeps whose
confirms resume from the ring.

- ``rmat-tier2``: every conditioned branch of the ladder (``full``,
  ``rebase``, ``pruned``, ``shrink``, ``pruned2``; ``skip`` once a bucket
  is inert) with compaction stages;
- ``k48-cap1``: a pruned hub under a capped window, which stalls, widens
  and records a fresh buffer for the retry.

``tests/test_torch_telemetry_hub_layouts.py`` holds the other layouts.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_hub_cases as cases  # noqa: E402

from dgc_tpu_torch.engine import hub as th  # noqa: E402
from dgc_tpu_torch.kernels import compact as kc  # noqa: E402
from dgc_tpu_torch.kernels import hub as kh  # noqa: E402


def test_every_hub_branch_records_like_jax(monkeypatch):
    taken = set()
    real = kh.hub_superstep_reference

    def spy(ctrl, state, table, live, plan, *args, **kw):
        taken.update(live[kc.LIVE_BRANCH, :len(plan.buckets)].tolist())
        return real(ctrl, state, table, live, plan, *args, **kw)

    monkeypatch.setattr(kh, "hub_superstep_reference", spy)
    trajs = cases.check_telemetry("rmat-tier2")
    assert {th.BRANCH_NAMES[b] for b in taken} >= {
        "skip", "full", "rebase", "pruned", "shrink", "pruned2"}
    # the conditioned buckets' gathers stop once they are inert
    assert trajs[0].gather_calls.max() > trajs[0].gather_calls[-1]


def test_capped_hub_window_widens_and_records_like_jax():
    trajs = cases.check_telemetry("k48-cap1", attempt=True)
    assert all(len(t) for t in trajs)
