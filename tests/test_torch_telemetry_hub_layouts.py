"""The port's trajectories on the other hub layouts of
``tests/torch_hub_cases.py`` equal ``dgc_tpu``'s on the CPU (see
``tests/test_torch_telemetry_hub.py``):

- ``rmat-ladder-free``: the full-table phase alone (``_hybrid_superstep``:
  the flat region counts one gather a superstep, each live conditioned hub
  bucket one more);
- ``uniform-compact``: the ``compact`` branch of buckets without a prune
  config, with compaction stages;
- ``rmat-default``: the default knobs, a hub region of unconditioned
  buckets only (their one shared gather counts once).
"""

import pytest

pytest.importorskip("torch")

import torch_hub_cases as cases  # noqa: E402


@pytest.mark.parametrize("name", ["rmat-ladder-free", "uniform-compact",
                                  "rmat-default"])
def test_hub_layout_records_like_jax(name):
    trajs = cases.check_telemetry(name)
    assert all(len(t) for t in trajs)
