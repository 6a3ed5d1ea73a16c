"""The port's compact engine equals ``dgc_tpu``'s on the CPU, byte for
byte, where every degree bucket of a 5,000-vertex uniform graph is a hub
(``flat_cap=4``, no unconditioned bucket) without a prune config: the
``compact`` branch of the ladder (``hub_pad_for``), built by the port and
from the JAX engine's tables, in attempts, fused sweeps and jump and
strict ``find_minimal_coloring``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_hub_cases as cases  # noqa: E402

from dgc_tpu_torch.engine.hub import hub_pad_for  # noqa: E402

NAME = "uniform-compact"


def test_hub_layout_tables_equal_jax():
    ours, _ = cases.check_tables(NAME)
    assert any(hub_pad_for(cb.shape[0]) for cb in ours.combined_buckets[
        :ours.hub_buckets])


@pytest.mark.parametrize("build", ["port", "convert"])
def test_hub_layout_runs_equal_jax(build):
    cases.check_runs(NAME, build)


@pytest.mark.parametrize("strict", [False, True])
def test_hub_layout_find_minimal_coloring_equals_jax(strict):
    cases.check_find(NAME, strict)
