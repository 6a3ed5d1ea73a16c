"""The port's compact engine on more hub layouts equals ``dgc_tpu``'s on
the CPU, byte for byte, built by the port and from the JAX engine's
tables, in attempts, fused sweeps and jump and strict
``find_minimal_coloring``:

- the forced-knob RMAT below 2^14 vertices, where the default ladder has
  no compaction stage (the full-table phase with hubs, ``_hybrid_superstep``);
- an RMAT at the default knobs: a hub region of unconditioned buckets.

``tests/test_torch_hub_uniform.py`` holds the ``compact`` branch.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_hub_cases as cases  # noqa: E402

NAMES = ["rmat-ladder-free", "rmat-default"]


@pytest.mark.parametrize("name", NAMES)
def test_hub_layout_tables_equal_jax(name):
    cases.check_tables(name)


def test_layouts_take_their_paths():
    assert cases.jax_engine("rmat-ladder-free").stages == ((None, 0),)
    assert all(cfg is None for cfg in cases.jax_engine("uniform-compact").hub_prune)
    assert all(cases.jax_engine("rmat-default").hub_uncond)


@pytest.mark.parametrize("build", ["port", "convert"])
@pytest.mark.parametrize("name", NAMES)
def test_hub_layout_runs_equal_jax(name, build):
    cases.check_runs(name, build)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_hub_layout_find_minimal_coloring_equals_jax(name, strict):
    cases.check_find(name, strict)
