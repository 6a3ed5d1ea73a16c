"""Coloring engines of the port.

- ``superstep``: the ELL engine (one superstep-kernel launch per step).
- ``bucketed``: the degree-bucketed engine (one launch per bucket).
- ``compact`` (with ``hub``): the staged frontier-compacted engine, its
  fused sweep and attempt block.
- ``dense_engine``: the dense-adjacency engine (K11, K12), V ≤ 16,384.
- ``oracle``, ``reference_sim``: the host NumPy parity targets.
- ``minimal_k``: the host-side outer loop over k.
"""
