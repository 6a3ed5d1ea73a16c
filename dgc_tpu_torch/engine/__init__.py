"""Coloring engines of the port.

- ``superstep``: the ELL engine (one superstep-kernel launch per step).
- ``bucketed``: the degree-bucketed engine (one launch per bucket).
- ``minimal_k``: the host-side outer loop over k.
"""
