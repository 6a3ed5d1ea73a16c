"""Carry the JAX package's state across to the port.

The JAX side's graph and engine tables, given as NumPy arrays (e.g.
``np.asarray(jax_engine.nbrs)``), become the port's objects, so both
packages can be run over exactly the same tables. Nothing here imports
``dgc_tpu``: the caller converts its arrays.
"""

from __future__ import annotations

import numpy as np

from dgc_tpu_torch.engine.bucketed import MAX_WINDOW_PLANES, BucketedELLEngine
from dgc_tpu_torch.engine.superstep import ELLEngine
from dgc_tpu_torch.models.arrays import GraphArrays


def graph_from_numpy(indptr, indices) -> GraphArrays:
    """CSR arrays (``GraphArrays.indptr`` / ``.indices``) → the port's
    ``GraphArrays``."""
    return GraphArrays(indptr=np.asarray(indptr), indices=np.asarray(indices))


def ell_engine_from_tables(nbrs, degrees, device="cuda") -> ELLEngine:
    """``ELLEngine.nbrs`` (sentinel-padded with V) and ``.degrees`` →
    the port's ``ELLEngine``."""
    eng = ELLEngine.__new__(ELLEngine)
    eng._setup(np.asarray(nbrs), np.asarray(degrees), device)
    return eng


def bucketed_engine_from_tables(perm, degrees, combined_list, planes,
                                max_window_planes: int = MAX_WINDOW_PLANES,
                                device="cuda") -> BucketedELLEngine:
    """``BucketedELLEngine.perm``, ``.degrees``, ``.combined_buckets`` and
    ``.planes`` (with its window cap) → the port's ``BucketedELLEngine``.
    The buckets tile the rows in order."""
    combined_list = [np.asarray(cb) for cb in combined_list]
    row0s = np.cumsum([0] + [len(cb) for cb in combined_list[:-1]])
    eng = BucketedELLEngine.__new__(BucketedELLEngine)
    eng._setup(np.asarray(perm), np.asarray(degrees, np.int32),
               [int(r) for r in row0s], combined_list, tuple(planes),
               max_window_planes, device)
    return eng
