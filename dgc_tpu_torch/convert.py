"""Carry the JAX package's state across to the port.

The JAX side's graph and engine tables, given as NumPy arrays (e.g.
``np.asarray(jax_engine.nbrs)``), become the port's objects, so both
packages can be run over exactly the same tables. Nothing here imports
``dgc_tpu``: the caller converts its arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.engine.bucketed import MAX_WINDOW_PLANES, BucketedELLEngine
from dgc_tpu_torch.engine.compact import CompactFrontierEngine
from dgc_tpu_torch.engine.dense_engine import DenseEngine
from dgc_tpu_torch.engine.ring import RingHaloEngine
from dgc_tpu_torch.engine.sharded import ShardedELLEngine
from dgc_tpu_torch.engine.sharded_bucketed import (ShardedBucketedEngine,
                                                   ShardedBucketLayout)
from dgc_tpu_torch.engine.superstep import ELLEngine
from dgc_tpu_torch.kernels.dense import padded_size
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.ops.speculative import encode_combined
from dgc_tpu_torch.parallel.mesh import make_mesh


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


def compact_engine_from_tables(perm, degrees, combined_list, planes,
                               flat_ext, stages, stage_ranges,
                               hub_buckets: int = 0, hub_prune=(),
                               hub_uncond=(),
                               max_window_planes: int = MAX_WINDOW_PLANES,
                               max_steps: int | None = None,
                               device="cuda") -> CompactFrontierEngine:
    """``CompactFrontierEngine.perm``, ``.degrees``, ``.combined_buckets``,
    ``.planes`` (with its window cap), ``.flat_ext`` (None without
    compaction stages; rows ``[flat_row0, V)`` and the dummy row),
    ``.stages``, ``.stage_ranges``, ``.hub_buckets``, ``.hub_prune``,
    ``.hub_uncond`` and ``.max_steps`` → the port's
    ``CompactFrontierEngine``, any bucket layout; ``flat_row0`` is the
    first flat bucket's row."""
    combined_list = [np.asarray(cb) for cb in combined_list]
    row0s = np.cumsum([0] + [len(cb) for cb in combined_list[:-1]])
    eng = CompactFrontierEngine.__new__(CompactFrontierEngine)
    eng._setup(np.asarray(perm), np.asarray(degrees, np.int32),
               [int(r) for r in row0s], combined_list, tuple(planes),
               max_window_planes, device, max_steps=max_steps,
               stages=tuple(stages), stage_ranges=tuple(stage_ranges),
               hub_buckets=int(hub_buckets),
               flat_ext=None if flat_ext is None else np.asarray(flat_ext),
               hub_prune=tuple(hub_prune), hub_uncond=tuple(hub_uncond))
    return eng


def ring_from_jax(rec, device="cuda") -> tuple:
    """A JAX prefix-resume ring (``dgc_tpu.engine.compact._empty_rec``'s
    five-tuple ``(rpe, rba, rmeta, count, best)``, as NumPy) → the port's
    attempt-block carry ``(best_pe, (ring_pe, ring_ba, ring_meta), rec)``
    (``CompactFrontierEngine._fresh_block_carry``'s layout), the best row
    zero."""
    rpe, rba, rmeta, cnt, best = (np.asarray(x) for x in rec)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

    return (t(np.zeros(rpe.shape[1], np.int32)), (t(rpe), t(rba), t(rmeta)),
            t([int(cnt), int(best)]))


def dense_from_jax(adj, degrees, kmax: int, max_steps: int,
                   device="cuda") -> DenseEngine:
    """``DenseEngine.adj`` (as float32 NumPy), ``.degrees``, ``.kmax`` and
    ``.max_steps`` → the port's ``DenseEngine`` on the same adjacency, its
    rows and columns padded with zeros to the port's vertex tile."""
    adj = np.asarray(adj, np.float32)
    v = adj.shape[0]
    vp = padded_size(v)
    dev = torch.device(device)
    dense = torch.zeros((vp, vp), dtype=torch.bfloat16, device=dev)
    dense[:v, :v] = torch.from_numpy(adj).to(dev, torch.bfloat16)
    deg = np.zeros(vp, np.int32)
    deg[:v] = np.asarray(degrees)
    eng = DenseEngine.__new__(DenseEngine)
    eng._setup(dense, deg, v, int(kmax), int(max_steps), dev)
    return eng


def sharded_engine_from_tables(nbrs, degrees, num_vertices: int,
                               max_steps: int, max_window_planes: int = 32,
                               mesh=None, device="cuda") -> ShardedELLEngine:
    """``ShardedELLEngine.nbrs`` (the whole padded table, sentinel the
    padded V), ``.deg_g`` (the padded degrees), ``.v_true`` and
    ``.max_steps`` → the port's ``ShardedELLEngine`` over the same table,
    on ``mesh`` (default: ``make_mesh(device=device)``). The padded V must
    be a multiple of the mesh size."""
    eng = ShardedELLEngine.__new__(ShardedELLEngine)
    eng.mesh = mesh if mesh is not None else make_mesh(device=device)
    degrees = np.asarray(degrees, np.int32)
    if len(degrees) % eng.mesh.size:
        raise ValueError(f"{len(degrees)} rows do not split over "
                         f"{eng.mesh.size} ranks")
    eng._setup(np.asarray(nbrs, np.int32), degrees, int(num_vertices),
               int(max_steps), max_window_planes)
    return eng


def sharded_bucketed_engine_from_tables(
        orig_of_final, deg_final, tables, slice_sizes, v_final: int,
        pads, prune_cfg, max_steps: int,
        max_window_planes: int = MAX_WINDOW_PLANES, mesh=None,
        device="cuda") -> ShardedBucketedEngine:
    """``ShardedBucketedEngine.layout`` (its ``orig_of_final``,
    ``deg_final``, ``tables``, ``slice_sizes`` and ``v_final``), ``.pads``,
    ``.prune_cfg`` and ``.max_steps`` → the port's
    ``ShardedBucketedEngine`` over the same tables, on ``mesh`` (default:
    ``make_mesh(device=device)``), which must have as many ranks as the
    layout has shards."""
    lay = ShardedBucketLayout(
        orig_of_final=np.asarray(orig_of_final),
        deg_final=np.asarray(deg_final, np.int32),
        tables=[np.asarray(t, np.int32) for t in tables],
        slice_sizes=[int(x) for x in slice_sizes], v_final=int(v_final))
    eng = ShardedBucketedEngine.__new__(ShardedBucketedEngine)
    eng.mesh = mesh if mesh is not None else make_mesh(device=device)
    eng._setup(lay, tuple(pads), tuple(prune_cfg), max_window_planes,
               int(max_steps))
    return eng


def ring_engine_from_tables(degrees, num_vertices: int, max_steps: int,
                            tables=None, beats=None, rot_buckets=None,
                            max_window_planes: int = 32, mesh=None,
                            device="cuda") -> RingHaloEngine:
    """``RingHaloEngine.deg_l`` (the padded degrees, whole), ``.v_true``
    and ``.max_steps``, with its flat ``.tables`` and ``.beats`` (one
    [V, W_r] table and mask a rotation) or its bucketed ``.rot_buckets``
    (a list a rotation of ``(rows [n, P], combined [n, P, W])``) → the
    port's ``RingHaloEngine`` over the same tables, on ``mesh`` (default:
    ``make_mesh(device=device)``), which must have as many ranks as the
    tables have rotations (the tables depend on the shard count)."""
    eng = RingHaloEngine.__new__(RingHaloEngine)
    eng.mesh = mesh if mesh is not None else make_mesh(device=device)
    n, s = eng.mesh.size, eng.mesh.rank
    degrees = np.asarray(degrees, np.int32)
    bucketed = rot_buckets is not None
    rotations = len(rot_buckets) if bucketed else len(tables)
    if rotations != n or len(degrees) % n:
        raise ValueError(f"tables of {rotations} rotations over "
                         f"{len(degrees)} rows do not fit {n} ranks")
    vl = len(degrees) // n
    blk = slice(s * vl, (s + 1) * vl)
    if bucketed:
        rot = [[(np.asarray(rows)[s], np.asarray(comb)[s])
                for rows, comb in bl] for bl in rot_buckets]
    else:
        rot = [[(None, encode_combined(np.asarray(t, np.int32)[blk],
                                       np.asarray(b, bool)[blk]))]
               for t, b in zip(tables, beats)]
    eng._setup(rot, degrees[blk], int(num_vertices), len(degrees),
               int(degrees.max()) if len(degrees) else 0, bucketed,
               int(max_steps), max_window_planes)
    return eng


def lane_shards_from_carry(carry, n: int, device="cpu") -> list:
    """A whole lane-leading carry or input stack (numpy, e.g. the JAX
    package's ``[B, ...]`` arrays as ``np.asarray``) as the port's lane
    mesh holds it: n per-shard lists of int32 tensors on ``device``, shard
    ``i`` lanes ``i * B / n .. (i + 1) * B / n``. ``carry`` is a sequence
    of arrays (the carry's slots, or ``(comb, degrees, k0, max_steps)``)."""
    from dgc_tpu_torch.serve.batched import LaneMesh, split_lanes

    mesh = LaneMesh([device] * n)
    slots = [split_lanes(np.asarray(a), mesh) for a in carry]
    return [[slots[j][i] for j in range(len(carry))] for i in range(n)]


def carry_from_lane_shards(shards) -> tuple:
    """The inverse of :func:`lane_shards_from_carry`: n per-shard
    sequences of arrays or tensors as whole numpy arrays, shard by shard."""
    from dgc_tpu_torch.serve.batched import sharded_home

    return sharded_home([tuple(sh) for sh in shards])
