"""Vertex-sharded flat engine over the all-gather exchange (port of
``dgc_tpu.engine.sharded``).

The vertex axis, padded to a multiple of the mesh size, is block-sharded
over the ranks of the mesh (``parallel.mesh``): each rank owns ``V/n``
contiguous rows of the ``[V, Δ]`` ELL table with *global* neighbor ids
(the sentinel moved from the true V to the padded one). Every superstep
all-gathers the shards' packed (color, fresh) words into one state vector
on every rank and applies the speculative assign-then-demote rule of the
single-device ELL engine to the shard's rows against it (K20,
``kernels.shard``), the priority read from the degrees; the fail and
active counts are summed and the divergence candidate ``mc`` maxed over
the ranks (``engine.fused``), so the colors are the same at every mesh
size and equal ``ELLEngine``'s. Padding vertices have degree 0: the reset
colors them 0 and they never interact; results are cut back to the true V
on the host.

A *flat* engine: its memory and its per-superstep gather grow with the max
degree, so heavy-tailed graphs are refused at construction
(``max_ell_width``) in favour of ``ShardedBucketedEngine``. The first-fit
window is capped at ``max_window_planes`` and widened on STALLED, so a
large Δ+1 budget never unrolls hundreds of planes; a capped window never
asserts a wrong FAILURE (the fail count only counts where ``k`` fits the
window).
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.engine.base import clamp_budget
from dgc_tpu_torch.engine.fused import ShardEngine
from dgc_tpu_torch.kernels import shard as ks
from dgc_tpu_torch.kernels.superstep import real_lengths
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple


class ShardedELLEngine(ShardEngine):
    """Vertex-sharded engine over an n-rank mesh (all-gather exchange)."""

    def __init__(self, arrays: GraphArrays, num_shards: int | None = None,
                 max_steps: int | None = None, mesh=None,
                 max_window_planes: int = 32, max_ell_width: int = 2048,
                 device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(num_shards,
                                                            device)
        n = self.mesh.size
        v = arrays.num_vertices
        v_pad = pad_to_multiple(max(v, n), n)

        if arrays.max_degree > max_ell_width:
            raise ValueError(
                f"ShardedELLEngine is a flat-ELL engine: max degree "
                f"{arrays.max_degree} would pad every vertex row to "
                f"{arrays.max_degree} columns (O(V*maxdeg) memory and gather "
                f"volume). Use the degree-bucketed multi-chip backend instead "
                f"(--backend sharded-bucketed / ShardedBucketedEngine), whose "
                f"tables scale with the edge count; or raise max_ell_width "
                f"explicitly if the padding cost is acceptable."
            )

        nbrs, degrees = arrays.to_ell()
        w = nbrs.shape[1]
        # pad vertex axis; remap the ELL sentinel v → v_pad
        nbrs_p = np.full((v_pad, w), v_pad, dtype=np.int32)
        nbrs_p[:v] = np.where(nbrs == v, v_pad, nbrs)
        deg_p = np.zeros(v_pad, dtype=np.int32)
        deg_p[:v] = degrees
        self._setup(nbrs_p, deg_p, v, max_steps, max_window_planes)

    def _setup(self, nbrs_p, deg_p, v_true: int, max_steps,
               max_window_planes: int) -> None:
        # also the build from given tables (convert.sharded_engine_from_tables)
        dev = self.mesh.device
        v_pad = len(deg_p)
        blk = self.mesh.block(v_pad)
        self.num_vertices = int(v_true)
        self.max_degree = int(deg_p.max()) if v_pad else 0
        self.num_planes = min(num_planes_for(self.max_degree + 1),
                              max_window_planes)
        self.max_steps = max_steps if max_steps is not None else 2 * v_pad + 4
        self.row_off = blk.start
        # the shard's rows of the table; every rank's degrees, −1 at the
        # sentinel's slot
        self.nbrs = torch.from_numpy(
            np.array(np.asarray(nbrs_p)[blk], dtype=np.int32)).to(dev)
        # K20's plan: each row's real length, taken once
        self.lens = real_lengths(self.nbrs, v_pad)
        self.deg_g = torch.from_numpy(np.concatenate(
            [np.asarray(deg_p, np.int32), [-1]]).astype(np.int32)).to(dev)
        self.deg_l = self.deg_g[blk]
        self.state = ks.new_shard_state(v_pad, dev)
        self.back = self.state[1, blk]
        self.packed_l = torch.empty(blk.stop - blk.start, dtype=torch.int32,
                                    device=dev)
        self.p1 = torch.empty_like(self.packed_l)
        # no conditioned buckets: no live table, no gather-call count
        self.live, self.nh, self.init_ba, self.gc_const = None, 0, None, -1
        # the reset pass: isolated vertices confirm 0, the rest uncolored
        self.init_word, self.init_step, self.init_prev = -1, 0, v_pad + 1

    def _start(self, k: int) -> torch.Tensor:
        self.packed_l.copy_(torch.where(self.deg_l == 0, 0, self.init_word))
        return ks.new_shard_ctrl(self.init_step, self.init_prev, k,
                                 self.gc_const, self.packed_l.device)

    def _superstep(self, ctrl, k: int) -> None:
        window = 32 * self.num_planes
        fail_valid = window >= self.max_degree + 1 or k <= window
        ks.shard_superstep(ctrl, self.state, self.nbrs, self.lens,
                           self.deg_g, self.row_off, self.num_planes, k,
                           fail_valid)

    def _budget(self, k: int) -> int:
        return clamp_budget(k, 32 * num_planes_for(self.max_degree + 1))

    def _widen(self) -> bool:
        """Double the window toward the full Δ+1 budget after STALLED;
        True iff it widened (``dgc_tpu``'s ``maybe_widen_window``)."""
        full = num_planes_for(self.max_degree + 1)
        if self.num_planes >= full:
            return False
        self.num_planes = min(2 * self.num_planes, full)
        return True

    def _colors(self, colors: np.ndarray) -> np.ndarray:
        return colors[: self.num_vertices]
