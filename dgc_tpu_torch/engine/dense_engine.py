"""Dense-adjacency coloring engine (port of
``dgc_tpu.engine.dense_engine``) — the path for small graphs.

For V up to 16,384 the whole superstep is two kernels over the dense
adjacency (``kernels.dense``, A bf16 [V, V]): K11 computes what the JAX
body's product ``counts = A @ onehot(colors)`` feeds its first fit —
each uncolored vertex's first free color below the budget k — from a
bitmask of its neighbors' colors, reading its adjacency row once; K12
keeps a vertex's candidate unless an uncolored neighbor with the same
candidate beats it ((degree desc, id asc), the ELL engines' priority),
applies the step and folds the status. The host enqueues 64 supersteps
at a time and syncs once per chunk.

``kmax`` (the one-hot width) is Δ+1 rounded up to 128, as in the JAX
engine: a budget at or above it is clamped to it (``clamp_budget``), the
dynamic k only masks columns. Memory is O(V²): 512 MiB of adjacency at
V = 16,384, the cap.
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.base import (AttemptResult, AttemptStatus,
                                       clamp_budget, empty_budget_failure)
from dgc_tpu_torch.kernels.dense import (DCTRL_CUR, DCTRL_STATUS, DCTRL_STEP,
                                         dense_adjacency, new_dense_ctrl,
                                         new_dense_state, padded_size,
                                         run_dense_steps)
from dgc_tpu_torch.models.arrays import GraphArrays

MAX_VERTICES = 16384
_RUNNING = int(AttemptStatus.RUNNING)


class DenseEngine:
    """Dense-adjacency engine on two hand-written CUDA kernels. Memory is
    O(V²); intended for V ≲ 8192, refused above 16,384."""

    def __init__(self, arrays: GraphArrays, max_steps: int | None = None,
                 device="cuda"):
        v = arrays.num_vertices
        if v > MAX_VERTICES:
            raise ValueError(
                f"DenseEngine is O(V^2) memory; V={v} is too large — use the "
                "ELL or sharded engine")
        dev = resolve_device(device)
        vp = padded_size(v)
        degrees = np.zeros(vp, np.int32)
        degrees[:v] = arrays.degrees
        # kmax: Δ+1 rounded up to a multiple of 128, at least 128
        kmax = max(128, -(-(arrays.max_degree + 1) // 128) * 128)
        self._setup(dense_adjacency(arrays.indptr, arrays.indices, vp, dev),
                    degrees, v, kmax,
                    max_steps if max_steps is not None else v + 2, dev)

    def _setup(self, adj: torch.Tensor, degrees: np.ndarray, v: int,
               kmax: int, max_steps: int, device) -> None:
        """``adj`` bf16[Vp, Vp] on ``device`` and ``degrees`` int32[Vp]
        (pads zero), for the first ``v`` vertices."""
        self.device = torch.device(device)
        self.num_vertices = v
        self.adj = adj
        self.degrees = torch.from_numpy(
            np.ascontiguousarray(degrees, np.int32)).to(self.device)
        self.kmax = kmax
        self.max_steps = max_steps
        vp = adj.shape[0]
        real = torch.arange(vp, device=self.device) < v
        # isolated vertices start at color 0, the rest (and the pads) at −1
        self._colors0 = torch.where(real & (self.degrees == 0), 0, -1).to(
            torch.int32)
        self._cand = torch.empty(vp, dtype=torch.int32, device=self.device)
        self.host_syncs = 0

    def attempt(self, k: int) -> AttemptResult:
        if k < 1:
            return empty_budget_failure(self.num_vertices, k)
        k_eff = clamp_budget(k, self.kmax)
        ctrl = new_dense_ctrl(self.device)
        state = new_dense_state(self._colors0)
        while True:
            c = run_dense_steps(ctrl, state, self.adj, self._cand,
                                self.degrees, self.num_vertices, k_eff,
                                self.max_steps)
            self.host_syncs += 1
            if c[DCTRL_STATUS] != _RUNNING:
                break
        colors = state[c[DCTRL_CUR], :self.num_vertices].cpu().numpy()
        return AttemptResult(AttemptStatus(c[DCTRL_STATUS]), colors,
                             c[DCTRL_STEP], int(k))
