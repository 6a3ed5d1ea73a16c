"""Single-device ELL coloring engine (port of ``dgc_tpu.engine.superstep``).

One k-attempt is a loop of speculative BSP supersteps over the padded ELL
table (the rule is documented in ``dgc_tpu.engine.superstep`` and
``ops.speculative``): each superstep is one launch of the superstep kernel
over all V rows (K1, its one [V, W] gather fused in) and one launch of the
loop-control kernel (K2), enqueued ``CHUNK_STEPS`` (64) at a time with
one host sync per chunk (``kernels.superstep.run_supersteps``).

The JAX engine recomputes the loop-invariant priority mask ``pre_beats``
inside every attempt; here it is packed once, at build, into bit 30 of
the neighbor table (the bucketed engine's combined layout), so both
engines share one kernel. The entries are the same ``beats_rule`` values.

With ``record_trajectory`` on, K2's recording variant writes each
superstep's row of the attempt's trajectory buffer (``obs.kernel``: the
active count and fail flag, as the JAX engine records them), and the
buffer comes home with the colors row in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.base import (
    AttemptResult,
    AttemptStatus,
    clamp_budget,
    empty_budget_failure,
)
from dgc_tpu_torch.kernels.superstep import (
    CTRL_CUR,
    CTRL_STATUS,
    CTRL_STEP,
    INT32_MAX,
    new_ctrl,
    new_state,
    row_plan,
    run_supersteps,
)
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.obs.kernel import (decode_trajectory, read_home,
                                      traj_cap_for, traj_empty)
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.ops.speculative import BEATS_BIT, beats_rule


def ell_combined_table(nbrs: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """``nbrs | beats << BEATS_BIT`` for a sentinel-padded ELL table, built
    on the tables' device. The sentinel (id V) has degree −1 and never
    beats."""
    v = nbrs.shape[0]
    if v >= 1 << BEATS_BIT:
        raise ValueError(f"V={v} exceeds combined-table id capacity 2^{BEATS_BIT}")
    deg_pad = torch.cat([degrees, degrees.new_full((1,), -1)])
    n_deg = deg_pad[nbrs.to(torch.int64)]
    ids = torch.arange(v, dtype=torch.int32, device=nbrs.device)
    beats = beats_rule(n_deg, nbrs, degrees[:, None], ids[:, None])
    return (nbrs | (beats.to(torch.int32) << BEATS_BIT)).contiguous()


class ELLEngine:
    """Single-device engine over a sentinel-padded ELL table."""

    def __init__(self, arrays: GraphArrays, device="cuda"):
        self._setup(*arrays.to_ell(), device)

    def _setup(self, nbrs, degrees, device):
        # also the build from given tables (convert.ell_engine_from_tables)
        self.device = resolve_device(device)
        # own copies: the inputs may be read-only views
        nbrs = np.array(nbrs, dtype=np.int32)
        degrees = np.array(degrees, dtype=np.int32)
        v = len(degrees)
        self.num_vertices = v
        max_degree = int(degrees.max()) if v else 0
        self.num_planes = num_planes_for(max_degree + 1)
        self.max_steps = 2 * v + 4
        self.degrees = torch.from_numpy(degrees).to(self.device)
        self.table = ell_combined_table(torch.from_numpy(nbrs).to(self.device),
                                        self.degrees)
        # K1's plan: each row's real length and its team, taken once
        self.plan = row_plan(self.table, v)
        self.host_syncs = 0
        # in-kernel telemetry switch: K2's recording variant writes each
        # superstep's row of a trajectory buffer that rides the carry
        self.record_trajectory = False

    def attempt(self, k: int) -> AttemptResult:
        v = self.num_vertices
        if k < 1:
            return empty_budget_failure(v, k)
        k_eff = clamp_budget(k, 32 * self.num_planes)
        # reset pass: isolated vertices → color 0 (confirmed), rest
        # uncolored (reference changeColorFirstIteration, coloring.py:12-17)
        packed0 = torch.where(self.degrees == 0, 0, -1).to(torch.int32)
        state = new_state(packed0)
        ctrl = new_ctrl(step=0, prev_active=v + 1, device=self.device)
        parts = [(0, self.table, self.plan, self.num_planes, True)]
        traj = (traj_empty(traj_cap_for(self.max_steps), device=self.device)
                if self.record_trajectory else None)
        while True:
            c = run_supersteps(ctrl, state, parts, k_eff,
                               max_steps=self.max_steps,
                               stall_window=INT32_MAX, traj=traj)
            self.host_syncs += 1
            if c[CTRL_STATUS] != AttemptStatus.RUNNING:
                break
        row = state[c[CTRL_CUR], :v]
        packed, traj_h = read_home(row, traj) if traj is not None \
            else (row.cpu().numpy(), None)
        self.host_syncs += 1
        colors = np.where(packed >= 0, packed >> 1, -1).astype(np.int32)
        return AttemptResult(
            AttemptStatus(c[CTRL_STATUS]), colors, c[CTRL_STEP], int(k),
            trajectory=(None if traj_h is None
                        else decode_trajectory(traj_h, c[CTRL_STEP])))
