"""The sharded engines' shared superstep loop and fused jump-mode pair
(port of ``dgc_tpu.engine.fused``).

``dgc_tpu`` runs a sharded k-attempt as one ``jit(shard_map(...))`` call:
a ``while_loop`` of all-gather, per-shard rule, psum/pmax and epilogue.
Here the host drives the same loop on every rank, ``SHARD_CHUNK``
supersteps between reads of the replicated control block, each superstep

1. the engine's exchange (``engine._exchange``): for the all-gather
   engines the all-gather of every shard's carry into buffer 0 of the
   state (``mesh.all_gather``); the ring engine's rotations run inside its
   superstep instead;
2. the engine's rule kernels on its rows (``engine._superstep``: K20, or
   K5/K7/K8 over the bucket slices, or the ring's K23/K24 per rotation and
   K25), counters into the control block;
3. one ``all_reduce(SUM)`` over [fail, active] and one ``all_reduce(MAX)``
   over [mc, gc, maxc] (``shard_superstep_epilogue``);
4. K21 (``kernels.shard.shard_finish``): ring push, carry, status.

Every decision (the loop's end, the ring push, the pair's confirm) reads
reduced values, so every rank enqueues the same collectives in the same
order and the per-shard ring slices assemble a consistent global state.

An engine of this loop (``engine.sharded``, ``engine.sharded_bucketed``,
``engine.ring``) provides ``mesh``, ``packed_l`` and ``back`` (its carry
and its new words; for the all-gather engines ``back`` is its rows of
buffer 1 of ``state``, ``kernels.shard.new_shard_state``), ``p1``
(phase 0's result slot), ``deg_l``, ``live``/``nh``/``init_ba`` (the live
table of its conditioned buckets, or None/0/None), ``gc_const``,
``init_word``/``init_step``/``init_prev`` (its scratch start),
``max_steps``, ``_start(k)`` (a fresh carry and control block) and
``_superstep(ctrl, k)``; ``ShardEngine`` builds ``attempt`` and ``sweep``
on them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dgc_tpu_torch.engine.base import (AttemptResult, AttemptStatus,
                                       empty_budget_failure,
                                       finish_sweep_pair)
from dgc_tpu_torch.engine.bucketed import STALL_WINDOW
from dgc_tpu_torch.kernels import shard as ks
from dgc_tpu_torch.kernels.compact import META_COLS, REC_SLOTS
from dgc_tpu_torch.kernels.superstep import CTRL_STATUS, CTRL_STEP
from dgc_tpu_torch.obs.kernel import decode_trajectory, traj_cap_for, traj_empty
from dgc_tpu_torch.parallel.mesh import fetch_global

__all__ = ["SHARD_CHUNK", "ShardEngine", "device_sweep_pair_resumable",
           "finish_sweep_pair", "run_pipeline", "run_windowed",
           "shard_rec_empty", "shard_superstep_epilogue"]

SHARD_CHUNK = 16  # supersteps enqueued per read of the control block
_RUNNING = int(AttemptStatus.RUNNING)


def run_windowed(run: Callable, widen: Callable[[], bool]):
    """Drive a capped-window run: ``run() -> (outs, status)``, and while it
    ends STALLED with a widenable window, widen and run again. Returns
    ``(outs, status)``."""
    while True:
        outs, status = run()
        if status == AttemptStatus.STALLED and widen():
            continue
        return outs, status


def shard_rec_empty(v_local: int, nb: int, device) -> tuple:
    """The per-shard prefix-resume ring, empty: (ring_pe int32[4, V_l],
    ring_ba int32[4, nb], ring_meta int32[4, 5]), the shard's words, the
    live counts of its ``nb`` live-table columns and the meta of four
    pushes (``compact._empty_rec``'s layout); its count and best
    candidate live in the control block (``kernels.shard``)."""
    return (torch.zeros((REC_SLOTS, v_local), dtype=torch.int32, device=device),
            torch.zeros((REC_SLOTS, nb), dtype=torch.int32, device=device),
            torch.full((REC_SLOTS, META_COLS), -1, dtype=torch.int32,
                       device=device))


def shard_superstep_epilogue(engine, ctrl, ring, traj=None) -> None:
    """The tail of every sharded superstep: the two reductions of the
    step's counters over the ranks, then K21."""
    engine.mesh.all_reduce(ctrl[ks.SUM_SLOTS], "sum")
    engine.mesh.all_reduce(ctrl[ks.MAX_SLOTS], "max")
    ks.shard_finish(ctrl, engine.packed_l, engine.back, ring,
                    ring is not None, engine.live, engine.nh,
                    engine.gc_const, engine.max_steps, STALL_WINDOW, traj)


def run_pipeline(engine, k: int, ctrl, ring=None, traj=None) -> list:
    """Run the attempt whose control block is ``ctrl`` at budget ``k`` to
    its end, pushing into ``ring`` when given and recording into ``traj``
    when given; returns the control block read at the end. On the card the
    supersteps go in chunks of ``SHARD_CHUNK`` (those past the end change
    nothing); on the CPU the loop stops at the end."""
    on_cpu = ctrl.device.type == "cpu"
    while True:
        for _ in range(SHARD_CHUNK):
            engine._exchange()
            engine._superstep(ctrl, k)
            shard_superstep_epilogue(engine, ctrl, ring, traj)
            if on_cpu and int(ctrl[CTRL_STATUS]) != _RUNNING:
                break
        c = ctrl.tolist()
        if c[CTRL_STATUS] != _RUNNING:
            return c


def device_sweep_pair_resumable(engine, k0: int, traj1=None,
                                traj2=None) -> list:
    """The fused jump-mode pair on every shard: the attempt at ``k0``,
    pushing the pre-state of each new-max-candidate superstep into the
    ring; the max color reduced over the ranks; K22 (the result slot
    ``p1``, and the confirm at ``used − 1`` restored from the ring entry
    whose bracket holds it, or from scratch); then the confirm, which
    continues the entry's step counter, so its steps, status and colors
    equal a scratch run's. Returns the final control block (phase 2 when
    no confirm ran; ``SC_STEPS1``/``SC_STATUS1``/``SC_USED`` hold phase
    0's result)."""
    ctrl = engine._start(k0)
    ring = shard_rec_empty(engine.packed_l.shape[0],
                           1 if engine.live is None else engine.live.shape[1],
                           engine.packed_l.device)
    run_pipeline(engine, k0, ctrl, ring, traj1)
    engine.mesh.all_reduce(ctrl[ks.MAX_SLOTS], "max")  # the max color
    ks.shard_pair(ctrl, engine.packed_l, engine.p1, engine.deg_l,
                  engine.init_word, ring, engine.live, engine.nh,
                  engine.init_ba, engine.init_step, engine.init_prev,
                  engine.gc_const)
    c = ctrl.tolist()
    if c[ks.SC_PHASE] == 1:
        c = run_pipeline(engine, c[ks.SC_K], ctrl, None, traj2)
    return c


class ShardEngine:
    """``attempt`` and ``sweep`` of a sharded engine on the loop above.
    A subclass provides the loop's attributes (module docstring),
    ``num_vertices``, ``_budget(k)`` (the budget its kernels run),
    ``_widen()`` (the window retry: True iff it widened) and
    ``_colors(packed)`` (the true vertices' colors from the gathered
    carry). With ``record_trajectory`` on, K21's recording variant writes
    each superstep's row of the attempt's trajectory buffer, which is the
    same on every rank. ``resumed_from_step`` is the step the last
    sweep's confirm resumed from (None: from scratch, or no confirm)."""

    record_trajectory = False
    resumed_from_step = None

    def _exchange(self) -> None:
        """The superstep's exchange before the rule kernels: every shard's
        carry all-gathered into buffer 0 of ``state``."""
        self.mesh.all_gather(self.state[0, : self.state.shape[1] - 2],
                             self.packed_l)

    def _traj(self):
        if not self.record_trajectory:
            return None
        return traj_empty(traj_cap_for(self.max_steps),
                          device=self.packed_l.device)

    def _result(self, status, carry, steps: int, k: int, traj):
        packed = fetch_global(carry, self.mesh)
        colors = self._colors(np.where(packed >= 0, packed >> 1, -1)
                              .astype(np.int32))
        return AttemptResult(
            AttemptStatus(status), colors, int(steps), int(k),
            trajectory=(None if traj is None else
                        decode_trajectory(fetch_global(traj), steps)))

    def attempt(self, k: int) -> AttemptResult:
        if k < 1:
            return empty_budget_failure(self.num_vertices, k)
        k_run = self._budget(k)

        def run():
            traj = self._traj()
            c = run_pipeline(self, k_run, self._start(k_run), None, traj)
            return (c, traj), AttemptStatus(c[CTRL_STATUS])

        (c, traj), status = run_windowed(run, self._widen)
        return self._result(status, self.packed_l, c[CTRL_STEP], k, traj)

    def sweep(self, k0: int) -> tuple[AttemptResult, AttemptResult | None]:
        """The fused jump-mode pair (``device_sweep_pair_resumable``):
        equal to ``attempt(k0)`` then ``attempt(used − 1)``; a STALLED
        first attempt widens and runs the pair again, a STALLED confirm
        falls back to ``attempt``."""
        if k0 < 1:
            return self.attempt(k0), None

        def run():
            traj1, traj2 = self._traj(), self._traj()
            c = device_sweep_pair_resumable(self, self._budget(k0), traj1,
                                            traj2)
            return (c, traj1, traj2), AttemptStatus(c[ks.SC_STATUS1])

        (c, traj1, traj2), status1 = run_windowed(run, self._widen)
        self.resumed_from_step = (c[ks.SC_RESUMED] if c[ks.SC_PHASE] == 1
                                  and c[ks.SC_RESUMED] >= 0 else None)
        first = self._result(status1, self.p1, c[ks.SC_STEPS1], k0, traj1)

        def finish_second(k2: int) -> AttemptResult:
            return self._result(c[CTRL_STATUS], self.packed_l, c[CTRL_STEP],
                                k2, traj2)

        status2 = (c[CTRL_STATUS] if c[ks.SC_PHASE] == 1
                   else int(AttemptStatus.FAILURE))
        return finish_sweep_pair(first, c[ks.SC_USED], status2, finish_second,
                                 self.num_vertices, self.attempt)
