"""In-kernel superstep telemetry (port of ``dgc_tpu.obs.kernel``).

An attempt records one int32 row per superstep into a capped trajectory
buffer on the device: the kernel that folds a superstep's counters into
the loop carry (K2 ``superstep_finish``, K6 ``stage_finish``) writes the
row from those counters in the same thread, before it clears them, so
recording adds no launch and no host sync. The buffer comes home with the
attempt's existing read of its colors row (``read_home``).

Buffer layout: ``int32[cap, TRAJ_COLS + nb]`` (``nb`` doubled when the
per-bucket max-unconf vector rides too), row ``s`` holding superstep
``s`` (the engine's step counter):

- col 0: the active count after the superstep;
- col 1: 1 iff the superstep tripped the failure predicate;
- col 2: the superstep's divergence candidate ``mc`` (−1 where the engine
  does not record it);
- col 3: the superstep's neighbor-gather call count (−1: not recorded);
- col 4: the superstep's max unconfirmed-neighbor count over its active
  gathered rows (−1: not recorded); with the per-bucket vector, its max;
- col 5: the superstep's clock timestamp (masked µs, ``obs.devclock``;
  −1 unless timing is on);
- cols 6..6+nb: per-bucket active counts (hub buckets, then the flat
  region's total; the compact engine only);
- cols 6+nb..6+2·nb: per-bucket max unconfirmed-neighbor counts in the
  same layout.

Unwritten rows keep the −1 fill, so the decoder recovers the written span
(a prefix-resumed confirm starts mid-buffer); rows past ``cap`` are
dropped on the device and ``truncated`` flags it. Recording is a
compile-time choice in the kernels (a template parameter): without it
they are the kernels that record nothing.

``trajstep`` is the plain row write the kernels' plain versions share;
``SuperstepTrajectory``, ``decode_trajectory`` and
``decode_block_trajectories`` are ``dgc_tpu``'s, in behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgc_tpu_torch.layout import (COL_ACTIVE, COL_FAIL, COL_GATHER_CALLS,
                                  COL_MAX_UNCONF, COL_MC, COL_TS_US,
                                  TRAJ_COLS, TRAJ_FILL)
from dgc_tpu_torch.obs.devclock import wrap_delta_us

DEFAULT_TRAJ_CAP = 4096


def traj_cap_for(max_steps: int, cap: int = DEFAULT_TRAJ_CAP) -> int:
    """Row budget of a trajectory buffer: the attempt's step bound,
    clamped so an O(V) safety bound cannot allocate an O(V) buffer."""
    return max(1, min(int(max_steps) + 1, cap))


def traj_cols(nb: int = 0, unconf_b: bool = False) -> int:
    """The width of a row with an ``nb``-bucket tail (doubled by the
    per-bucket max-unconf vector)."""
    return TRAJ_COLS + nb * (2 if unconf_b else 1)


def traj_empty(cap: int, nb: int = 0, unconf_b: bool = False,
               device="cpu") -> torch.Tensor:
    """A fresh trajectory buffer (−1 fill = unwritten) on ``device``."""
    return torch.full((cap, traj_cols(nb, unconf_b)), TRAJ_FILL,
                      dtype=torch.int32, device=device)


def trajstep(traj: torch.Tensor, step: int, active: int, any_fail: bool,
             mc: int = -1, gcalls: int = -1, ba=None, unconf=None,
             ts: int = -1) -> None:
    """Write row ``step`` of ``traj`` in place; a step past the buffer is
    dropped. ``unconf`` is None (col 4 −1), a scalar (col 4), or the
    per-bucket vector in the ``ba`` layout (the tail, its max in col 4,
    0 for an empty vector)."""
    if not 0 <= step < traj.shape[0]:
        return
    unconf_vec = None
    if unconf is not None and np.ndim(unconf) == 1:
        unconf_vec = [int(u) for u in unconf]
        unconf = max(unconf_vec, default=0)
    row = [int(active), int(bool(any_fail)), int(mc), int(gcalls),
           -1 if unconf is None else int(unconf), int(ts)]
    if ba is not None:
        row += [int(a) for a in ba]
    if unconf_vec is not None:
        row += unconf_vec
    traj[step] = torch.tensor(row, dtype=torch.int32)


@dataclass
class SuperstepTrajectory:
    """Host-side decoded per-attempt trajectory."""

    active: np.ndarray                 # int32[S] global actives per superstep
    fail: np.ndarray                   # int32[S] failure flag per superstep
    mc: np.ndarray                     # int32[S] divergence candidate (−1: n/a)
    gather_calls: np.ndarray           # int32[S] neighbor-gather calls (−1: n/a)
    max_unconf: np.ndarray             # int32[S] max unconfirmed nbrs (−1: n/a)
    bucket_active: np.ndarray | None   # int32[S, nb] bucket occupancy, or None
    first_step: int                    # step index of row 0 (resume offset)
    truncated: bool                    # steps ran past the buffer cap
    max_unconf_bucket: np.ndarray | None = None  # int32[S, nb] per-bucket
                                       # max unconf (bucket-active layout)
    step_us: np.ndarray | None = None  # int32[S] per-superstep wall µs (col-5
                                       # deltas; −1 for the span's first row)

    def __len__(self) -> int:
        return len(self.active)

    def to_dict(self) -> dict:
        d = {
            "active": self.active.tolist(),
            "fail": self.fail.tolist(),
            "mc": self.mc.tolist(),
            "gather_calls": self.gather_calls.tolist(),
            "max_unconf": self.max_unconf.tolist(),
            "first_step": self.first_step,
            "truncated": self.truncated,
        }
        if self.bucket_active is not None:
            d["bucket_active"] = self.bucket_active.tolist()
        if self.max_unconf_bucket is not None:
            d["max_unconf_bucket"] = self.max_unconf_bucket.tolist()
        if self.step_us is not None:
            d["step_us"] = self.step_us.tolist()
        return d


def decode_trajectory(buf, supersteps: int | None = None,
                      unconf_b: bool = False) -> SuperstepTrajectory:
    """Decode a trajectory buffer into the written span.

    Written rows have ``active >= 0``; the span is contiguous.
    ``supersteps`` (the attempt's final step counter) flags truncation
    when it ran past the buffer cap. ``unconf_b`` marks a doubled bucket
    tail: the second ``nb`` columns decode as the per-bucket max-unconf
    vector."""
    buf = np.asarray(buf)
    written = buf[:, COL_ACTIVE] >= 0
    idx = np.flatnonzero(written)
    if len(idx) == 0:
        empty = np.zeros(0, np.int32)
        return SuperstepTrajectory(empty, empty, empty, empty, empty,
                                   None, 0, False)
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    span = buf[lo:hi]
    tail = buf.shape[1] - TRAJ_COLS
    nb = tail // 2 if unconf_b else tail
    truncated = bool(supersteps is not None and supersteps > buf.shape[0])
    # timestamps → per-superstep deltas: row i's time is ts[i] − ts[i−1]
    # (wrap-safe); the span's first row has no predecessor in the span
    ts = span[:, COL_TS_US].astype(np.int32)
    step_us = None
    if (ts >= 0).any():
        step_us = np.full(len(ts), TRAJ_FILL, np.int32)
        ok = (ts[1:] >= 0) & (ts[:-1] >= 0)
        step_us[1:][ok] = wrap_delta_us(ts[:-1][ok], ts[1:][ok])
    return SuperstepTrajectory(
        active=span[:, COL_ACTIVE].astype(np.int32),
        fail=span[:, COL_FAIL].astype(np.int32),
        mc=span[:, COL_MC].astype(np.int32),
        gather_calls=span[:, COL_GATHER_CALLS].astype(np.int32),
        max_unconf=span[:, COL_MAX_UNCONF].astype(np.int32),
        bucket_active=(span[:, TRAJ_COLS:TRAJ_COLS + nb].astype(np.int32)
                       if nb > 0 else None),
        first_step=lo,
        truncated=truncated,
        max_unconf_bucket=(
            span[:, TRAJ_COLS + nb:TRAJ_COLS + 2 * nb].astype(np.int32)
            if unconf_b and nb > 0 else None),
        step_us=step_us,
    )


def decode_block_trajectories(stack, att_steps, n_att: int,
                              unconf_b: bool = False) -> list:
    """Decode an attempt block's stacked buffer (int32[A, cap, cols],
    ``layout.BK_TRAJ``) into one ``SuperstepTrajectory`` per executed
    attempt; ``att_steps`` holds each attempt's final step counter (its
    truncation flag). A prefix-resumed attempt records only its
    post-resume rows, as the fused pair's confirm does."""
    stack = np.asarray(stack)
    att_steps = np.asarray(att_steps)
    return [decode_trajectory(stack[i], int(att_steps[i]), unconf_b=unconf_b)
            for i in range(int(n_att))]


def read_home(*tensors: torch.Tensor) -> list:
    """The int32 ``tensors`` (one device) copied home with one copy, as
    numpy arrays of their shapes: a trajectory rides the copy of the
    colors row that the attempt makes anyway, so recording adds no host
    sync."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off: off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out
