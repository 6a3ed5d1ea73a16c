"""The speculative superstep rule — the plain PyTorch version.

Port of ``dgc_tpu.ops.speculative``: one function owns the conflict-rule
semantics (demote → first-fit → assign/confirm); the engines differ only
in how they gather neighbor state. The superstep kernel
(``kernels.superstep``, ``csrc/superstep.cu``) fuses the gather with this
rule and is held against these functions bit for bit.

- ``neighbor_stats``: per-gather reduction to (forbidden planes, confirmed
  forbidden planes, clash mask).
- ``apply_update_mc``: the state transition from the stats, plus the
  divergence candidate ``mc``.

Also here: the combined-table encoding (neighbor id with the priority bit
at ``BEATS_BIT``), which ``dgc_tpu`` keeps in ``engine.bucketed``; both
engines of the port and the kernel read it.
"""

from __future__ import annotations

import numpy as np
import torch

from dgc_tpu_torch.ops.bitmask import first_fit, forbidden_planes

DIVERGE_BIG = 1 << 30  # "candidate" stand-in for a full forbidden window

BEATS_BIT = 30
NBR_MASK = (1 << BEATS_BIT) - 1


def beats_rule(n_deg, n_id, my_deg, my_id):
    """The (degree desc, id asc) priority: does the neighbor beat me?

    Works elementwise on broadcastable NumPy arrays or torch tensors — every
    engine derives its precomputed ``beats`` bits through this one function
    so the tie-break stays a single fact (reference ``coloring_optimized.py:
    170-172`` high-degree-wins; the id tie-break makes it a total order).
    """
    return (n_deg > my_deg) | ((n_deg == my_deg) & (n_id < my_id))


def decode_combined(combined):
    """Split a combined table entry into (neighbor id, beats flag)."""
    return combined & NBR_MASK, (combined >> BEATS_BIT) == 1


def encode_combined(nbrs: np.ndarray, beats: np.ndarray) -> np.ndarray:
    """Pack neighbor ids and beats flags into one int32 table (host-side)."""
    return nbrs | (beats.astype(np.int32) << BEATS_BIT)


def neighbor_stats(gathered: torch.Tensor, pre_beats: torch.Tensor,
                   mycol: torch.Tensor, num_planes: int):
    """Reduce one gathered neighbor block to per-vertex stats.

    Args:
      gathered: int32[Vl, W] — neighbor packed state (``color·2 + fresh``;
        −1 for uncolored neighbors and ELL padding).
      pre_beats: bool[Vl, W] — does neighbor slot j beat vertex i?
      mycol: int32[Vl] — this block's current colors (−1 = uncolored).

    Returns ``(forb_all int32[Vl, P], forb_old int32[Vl, P], clash
    bool[Vl])``, the planes as int32 bit patterns.
    """
    nvalid = gathered >= 0
    ncol = torch.where(nvalid, gathered >> 1, -1)
    nfresh = nvalid & ((gathered & 1) == 1)

    # fresh-fresh conflict (confirmed colors are conflict-free by induction)
    clash = (nfresh & (ncol == mycol[:, None]) & pre_beats).any(dim=1)

    # forbidden sets: all colored neighbors (for candidates) and confirmed
    # ones only (for exact reference failure semantics)
    forb_all = forbidden_planes(ncol, num_planes)
    forb_old = forbidden_planes(torch.where(nfresh, -1, ncol), num_planes)
    return forb_all, forb_old, clash


def apply_update_mc(packed_local: torch.Tensor, forb_all: torch.Tensor,
                    forb_old: torch.Tensor, clash: torch.Tensor, k):
    """State transition from the neighbor stats, plus the divergence
    candidate.

    Returns ``(new_packed int32[Vl], fail_mask bool[Vl], active_mask
    bool[Vl], mc int32 scalar tensor)``. ``mc`` is the max first-fit
    candidate any needy vertex reached (−1 if none; ``DIVERGE_BIG`` when a
    needy vertex's forbidden set covered the whole budget).
    """
    mycol = packed_local >> 1  # arithmetic shift: −1 stays −1
    myfresh = (packed_local >= 0) & ((packed_local & 1) == 1)
    uncol = packed_local < 0

    demote = myfresh & clash
    cand, nofree_all = first_fit(forb_all, k)
    _, fail_old = first_fit(forb_old, k)

    needs_color = uncol | demote
    assign = needs_color & ~nofree_all

    new_packed = torch.where(
        assign,
        cand * 2 + 1,                                        # speculative
        torch.where(
            demote,
            -1,                                              # re-pick later
            torch.where(myfresh, mycol * 2, packed_local),   # confirm
        ),
    ).to(torch.int32)
    fail_mask = needs_color & fail_old
    active_mask = (new_packed < 0) | ((new_packed & 1) == 1)
    cands = torch.where(needs_color,
                        torch.where(nofree_all, DIVERGE_BIG, cand), -1)
    mc = torch.cat([cands.to(torch.int32),
                    torch.full((1,), -1, dtype=torch.int32,
                               device=cands.device)]).max()
    return new_packed, fail_mask, active_mask, mc


def speculative_update_mc(packed_local, gathered, pre_beats, k,
                          num_planes: int):
    """One superstep's rule, single-gather form. Returns ``(new_packed,
    fail_mask, active_mask, mc)``."""
    mycol = packed_local >> 1
    forb_all, forb_old, clash = neighbor_stats(gathered, pre_beats, mycol,
                                               num_planes)
    return apply_update_mc(packed_local, forb_all, forb_old, clash, k)


def speculative_update(packed_local, gathered, pre_beats, k, num_planes: int):
    """``speculative_update_mc`` without ``mc``: ``(new_packed, fail_mask,
    active_mask)``."""
    return speculative_update_mc(packed_local, gathered, pre_beats, k,
                                 num_planes)[:3]
