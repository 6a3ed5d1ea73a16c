"""The hub region's ladder: the plain PyTorch versions of its branches.

Port of the hub ladder of ``dgc_tpu.engine.compact`` (``:245-809``). A hub
bucket is a degree bucket wider than the flat cap (few rows, huge widths,
e.g. the hubs of an RMAT graph). Each superstep it takes one branch, by
its live count ``ba`` (active rows at the last step) and its prune tier:

- ``skip``: no active row, nothing changes;
- ``full``: every row against its whole table row (``bucket_update``);
- ``compact``: only the ≤ pad active rows (``compact_core``), for a bucket
  without a prune config once its live count fits ``hub_pad_for``;
- ``rebase``: ``compact`` plus the tier-1 capture: each active row's ≤ U
  unconfirmed neighbors in column order, the planes of its confirmed
  neighbors' colors (``conf``), and ``ok`` (every row had ≤ U);
- ``pruned``: the captured slots against only their ≤ U captured
  neighbors, with ``conf`` OR'd into both forbidden sets;
- ``shrink``: tier 1's still-active slots row-compacted into the tier-2
  pad ``P2``, then ``pruned`` on them; ``pruned2`` reruns on tier 2.

Every branch is exact: a confirmed vertex never becomes active again, so
a row outside the evaluated set transitions to itself, and a neighbor
outside the captured list was confirmed at the capture, its color final
and in ``conf``. Unconditioned buckets (tables ≤ ``HUB_UNCOND_ENTRIES``)
always take ``full``. These functions are what the hub kernels
(``kernels.hub``, ``csrc/hub.cu``) are held against and what they run for
tensors on the CPU; ``hub_branch`` is the index of ``_hub_dispatch``.
"""

from __future__ import annotations

import torch

from dgc_tpu_torch.kernels.compact import compact_idx
from dgc_tpu_torch.ops.bitmask import forbidden_planes
from dgc_tpu_torch.ops.segmented_gather import fail_gate, unconf_counts
from dgc_tpu_torch.ops.speculative import (apply_update_mc, decode_combined,
                                           neighbor_stats,
                                           speculative_update_mc)

BRANCH_NAMES = ("skip", "full", "compact", "rebase", "pruned", "shrink",
                "pruned2")
(BRANCH_SKIP, BRANCH_FULL, BRANCH_COMPACT, BRANCH_REBASE, BRANCH_PRUNED,
 BRANCH_SHRINK, BRANCH_PRUNED2) = range(len(BRANCH_NAMES))

# below this many table entries a hub bucket runs unconditioned
HUB_UNCOND_ENTRIES = 1 << 17


def pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def hub_pad_for(rows: int) -> int:
    """Row-compaction pad for a hub bucket (0 = never compact): buckets
    with a ≥4× row-to-pad ratio get a compacted branch."""
    pad = pow2_ceil(max(rows // 8, 32))
    return pad if rows > 4 * pad else 0


def hub_prune_cfg(rows: int, width: int, u_min: int = 128,
                  u_div: int = 4,
                  uncond_entries: int | None = None,
                  p2_min: int = 32,
                  p_div: int = 2,
                  p2_div: int = 8) -> tuple | None:
    """Static neighbor-pruning config ``(P, U)`` or ``(P, U, P2)`` for a
    hub bucket, or None: ``U`` the pruned width, ``P`` the slot pad, ``P2``
    the tier-2 re-capture pad (see ``dgc_tpu.engine.compact``)."""
    for name, val in (("u_div", u_div), ("p_div", p_div),
                      ("p2_div", p2_div)):
        if not isinstance(val, int) or val < 1:
            raise ValueError(
                f"hub prune divisor {name} must be a positive int, "
                f"got {val!r}")
    if rows * width <= (HUB_UNCOND_ENTRIES if uncond_entries is None
                        else uncond_entries):
        return None
    u = max(u_min, min(width // u_div, 2048))
    if 2 * u > width:
        return None
    p = min(pow2_ceil(max(rows // p_div, 32)), rows)
    p2 = min(pow2_ceil(max(p // p2_div, p2_min)), rows)
    return (p, u, p2) if p2 < p else (p, u)


def hub_branch(ba: int, tier: int, rows: int, cfg: tuple | None,
               uncond: bool = False, pad: int | None = None) -> int:
    """The branch ``_hub_dispatch`` takes for a bucket of ``rows`` rows
    with live count ``ba`` and prune tier ``tier`` under ``cfg`` (None:
    the pad ladder, at ``pad`` or ``hub_pad_for(rows)``; ``(P, U)`` or
    ``(P, U, P2)``). A pad that covers the bucket never takes ``full``."""
    if uncond:
        return BRANCH_FULL
    if ba == 0:
        return BRANCH_SKIP
    if cfg is None:
        pad = hub_pad_for(rows) if pad is None else pad
        return BRANCH_COMPACT if 0 < pad and ba <= pad else BRANCH_FULL
    pad = cfg[0]
    if len(cfg) == 3:
        if tier == 2:
            return BRANCH_PRUNED2
        if tier == 1:
            return BRANCH_SHRINK if ba <= cfg[2] else BRANCH_PRUNED
    elif tier == 1:
        return BRANCH_PRUNED
    return BRANCH_REBASE if ba <= pad or pad >= rows else BRANCH_FULL


def reduce_bucket_result(new_b, fail_mask, act_mask, mc, width: int,
                         p_b: int, k):
    """Every branch's epilogue: the counts, the fail count gated by the
    capped-window rule (``ops.segmented_gather.fail_gate``)."""
    fv = int(fail_gate(width, p_b, k))
    return (new_b, fail_mask.sum().to(torch.int32) * fv,
            act_mask.sum().to(torch.int32), mc)


def _active(pk: torch.Tensor) -> torch.Tensor:
    return (pk < 0) | ((pk & 1) == 1)


def _gather(pe: torch.Tensor, v: int, comb: torch.Tensor):
    nb, beats = decode_combined(comb)
    return nb, beats, pe[: v + 1][nb.to(torch.int64)]


def _scatter(pk_b: torch.Tensor, slots: torch.Tensor, new_slot: torch.Tensor):
    """``pk_b`` with the real slots' rows replaced (dummy slots ≥ rows are
    dropped)."""
    real = slots < pk_b.shape[0]
    out = pk_b.clone()
    out[slots[real].to(torch.int64)] = new_slot[real]
    return out


def _slot_words(pk_b: torch.Tensor, slots: torch.Tensor):
    """(real, words) of a slot list: dummy slots read as confirmed color 0."""
    real = slots < pk_b.shape[0]
    safe = torch.where(real, slots, 0).to(torch.int64)
    return real, torch.where(real, pk_b[safe], 0)


def bucket_update(pe, pk_b, cb, p_b: int, k, v: int):
    """One bucket's superstep against the ``pe`` snapshot: ``(new_pk_b,
    fail, act, mc)`` (``_bucket_update``)."""
    _, beats, np_ = _gather(pe, v, cb)
    new_b, fail_mask, act_mask, mc = speculative_update_mc(
        pk_b, np_, beats, k, p_b)
    return reduce_bucket_result(new_b, fail_mask, act_mask, mc, cb.shape[1],
                                p_b, k)


def compact_core(pe, pk_b, cb, p_b: int, k, v: int, pad: int, idx=None):
    """The row-compacted superstep of the compact and rebase branches
    (``_compact_core``): ``(new_b, fail, act, mc, (idx, real, cb_slot,
    np_))``. ``idx`` is the slot list, ``compact_idx`` of the bucket's
    active rows unless given (the hub kernels compute it beforehand)."""
    vb = cb.shape[0]
    if idx is None:
        idx = compact_idx(_active(pk_b), pad, vb)
    real, pk_slot = _slot_words(pk_b, idx)
    cb_slot = cb[torch.where(real, idx, 0).to(torch.int64)]
    _, beats, np_ = _gather(pe, v, cb_slot)
    new_slot, fail_mask, act_mask, mc = speculative_update_mc(
        pk_slot, np_, beats, k, p_b)
    return reduce_bucket_result(_scatter(pk_b, idx, new_slot), fail_mask,
                                act_mask, mc, cb.shape[1], p_b, k) + (
        (idx, real, cb_slot, np_),)


def bucket_update_compact(pe, pk_b, cb, p_b: int, k, v: int, pad: int,
                          idx=None):
    """``bucket_update`` on the bucket's ≤ ``pad`` active rows only
    (``_bucket_update_compact``)."""
    return compact_core(pe, pk_b, cb, p_b, k, v, pad, idx)[:4]


def bucket_update_rebase(pe, pk_b, cb, p_b: int, k, v: int, pad: int,
                         u: int, idx=None):
    """``compact_core`` plus the tier-1 capture from the same pre-state
    gather (``_bucket_update_rebase``): ``(new_b, fail, act, mc, (ok, idx,
    comb_u int32[pad, u], conf int32[pad, p_b]))``; ``ok`` is 1 iff every
    slot had ≤ ``u`` unconfirmed neighbors."""
    new_b, fail, act, mc, (idx, real, cb_slot, np_) = compact_core(
        pe, pk_b, cb, p_b, k, v, pad, idx)
    nb, _ = decode_combined(cb_slot)
    realn = (nb < v) & real[:, None]
    unconf = realn & ~((np_ >= 0) & ((np_ & 1) == 0))
    cnt = unconf.sum(dim=1)
    ok = torch.tensor(int(cnt.max()) <= u if cnt.numel() else True,
                      dtype=torch.int32)
    pos = torch.cumsum(unconf.to(torch.int32), dim=1) - 1
    keep = unconf & (pos < u)
    rows = torch.arange(pad, device=pos.device)[:, None].expand_as(pos)
    comb_u = torch.full((pad, u), v, dtype=torch.int32, device=cb.device)
    comb_u[rows[keep], pos[keep].to(torch.int64)] = cb_slot[keep]
    conf = forbidden_planes(torch.where(unconf | ~realn, -1, np_ >> 1), p_b)
    return new_b, fail, act, mc, (ok, idx, comb_u, conf)


def bucket_update_pruned(pe, pk_b, tier, p_b: int, k, width: int, v: int):
    """The superstep of the captured slots ``tier = (slots, comb, conf)``
    against their captured neighbors only, ``conf`` OR'd into both
    forbidden sets; the fail gate takes the bucket's full ``width``
    (``_bucket_update_pruned``)."""
    slots, comb, conf = tier
    _, pk_slot = _slot_words(pk_b, slots)
    _, beats, np_ = _gather(pe, v, comb)
    forb_all, forb_old, clash = neighbor_stats(np_, beats, pk_slot >> 1, p_b)
    new_slot, fail_mask, act_mask, mc = apply_update_mc(
        pk_slot, forb_all | conf, forb_old | conf, clash, k)
    return reduce_bucket_result(_scatter(pk_b, slots, new_slot), fail_mask,
                                act_mask, mc, width, p_b, k)


def bucket_update_shrink(pe, pk_b, tier1, p_b: int, k, width: int, v: int,
                         p2: int, sel=None):
    """The tier-2 re-capture and its superstep
    (``_bucket_update_shrink``): tier 1's active slots row-compacted into
    ``p2`` (``sel``, positions into tier 1, unless given), then
    ``bucket_update_pruned`` on them. Returns the update and the tier-2
    capture ``(slots2, comb2, conf2)``."""
    slots1, comb1, conf1 = tier1
    p1 = slots1.shape[0]
    _, pk_slot = _slot_words(pk_b, slots1)
    if sel is None:
        sel = compact_idx(_active(pk_slot), p2, p1)
    real2 = sel < p1
    safe = torch.where(real2, sel, 0).to(torch.int64)
    tier2 = (torch.where(real2, slots1[safe], pk_b.shape[0]),
             torch.where(real2[:, None], comb1[safe], v),
             torch.where(real2[:, None], conf1[safe], 0))
    return bucket_update_pruned(pe, pk_b, tier2, p_b, k, width, v) + (tier2,)


def fresh_prune(buckets, hub_buckets: int, planes: tuple, hub_prune: tuple,
                v: int) -> tuple:
    """Each hub bucket's prune state, invalid (tier 0), or None where it
    has no prune config (``_fresh_prune``): ``(tier, slots, comb, conf)``
    plus ``(slots2, comb2, conf2)`` under a tier-2 config."""
    out = []
    for bi in range(hub_buckets):
        cfg = hub_prune[bi] if bi < len(hub_prune) else None
        if cfg is None:
            out.append(None)
            continue
        vb = buckets[bi].shape[0]
        tiers = [(cfg[0], cfg[1])] + ([(cfg[2], cfg[1])] if len(cfg) == 3
                                      else [])
        ps = (torch.tensor(0, dtype=torch.int32),)
        for p, u in tiers:
            ps += (torch.full((p,), vb, dtype=torch.int32),
                   torch.full((p, u), v, dtype=torch.int32),
                   torch.zeros((p, planes[bi]), dtype=torch.int32))
        out.append(ps)
    return tuple(out)


def run_branch(branch: int, pe, pk_b, cb, p_b: int, k, v: int, ps=None,
               cfg: tuple | None = None, idx=None):
    """One branch of a bucket: ``(new_pk_b, fail, act, mc, ps')``. ``ps``
    is the bucket's prune state (``fresh_prune``'s layout) or None;
    ``idx`` the compact/rebase slot list or the shrink ``sel`` when
    computed beforehand."""
    w = cb.shape[1]
    if branch == BRANCH_SKIP:
        return (pk_b, torch.tensor(0, dtype=torch.int32),
                torch.tensor(0, dtype=torch.int32),
                torch.tensor(-1, dtype=torch.int32), ps)
    if branch == BRANCH_FULL:
        return bucket_update(pe, pk_b, cb, p_b, k, v) + (ps,)
    if branch == BRANCH_COMPACT:
        pad = cfg[0] if cfg is not None else hub_pad_for(cb.shape[0])
        return bucket_update_compact(pe, pk_b, cb, p_b, k, v, pad, idx) + (ps,)
    if branch == BRANCH_REBASE:
        r = bucket_update_rebase(pe, pk_b, cb, p_b, k, v, cfg[0], cfg[1], idx)
        return r[:4] + (r[4] + tuple(ps[4:]),)
    if branch == BRANCH_PRUNED:
        return bucket_update_pruned(pe, pk_b, ps[1:4], p_b, k, w, v) + (ps,)
    if branch == BRANCH_PRUNED2:
        return bucket_update_pruned(pe, pk_b, ps[4:7], p_b, k, w, v) + (ps,)
    r = bucket_update_shrink(pe, pk_b, ps[1:4], p_b, k, w, v, cfg[2], idx)
    return r[:4] + ((torch.tensor(2, dtype=torch.int32),) + tuple(ps[1:4])
                    + r[4],)


def unconf_max(pe, v: int, comb, words) -> int:
    """The max count of unconfirmed real neighbors among the entries
    ``comb`` (int32[R, W]) of the rows whose words before the step are
    ``words`` (int32[R]), over the active rows (0 for none): the unconf
    telemetry of ``_unconf_max``."""
    _, _, np_ = _gather(pe, v, comb)
    cnt = unconf_counts(comb, np_, v).sum(dim=1)
    live = torch.where(_active(words), cnt, 0)
    return int(live.max()) if live.numel() else 0


def branch_unconf(branch: int, pe, pk_b, cb, v: int, ps=None,
                  cfg: tuple | None = None, idx=None) -> int:
    """``unconf_max`` over what ``branch`` evaluates, before it runs: the
    whole bucket (``full``), its slot rows (``compact``/``rebase``, slot
    list ``idx``), or the captured slots against their captured neighbor
    lists (``pruned``/``pruned2``, and ``shrink`` on tier 1's slots
    ``sel = idx``); 0 for ``skip``."""
    if branch == BRANCH_SKIP:
        return 0
    if branch == BRANCH_FULL:
        return unconf_max(pe, v, cb, pk_b)
    if branch in (BRANCH_COMPACT, BRANCH_REBASE):
        if idx is None:
            pad = cfg[0] if cfg is not None else hub_pad_for(cb.shape[0])
            idx = compact_idx(_active(pk_b), pad, cb.shape[0])
        real, words = _slot_words(pk_b, idx)
        return unconf_max(pe, v, cb[torch.where(real, idx, 0).to(torch.int64)],
                          words)
    if branch in (BRANCH_PRUNED, BRANCH_PRUNED2):
        slots, comb = (ps[1], ps[2]) if branch == BRANCH_PRUNED \
            else (ps[4], ps[5])
        return unconf_max(pe, v, comb, _slot_words(pk_b, slots)[1])
    slots1, comb1 = ps[1], ps[2]
    if idx is None:
        idx = compact_idx(_active(_slot_words(pk_b, slots1)[1]), cfg[2],
                          slots1.shape[0])
    real = idx < slots1.shape[0]
    safe = torch.where(real, idx, 0).to(torch.int64)
    slots = torch.where(real, slots1[safe], pk_b.shape[0])
    return unconf_max(pe, v, comb1[safe], _slot_words(pk_b, slots)[1])


def hub_dispatch(pe, ba, pk_b, cb, p_b: int, k, v: int, ps=None,
                 cfg: tuple | None = None, uncond: bool = False):
    """One hub bucket's superstep through its ladder (``_hub_dispatch``):
    ``(new_pk_b, fail, act, mc, ps')``."""
    tier = int(ps[0]) if ps is not None else 0
    branch = hub_branch(int(ba), tier, cb.shape[0], cfg, uncond)
    return run_branch(branch, pe, pk_b, cb, p_b, k, v, ps, cfg)
