"""Wrappers of the hub region's kernels (``csrc/hub.cu``), their plain
PyTorch versions, and the hub plan they share.

One superstep of the hub region (``dgc_tpu.engine.compact._hub_region_step``
and ``_hub_dispatch``) is two launches over every hub bucket at once:

- ``hub_slots`` (K7): per bucket, the branch of its ladder from its live
  count and prune tier (``engine.hub.hub_branch``), the copy of its rows
  from the current state buffer into the other one (a branch updates only
  some rows, and the buffers flip), and the slot list the branch needs:
  the ordered active rows for ``compact`` and ``rebase``, the positions of
  tier 1's active slots for ``shrink``;
- ``hub_superstep`` (K8): the chosen branch's rows against the current
  buffer, written into the other one; the fail, active and ``mc`` counts
  into the control block and the bucket's active count into the live
  table's staged row; the rebase and shrink captures into the pool.

Given the unconf vector ``umax`` (B11 telemetry), ``hub_superstep``
launches K8's recording variant, which also takes each bucket's max count
of unconfirmed real neighbors over the rows its branch evaluates that
were active before the step (``engine.hub.branch_unconf``) into
``umax[bucket]``; K6 writes the vector into the trajectory row.

The live table is ``kernels.compact.new_live``'s; K6 commits its staged
rows. A **hub plan** (``hub_plan``) describes the buckets: an int64
descriptor row each (``D_*``) and offsets into one int32 **pool** that
holds the slot lists and the prune captures (tier 1: ``[P]`` slots,
``[P, U]`` neighbor lists, ``[P, planes]`` confirmed planes; tier 2 the
same at ``P2``), each rebuilt when the windows widen.

K8 deals each bucket's items to a warp or to a block by the bucket's width
(``K8_BLOCK_WIDTH``: the plan lays the buckets' blocks out, ``k8_layout``)
and walks only each table row's real entries, up to the length the plan
takes once from the table (``hub_row_lengths``; K8 on the card needs a plan
made with the table, the plain version none). Past that length a row holds
the pad sentinel alone, which adds no color, capture or count, so the walk
gives the padded width's bytes.

For tensors on the CPU each wrapper runs its plain version, built on
``engine.hub``; for tensors on a card it launches its kernel or raises —
it never falls back. ``launch_counts`` counts launches per kernel,
``rec_launch_counts`` those of the recording variant.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dgc_tpu_torch.engine.hub import (BRANCH_COMPACT, BRANCH_REBASE,
                                      BRANCH_SHRINK, BRANCH_SKIP,
                                      branch_unconf, hub_branch, hub_pad_for,
                                      run_branch)
from dgc_tpu_torch.kernels.compact import (CTRL_ACTIVE, CTRL_CUR, CTRL_FAIL,
                                           CTRL_MC, LIVE_BA, LIVE_BA_NEXT,
                                           LIVE_BRANCH, LIVE_ROWS, LIVE_TIER,
                                           LIVE_TIER_NEXT, _check_cuda,
                                           _check_state, _clamp_k, _raise_on,
                                           compact_idx, stage_live)
from dgc_tpu_torch.kernels.superstep import (INT32_MAX, _check_int32, _stream,
                                             real_lengths)

SOURCE = "hub.cu"

KIND_UNCOND, KIND_PAD, KIND_PRUNE = range(3)

# K8's items: a warp each, or a block each from K8_BLOCK_WIDTH entries wide
# (kWarpItems, kBlockItems in csrc/hub.cu; PERF.md has the widths and the
# clusters of blocks that were timed)
K8_WARP_ITEMS, K8_BLOCK_ITEMS = range(2)
K8_WARPS = 16  # K8's warps a block (kK8Warps)
K8_BLOCK_WIDTH = 4096


class HubBucket(NamedTuple):
    """One hub bucket's descriptor (a row of ``HubPlan.desc``): its rows
    ``[row0, row0 + rows)`` of ``width`` entries at offset ``cb`` of the
    hub table, its window ``planes``; its ladder (``kind``), pad (the
    ``hub_pad_for`` pad or ``P``), ``u`` and ``p2`` (0 without a tier 2);
    and its pool regions (0 where unused)."""

    row0: int
    rows: int
    width: int
    planes: int
    cb: int
    kind: int
    pad: int
    u: int
    p2: int
    slots: int    # the compact/rebase slot list ([pad]; = slots1 under a cfg)
    sel: int      # shrink: positions into tier 1 ([p2])
    slots1: int
    comb1: int
    conf1: int
    slots2: int
    comb2: int
    conf2: int
    len0: int     # K8: the bucket's first row in the plan's lens
    block0: int   # K8: its first block
    mode: int     # K8: how its items are dealt (K8_*_ITEMS)

    @property
    def uncond(self) -> bool:
        return self.kind == KIND_UNCOND

    @property
    def cfg(self) -> tuple | None:
        if self.kind != KIND_PRUNE:
            return None
        return (self.pad, self.u) + ((self.p2,) if self.p2 else ())


class HubPlan(NamedTuple):
    buckets: tuple      # HubBucket per hub bucket
    desc: torch.Tensor  # int64[nh, len(HubBucket._fields)] on the device
    pool_size: int      # int32 words of the pool
    lens: torch.Tensor | None  # int32[Σ rows]: each row's real length
    blocks: int         # K8's grid


def k8_layout(rows, pads, p2s, widths) -> tuple[list, int]:
    """K8's grid over buckets of these shapes: each bucket's (first block,
    mode) and the blocks in all. A bucket holds blocks for its most items
    on any branch (rows, pad, P2): ``K8_WARPS`` items a block, or one."""
    out, block = [], 0
    for r, pad, p2, w in zip(rows, pads, p2s, widths):
        items = max(r, pad, p2, 1)
        mode = K8_BLOCK_ITEMS if w >= K8_BLOCK_WIDTH else K8_WARP_ITEMS
        out.append((block, mode))
        block += -(-items // K8_WARPS) if mode == K8_WARP_ITEMS else items
    return out, block


def hub_row_lengths(table: torch.Tensor, buckets, v: int) -> torch.Tensor:
    """int32[Σ rows] of ``buckets``' tables in ``table`` (HubBucket-like:
    ``cb``, ``rows``, ``width``): each row's real length, one past its last
    entry whose neighbor id is not the pad sentinel ``v`` (0 for a row of
    sentinels alone)."""
    out = [torch.zeros(0, dtype=torch.int32, device=table.device)]
    for b in buckets:
        if b.rows:
            out.append(real_lengths(table[b.cb: b.cb + b.rows * b.width]
                                    .view(b.rows, b.width), v))
    return torch.cat(out)


def hub_plan(row0s, sizes, widths, planes, hub_prune, hub_uncond,
             device, pads=None, table=None, v=None) -> HubPlan:
    """The plan of hub buckets ``0 .. len(sizes)-1``: their tables lie
    one after another from offset 0 of the hub table, in bucket order. A
    bucket without a prune config compacts at ``pads[bi]`` when given (the
    sharded slices' ``shard_pad_for``), else at ``hub_pad_for``. Given the
    hub ``table`` and its pad sentinel ``v``, the plan holds each row's
    real length (``hub_row_lengths``), which K8 on the card needs."""
    out = []
    pool = cb = 0

    def alloc(n: int) -> int:
        nonlocal pool
        pool += n
        return pool - n

    for bi, (row0, vb, w, p_b) in enumerate(zip(row0s, sizes, widths, planes)):
        uncond = bi < len(hub_uncond) and bool(hub_uncond[bi])
        cfg = None if uncond else (hub_prune[bi] if bi < len(hub_prune)
                                   else None)
        kind = (KIND_UNCOND if uncond else
                KIND_PAD if cfg is None else KIND_PRUNE)
        pad = ((hub_pad_for(vb) if pads is None else int(pads[bi]))
               if kind == KIND_PAD else (cfg[0] if cfg else 0))
        u = cfg[1] if cfg else 0
        p2 = cfg[2] if cfg and len(cfg) == 3 else 0
        regions = dict.fromkeys(("slots", "sel", "slots1", "comb1", "conf1",
                                 "slots2", "comb2", "conf2"), 0)
        if kind == KIND_PAD:
            regions["slots"] = alloc(pad)
        elif kind == KIND_PRUNE:
            regions.update(slots1=alloc(pad), comb1=alloc(pad * u),
                           conf1=alloc(pad * p_b))
            regions["slots"] = regions["slots1"]
            if p2:
                regions.update(sel=alloc(p2), slots2=alloc(p2),
                               comb2=alloc(p2 * u), conf2=alloc(p2 * p_b))
        out.append(HubBucket(int(row0), int(vb), int(w), int(p_b), cb, kind,
                             int(pad), int(u), int(p2), **regions, len0=0,
                             block0=0, mode=K8_WARP_ITEMS))
        cb += int(vb) * int(w)
    lay, blocks = k8_layout([b.rows for b in out], [b.pad for b in out],
                            [b.p2 for b in out], [b.width for b in out])
    lens = (None if table is None
            else hub_row_lengths(table, out, int(v)).to(device))
    first = 0  # each bucket's first row in lens
    for bi, (block0, mode) in enumerate(lay):
        out[bi] = out[bi]._replace(len0=first, block0=block0, mode=mode)
        first += out[bi].rows
    desc = torch.tensor([list(b) for b in out], dtype=torch.int64,
                        device=device).reshape(len(out), len(HubBucket._fields))
    return HubPlan(tuple(out), desc, max(pool, 1), lens, blocks)


def new_pool(plan: HubPlan, device) -> torch.Tensor:
    return torch.zeros(plan.pool_size, dtype=torch.int32, device=device)


launch_counts = {"hub_slots": 0, "hub_superstep": 0}
# the recording variant's launches (B11), apart from the kernels above
rec_launch_counts = {"hub_superstep_rec": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, rec_launch_counts):
        for name in counts:
            counts[name] = 0


# ---- plain versions ---------------------------------------------------------

def _active(words: torch.Tensor) -> torch.Tensor:
    return (words < 0) | ((words & 1) == 1)


def hub_slots_reference(ctrl, state, live, plan: HubPlan, pool, thresh: int,
                        max_steps: int) -> None:
    """K7's plain version."""
    if not stage_live(ctrl.tolist(), thresh, max_steps):
        return
    cur = int(ctrl[CTRL_CUR])
    src, dst = state[cur], state[1 - cur]
    for bi, b in enumerate(plan.buckets):
        tier = int(live[LIVE_TIER, bi])
        branch = hub_branch(int(live[LIVE_BA, bi]), tier, b.rows, b.cfg,
                            b.uncond, pad=b.pad)
        rows = src[b.row0: b.row0 + b.rows]
        dst[b.row0: b.row0 + b.rows] = rows
        live[LIVE_BRANCH, bi] = branch
        live[LIVE_BA_NEXT, bi] = 0
        live[LIVE_TIER_NEXT, bi] = {BRANCH_REBASE: 1,
                                    BRANCH_SHRINK: 2}.get(branch, tier)
        if branch in (BRANCH_COMPACT, BRANCH_REBASE):
            pool[b.slots: b.slots + b.pad] = compact_idx(_active(rows), b.pad,
                                                         b.rows)
        elif branch == BRANCH_SHRINK:
            slots1 = pool[b.slots1: b.slots1 + b.pad]
            real = slots1 < b.rows
            words = rows[torch.where(real, slots1, 0).to(torch.int64)]
            pool[b.sel: b.sel + b.p2] = compact_idx(real & _active(words),
                                                    b.p2, b.pad)


def _prune_views(b, live_tier: int, pool) -> tuple | None:
    """A bucket's prune state as views into the pool (``fresh_prune``'s
    layout)."""
    if b.kind != KIND_PRUNE:
        return None
    ps = (torch.tensor(live_tier, dtype=torch.int32),
          pool[b.slots1: b.slots1 + b.pad],
          pool[b.comb1: b.comb1 + b.pad * b.u].view(b.pad, b.u),
          pool[b.conf1: b.conf1 + b.pad * b.planes].view(b.pad, b.planes))
    if b.p2:
        ps += (pool[b.slots2: b.slots2 + b.p2],
               pool[b.comb2: b.comb2 + b.p2 * b.u].view(b.p2, b.u),
               pool[b.conf2: b.conf2 + b.p2 * b.planes].view(b.p2, b.planes))
    return ps


def hub_superstep_reference(ctrl, state, table, live, plan: HubPlan, pool,
                            k: int, thresh: int, max_steps: int,
                            umax=None) -> None:
    """K8's plain version: ``engine.hub.run_branch`` per bucket on the
    branch and slot lists K7 left; with ``umax``, ``branch_unconf`` into
    each bucket's column first."""
    if not stage_live(ctrl.tolist(), thresh, max_steps):
        return
    cur = int(ctrl[CTRL_CUR])
    src, dst = state[cur], state[1 - cur]
    v = state.shape[1] - 2
    for bi, b in enumerate(plan.buckets):
        branch = int(live[LIVE_BRANCH, bi])
        if branch == BRANCH_SKIP:
            continue
        cb = table[b.cb: b.cb + b.rows * b.width].view(b.rows, b.width)
        ps = _prune_views(b, int(live[LIVE_TIER, bi]), pool)
        idx = None
        if branch in (BRANCH_COMPACT, BRANCH_REBASE):
            idx = pool[b.slots: b.slots + b.pad]
        elif branch == BRANCH_SHRINK:
            idx = pool[b.sel: b.sel + b.p2]
        pk_b = src[b.row0: b.row0 + b.rows]
        if umax is not None:
            umax[bi] = max(int(umax[bi]), branch_unconf(
                branch, src, pk_b, cb, v, ps, b.cfg, idx))
        new_b, fail, act, mc, ps2 = run_branch(
            branch, src, pk_b, cb, b.planes, k, v, ps, b.cfg, idx)
        dst[b.row0: b.row0 + b.rows] = new_b
        ctrl[CTRL_FAIL] += fail
        ctrl[CTRL_ACTIVE] += act
        ctrl[CTRL_MC] = torch.maximum(ctrl[CTRL_MC], mc)
        live[LIVE_BA_NEXT, bi] = act
        if branch == BRANCH_REBASE:
            if int(ps2[0]) == 0:
                live[LIVE_TIER_NEXT, bi] = 0
            ps[2].copy_(ps2[2])
            ps[3].copy_(ps2[3])
        elif branch == BRANCH_SHRINK:
            for dst_t, src_t in zip(ps[4:7], ps2[4:7]):
                dst_t.copy_(src_t)


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_hub_slots.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp, ci, ci,
                                      vp]
        lib.dgc_hub_slots.restype = ci
        lib.dgc_hub_superstep.argtypes = [vp, vp, ci, vp, vp, ci, vp, ci, vp,
                                          vp, ci, ci, ci, ci, vp, vp]
        lib.dgc_hub_superstep.restype = ci
        lib._dgc_bound = True
    return lib


def _check_hub(ctrl, state, live, plan: HubPlan, pool, device) -> None:
    _check_state(ctrl, state, device)
    _check_int32("live", live, device, 2)
    _check_int32("pool", pool, device, 1)
    nh = len(plan.buckets)
    if live.shape[0] != LIVE_ROWS or live.shape[1] < nh:
        raise ValueError(f"live must be [{LIVE_ROWS}, nb >= {nh}]")
    if pool.shape[0] < plan.pool_size:
        raise ValueError(f"pool holds {pool.shape[0]} words, the plan "
                         f"{plan.pool_size}")
    if plan.desc.device != device or plan.desc.dtype != torch.int64:
        raise ValueError("the plan's descriptors must be int64 on the card")
    last = plan.buckets[-1] if plan.buckets else None
    if last is not None and last.row0 + last.rows > state.shape[1] - 2:
        raise ValueError("the hub buckets reach past the state")


def hub_slots(ctrl, state, live, plan: HubPlan, pool, thresh: int,
              max_steps: int) -> None:
    """K7 over every bucket of ``plan``. Runs on the current stream."""
    device = state.device
    if device.type == "cpu":
        return hub_slots_reference(ctrl, state, live, plan, pool, thresh,
                                   max_steps)
    _check_cuda("hub_slots", device)
    _check_hub(ctrl, state, live, plan, pool, device)
    if not plan.buckets:
        return
    _raise_on(_library().dgc_hub_slots(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]),
        plan.desc.data_ptr(), len(plan.buckets), live.data_ptr(),
        int(live.shape[1]), pool.data_ptr(), int(thresh),
        int(min(max_steps, INT32_MAX)), _stream(device)), "hub_slots")
    launch_counts["hub_slots"] += 1


def hub_superstep(ctrl, state, table, live, plan: HubPlan, pool, k: int,
                  thresh: int, max_steps: int, umax=None) -> None:
    """K8 over every bucket of ``plan``, tables in ``table`` (int32, at
    each bucket's offset); its recording variant into ``umax`` (int32[nb
    >= the plan's buckets]) when given. Runs on the current stream."""
    device = state.device
    if device.type == "cpu":
        return hub_superstep_reference(
            ctrl, state, table, live, plan, pool, k, thresh, max_steps,
            umax=umax)
    _check_cuda("hub_superstep", device)
    _check_hub(ctrl, state, live, plan, pool, device)
    _check_int32("table", table, device, 1)
    if plan.lens is None:
        raise ValueError("K8 on the card needs the rows' real lengths: make "
                         "the plan with hub_plan(..., table=, v=)")
    _check_int32("lens", plan.lens, device, 1)
    if plan.lens.shape[0] < sum(b.rows for b in plan.buckets):
        raise ValueError("the plan's lens hold fewer rows than its buckets")
    if umax is not None:
        _check_int32("umax", umax, device, 1)
        if umax.shape[0] < len(plan.buckets):
            raise ValueError(f"umax holds {umax.shape[0]} columns, the plan "
                             f"{len(plan.buckets)} buckets")
    if not plan.buckets:
        return
    last = plan.buckets[-1]
    if table.shape[0] < last.cb + last.rows * last.width:
        raise ValueError("the hub table is shorter than the plan's buckets")
    name, counts = (("hub_superstep", launch_counts) if umax is None
                    else ("hub_superstep_rec", rec_launch_counts))
    _raise_on(_library().dgc_hub_superstep(
        ctrl.data_ptr(), state.data_ptr(), int(state.shape[1]),
        table.data_ptr(), plan.desc.data_ptr(), len(plan.buckets),
        live.data_ptr(), int(live.shape[1]), pool.data_ptr(),
        plan.lens.data_ptr(), int(plan.blocks), _clamp_k(k), int(thresh),
        int(min(max_steps, INT32_MAX)),
        None if umax is None else umax.data_ptr(), _stream(device)), name)
    counts[name] += 1
