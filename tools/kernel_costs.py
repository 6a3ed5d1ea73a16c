"""Where K1 (`superstep_rows`), K3 (`compact_slots`), K5
(`segmented_superstep`), K8 (`hub_superstep`), K11 (`dense_forbid`), K12
(`dense_resolve`), K13 (`lane_superstep`), K14 (`lane_compact`), K15
(`lane_finish`), K20 (`shard_superstep`), K23 (`ring_stats`), K24
(`ring_stats_wide`), K25 (`ring_apply`) and the lane mesh's fold (K26)
spend their time on the card:
device time from ``torch.profiler`` over a few shapes each, one JSON line
a measurement, then the card's name and power limit.

    python tools/kernel_costs.py

K3: the launch at 2,048 items (one block: the fixed chain of dependent
reads and the count exchange), 200k and 1M items with a one-slot list,
and 1M items with the first stage's 262,144-slot list (the dummy fill);
beside them PyTorch's own copy of the 1M words and fill of the 262,144
slots. K11 (16,384 vertices, k = 2,414 as on the RMAT cell): m uncolored
rows of degree 0 or 256 at rows 0, G, 2G, ... (G the grid: K11's ranking
deals them to m blocks, so this reads a launch's fixed cost), or m rows
for every block (2,112 rows at m = 16 on 132 SMs: the rate at scale).
K24 and K25 (``ring``): the 1M RMAT draw's ``sharded-ring`` engine at
world size 1, on the carry of three supersteps of its first attempt;
K24 over the rotation's wide tables at chunks of 256 to 4,096 entries
(each launch first held against its plain version; ``chip_smoke.py``
times it bucket by bucket at the default chunk); K25 from the
accumulators the stats leave, with the rows' touched planes counted.

K5 (``k5``): the 1M uniform draw's ``ell-compact`` engine: one sweep held
launch by launch against the plain versions, one profiled (its launches
split into the full table and the compaction stages), and the full-table
superstep alone (its recording variant too), first held against the plain
version; then the 1M RMAT sweep's K5 launches summed. K8 (``k8``): the 1M
RMAT draw's ``ell-compact`` engine: one sweep held launch by launch
against the plain versions, one profiled (K8's mean, sum and spread a
launch, K5's sum). ``chip_smoke.py`` times K8 on each hub bucket alone.

K1 (``k1``): the 1M uniform draw's ``ell`` and ``ell-bucketed`` engines
at a fresh attempt's first superstep (every part), then the 1M RMAT
draw's ``ell-bucketed`` sweep: the CLI's sweep once, then its attempts
replayed under the profiler, K1's launches summed, and the replay's wall
time. K23 (``k23``): both 1M draws' ``sharded-ring`` engines at world size
1, one ``sweep`` call under the profiler (K23's launches summed) and one
without (its wall time). Both parts drive the engines through their own
calls only, so they time another checkout's package as well.

K13 (``lane_superstep``), K14 (``lane_compact``) and K15 (``lane_finish``;
``k13``, ``k14``, ``k15``, measured together once): the serve replay's
default run (``serve_main`` on ``chip_smoke.SERVE_STREAM``, continuous,
batch 8) once for its launches and wall time and once under the profiler
(each kernel's launches summed, its mean a launch); the same graphs drawn
once through a ``ServeFrontEnd`` (continuous, batch 8: graphs/s); then
``measure_serve``'s sweep of the 32 uniform 20k requests in one 32-lane
batch (v32768w32) and of the 8 100k requests (v131072w32), each under the
profiler with its launches split by the executed rung (the full table,
rung 0, and each staged rung), and each kernel in rounds past the live
word; with ``k15``, K15's timing, spec and partial instances. Where the
package has K13's launch plan (``kernels.serve.superstep_plan``), each
sweep's K13 launches are also split by path: every block gathering from
the lane's state staged in shared memory, every block from device
memory, or both. With ``k14``, one rebuild of K14 (every lane at a
staged rung's entry, 40 % of its rows active) at each of
``K14_REBUILDS``, first held against its plain version, beside
``torch.nonzero`` on the same rows. K20 (``k20``): the 1M uniform draw's
``sharded`` engine at world size 1: one ``sweep`` held launch by launch
against the plain versions, one timed by its wall, one under the
profiler (K20's launches summed), and a fresh attempt's first superstep
alone. K12 (``k12``): the dense backend at its cap, 16,384 vertices, on the
uniform and the RMAT draw (``chip_smoke.DENSE_ARGS``), through the CLI's
calls: one sweep held call by call against the plain versions, the
sweep's wall five times (the dense run's figure), one sweep under the
profiler (K11's and K12's launches summed), and the k0 attempt's
supersteps one by one (``chip_smoke.measure_dense``: K12 a superstep,
summed over the attempt, its bound). K26 (``k26``): the lane mesh over 4
slots of 2 lanes on one card, the first 8 uniform 20k requests
(v32768w32, the auto ladder), swept in continuous mode's priced slices
through ``serve.batched.run_mesh_slice``: the launches a round (the
standalone K26 launches apart) and the serve kernels' device time under
the profiler, summed and a round's mean; then the last shard's partial
K15 replayed from a kept state, alone and, where the package folds in
the tail, folding (``chip_smoke._fold_cost``). ``rate``: the drawn-once
run alone, three times after
a warm run, then once more with the host threads' stacks sampled every
millisecond (the share of samples by innermost frame, and by innermost
frame of the port's package).

    python tools/kernel_costs.py [k3] [k11] [k12] [ring] [k5] [k8] [k1] \
        [k23] [k13] [k14] [k15] [k20] [k26] [rate]
    python tools/kernel_costs.py --tree DIR k1 k23   # all parts if none

``--tree DIR`` times another checkout's package (an unpacked ``git
archive``, e.g. the parent commit's) with these parts. Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the timing helpers)

K3_CASES = {"2048 items, pad 1": (2048, 0.3, 1),
            "200k items, pad 1": (200_000, 0.004, 1),
            "1M items, pad 1": (1_000_000, 0.004, 1),
            "1M items, pad 262144": (1_000_000, 0.004, 262_144)}
K11_VP = 16384
K11_K = 2414
K11_ROWS = (1, 4, 16)
K11_DEGREES = (0, 256)
RING_CHUNKS = (256, 512, 1024, 2048, 4096)


def k3_costs() -> None:
    from dgc_tpu_torch.kernels import compact as kc

    rng = np.random.default_rng(7)
    scratch = kc.new_slots_scratch("cuda")
    for name, (v, density, pad) in K3_CASES.items():
        state = cs._compact_state(rng, v, 200, density, "cuda")
        ctrl = kc.new_ctrl(3, v, "cuda")
        ms = cs._device_ms(lambda: kc.compact_slots(ctrl, state, 0, pad,
                                                    scratch),
                           20, "compact_slots_kernel")
        print(json.dumps({"kernel": "compact_slots", "case": name,
                          "ms": ms}), flush=True)
    v = 1_000_000
    state = cs._compact_state(rng, v, 200, 0.004, "cuda")
    idx = torch.empty(262_144, dtype=torch.int32, device="cuda")
    print(json.dumps({
        "kernel": "torch", "case": "copy_ of 1M words over the other buffer",
        "ms": cs._device_ms(lambda: state[1, :v].copy_(state[0, :v]), 20)}))
    print(json.dumps({"kernel": "torch", "case": "fill_ of 262,144 slots",
                      "ms": cs._device_ms(lambda: idx.fill_(v), 20)}))


def k11_costs() -> None:
    from dgc_tpu_torch.kernels import dense as kd

    rng = np.random.default_rng(0)
    vp = K11_VP
    adj = torch.zeros((vp, vp), dtype=torch.bfloat16, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = sms  # one block an SM at Vp = 16,384 (the launcher's)
    for deg in K11_DEGREES:
        for m in K11_ROWS:
            for where in ("m rows", "m rows a block"):
                rows = [b + j * grid for j in range(m)
                        for b in (range(grid) if where == "m rows a block"
                                  else (0,)) if b + j * grid < vp]
                adj.zero_()
                colors = torch.from_numpy(
                    rng.integers(0, 40, vp).astype(np.int32)).cuda()
                r = torch.tensor(rows, device="cuda")
                colors[r] = -1
                if deg:
                    cols = torch.from_numpy(
                        rng.integers(0, vp, (len(rows), deg))).cuda()
                    adj[r[:, None].expand(-1, deg), cols] = 1
                state = torch.stack([colors, colors]).contiguous()
                ctrl = kd.new_dense_ctrl("cuda")
                cand = torch.empty(vp, dtype=torch.int32, device="cuda")

                def launch():
                    ctrl.zero_()
                    kd.dense_forbid(ctrl, state, adj, cand, vp, K11_K)

                print(json.dumps({
                    "kernel": "dense_forbid", "m": m, "case": where,
                    "degree": deg, "rows": len(rows),
                    "ms": cs._device_ms(launch, 20, "dense_forbid_kernel")}),
                    flush=True)


DENSE_WALLS = 5  # timed runs of each dense sweep


def k12_costs() -> None:
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import dense as kd

    for gen, argv in cs.DENSE_ARGS.items():
        args = cli.build_parser().parse_args(
            argv + ["--output-coloring", "unused.json"])
        graph = cli.load_graph(args)
        engine = cli.make_engine(args, graph)
        with cs._HeldDenseKernels() as held:
            ref = cli.sweep(args, graph, engine)
        torch.cuda.synchronize()
        cs.check(held.err == 0, f"K11/K12 differ from their plain versions "
                                f"by {held.err}")
        walls = []
        for _ in range(DENSE_WALLS):
            res = cli.sweep(args, graph, engine)
            cs.check(np.array_equal(res.colors, ref.colors),
                     f"dense on {gen}: the colors moved")
            walls.append((res.wall_time_s - res.post_reduce_s) * 1e3)
        kd.reset_launch_counts()
        cli.sweep(args, graph, engine)
        launches = dict(kd.launch_counts)
        prof = cs._profiled(lambda: cli.sweep(args, graph, engine), launches,
                            names={k: f"{k}_kernel" for k in launches})
        meas = cs.measure_dense(engine, graph.initial_k())
        print(json.dumps({
            "kernel": "dense_resolve", "graph": f"16,384 {gen}",
            "held_calls": held.calls, "sweep_ms": walls,
            "sweep_launches": launches,
            "sweep_k12_ms": prof["dense_resolve"][0],
            "sweep_k11_ms": prof["dense_forbid"][0],
            **{k: meas[k] for k in (
                "dense_supersteps", "uncolored_per_step",
                "k12_kept_per_step", "k12_ms", "k12_ms_by_step",
                "k12_attempt_ms", "k12_bound_ms", "k12_full_rows_bound_ms",
                "k11_ms", "k11_bound_ms") if k in meas}}), flush=True)
        del engine


def k26_costs() -> None:
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_PHASE
    from dgc_tpu_torch.serve.batched import auto_slice_steps, run_mesh_slice
    from dgc_tpu_torch.serve.cli import _load_request_graph

    graphs = [_load_request_graph(d) for d in cs.SERVE_STREAM
              if str(d["id"]).startswith("u")][:8]
    cls, stages, inputs = cs._serve_inputs(graphs, "cuda")
    staged = stages is not None
    steps = auto_slice_steps(cls.entries(), len(graphs), "gpu")
    n = 4

    def make():
        return cs._mesh_lanes(inputs, cls, stages, [torch.device("cuda")] * n)

    def sweep(M):  # continuous mode's slices, resumed until no lane runs
        while True:
            run_mesh_slice(M, slice_steps=steps, staged=staged)
            if not any(bool((L.carry[CARRY_PHASE] < 2).any())
                       for L in M.shards):
                return
            for L in M.shards:
                L.reset.zero_()

    sweep(make())  # warm
    ks.reset_launch_counts()
    M = make()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sweep(M)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    launches = dict(ks.launch_counts)
    fold = "mesh" in inspect.signature(ks.lane_finish).parameters
    folds = ks.mesh_folds() if fold else None
    rounds = launches["lane_superstep"] // n
    names = {k: cs._SERVE_NAMES[k] for k in cs._SERVE_KERNELS}
    names["lane_mesh_fold"] = "lane_mesh_fold_kernel"
    prof = cs._profiled(sweep, {k: launches[k] for k in (
        "lane_superstep", "lane_finish")}, cs._DEVICE_MS_KEPT, names,
        prepare=make)
    device = {k: v[0] for k, v in prof.items()}
    k15 = prof["lane_finish"][2]
    by_shard = ([sum(k15[i::n]) / len(k15[i::n]) for i in range(n)]
                if len(k15) == launches["lane_finish"] else None)
    print(json.dumps({
        "kernel": "lane_mesh_fold", "run": f"{n} slots of 2 lanes of "
        f"{cls.name}, slices of {steps}", "rounds": rounds,
        "launches": launches,
        "k26_launches": launches.get("lane_mesh_fold", 0),
        "launches_per_round": sum(launches[k] for k in (
            "lane_superstep", "lane_compact", "lane_finish",
            "lane_mesh_fold") if k in launches) / rounds,
        "folds": folds,
        "sweep_wall_ms": wall, "device_ms": device,
        "round_device_ms": sum(device.values()) / rounds,
        "k15_mean_ms_by_shard": by_shard,
        "last_k15": cs._fold_cost({"inputs": inputs, "slots": n}, cls,
                                  stages, "cuda", 20, fold)}), flush=True)


def ring_costs() -> None:
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.engine.fused import shard_superstep_epilogue
    from dgc_tpu_torch.kernels import ring as kr

    args = cli.build_parser().parse_args(
        cs.RMAT_ARGS + ["--backend", "sharded-ring",
                        "--output-coloring", "unused.json"])
    graph = cli.load_graph(args)
    engine = cli.make_engine(args, graph)
    k = engine._budget(graph.initial_k())
    planes, vl = engine.num_planes, engine.packed_l.shape[0]
    dev = engine.packed_l.device
    ctrl = engine._start(k)
    for _ in range(3):
        engine._superstep(ctrl, k)
        shard_superstep_epilogue(engine, ctrl, None)
    block = engine.blocks[0]
    block[:vl].copy_(engine.packed_l)
    buckets = [(None if rows is None else rows.cpu().numpy(),
                table.cpu().numpy()) for rows, table in
               engine.wide[0].buckets]
    real = [int(((t & ((1 << 30) - 1)) != vl).sum()) for _, t in buckets]
    acc = kr.new_acc(planes, vl, dev)
    plain = kr.new_acc(planes, vl, dev)
    for chunk in RING_CHUNKS:
        wide = kr.WideTables(buckets, vl, dev, chunk)
        acc.zero_()
        plain.zero_()
        kr.ring_stats_wide(ctrl, block, engine.packed_l, wide, acc, planes)
        kr.ring_stats_wide_reference(ctrl, block, engine.packed_l, wide,
                                     plain, planes)
        cs.check(torch.equal(acc, plain), f"K24 at chunk {chunk} differs "
                                          f"from its plain version")
        ms = cs._device_ms(lambda: kr.ring_stats_wide(
            ctrl, block, engine.packed_l, wide, acc, planes), 20,
            "ring_stats_wide_kernel")
        print(json.dumps({"kernel": "ring_stats_wide", "chunk": chunk,
                          "items": wide.work.shape[0],
                          "real_entries": sum(real), "ms": ms}), flush=True)
    # K25 from what the superstep's stats leave
    acc.zero_()
    kr.ring_stats(ctrl, block, engine.packed_l, engine.rot[0], acc, planes)
    kr.ring_stats_wide(ctrl, block, engine.packed_l, engine.wide[0], acc,
                       planes)
    left = acc.clone()
    mask = left[2 * planes + 1].long() & 0xFFFFFFFF
    pop = sum(int(((mask >> b) & 1).sum()) for b in range(32))
    ctrl1 = ctrl.clone()

    def k25():
        ctrl1.copy_(ctrl)
        acc.copy_(left)
        kr.ring_apply(ctrl1, engine.packed_l, acc, engine.back, planes, k,
                      True)

    print(json.dumps({"kernel": "ring_apply", "planes": planes,
                      "rows": vl, "touched_planes": pop,
                      "rows_touched": int((mask != 0).sum()),
                      "ms": cs._device_ms(k25, 20, "ring_apply_kernel")}),
          flush=True)


def _compact_engine(argv: list[str]):
    """(engine, k0) of the CLI's default backend on the draw ``argv``."""
    from dgc_tpu_torch import cli

    args = cli.build_parser().parse_args(
        argv + ["--output-coloring", "unused.json"])
    graph = cli.load_graph(args)
    return cli.make_engine(args, graph), graph.initial_k()


def _sweep_profile(engine, k: int) -> dict:
    """One ``sweep(k)`` under the profiler: K5's launches split by kind
    (full table or stage, in call order), K8's mean, sum and spread."""
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh

    kinds = []
    real = kc.segmented_superstep

    def k5(*a, gidx=None, **kw):
        kinds.append("full" if gidx is None else "stage")
        return real(*a, gidx=gidx, **kw)

    kc.reset_launch_counts()
    kh.reset_launch_counts()
    engine.sweep(k)
    launches = {"segmented_superstep": kc.launch_counts["segmented_superstep"]}
    if engine.hub_buckets:
        launches["hub_superstep"] = kh.launch_counts["hub_superstep"]

    def sweep():
        kinds.clear()
        engine.sweep(k)

    kc.segmented_superstep = k5
    try:
        prof = cs._profiled(sweep, launches, names={
            "segmented_superstep": "segmented_superstep_kernel",
            "hub_superstep": "hub_superstep_kernel"})
    finally:
        kc.segmented_superstep = real
    out = {"k5": cs._k5_split(prof["segmented_superstep"][2], kinds),
           "k5_sum_ms": prof["segmented_superstep"][0],
           "k5_launches": prof["segmented_superstep"][1]}
    if engine.hub_buckets:
        t, n, each = prof["hub_superstep"]
        each = sorted(each)
        out.update(k8_sum_ms=t, k8_launches=n, k8_mean_ms=t / n,
                   k8_median_ms=each[n // 2], k8_max_ms=each[-1])
    return out


def _held_sweep(engine, k: int) -> int:
    """One ``sweep(k)`` with every K3-K8 launch held against its plain
    version; the max abs difference."""
    with cs._HeldCompactKernels() as held:
        engine.sweep(k)
    return held.err


def k5_costs() -> None:
    from dgc_tpu_torch.kernels import compact as kc

    engine, k = _compact_engine(cs.MAIN_ARGS)
    plan, desc, seg = engine._full_plan
    thresh = engine.stages[0][1]
    umax = torch.zeros(1, dtype=torch.int32, device="cuda")
    state, ctrl, _ = engine._fresh()
    s_p, c_p = state.clone(), ctrl.clone()
    kc.segmented_superstep(ctrl, state, seg, plan, desc, k, thresh,
                           engine.max_steps)
    kc.segmented_superstep_reference(c_p, s_p, seg, plan, k, thresh,
                                     engine.max_steps)
    cs.check(torch.equal(state, s_p) and torch.equal(ctrl, c_p),
             "K5 on the full table differs from its plain version")
    state, ctrl, _ = engine._fresh()

    def full(rec=False):
        kc.segmented_superstep(ctrl, state, seg, plan, desc, k, thresh,
                               engine.max_steps, umax=umax if rec else None)

    print(json.dumps({
        "kernel": "segmented_superstep", "graph": "1M uniform",
        "held_sweep_err": _held_sweep(engine, k),
        "full_table_ms": cs._device_ms(full, 20,
                                       "segmented_superstep_kernel"),
        "full_table_rec_ms": cs._device_ms(lambda: full(True), 20,
                                           "segmented_superstep_kernel"),
        **_sweep_profile(engine, k)}), flush=True)
    del engine
    engine, k = _compact_engine(cs.RMAT_ARGS)
    print(json.dumps({"kernel": "segmented_superstep", "graph": "1M RMAT",
                      **_sweep_profile(engine, k)}), flush=True)


def k8_costs() -> None:
    engine, k = _compact_engine(cs.RMAT_ARGS)
    err = _held_sweep(engine, k)
    cs.check(err == 0, f"K8 differs from its plain version by {err}")
    print(json.dumps({
        "kernel": "hub_superstep", "graph": "1M RMAT",
        "held_sweep_err": err, **_sweep_profile(engine, k)}), flush=True)


def _k1_first_superstep(engine, k: int) -> float:
    """K1's device time over every part of a fresh attempt's first
    superstep (repeated launches redo the same step), on either
    checkout's engine (a table's plan passed where the engine has one)."""
    from dgc_tpu_torch.engine.base import clamp_budget
    from dgc_tpu_torch.engine.bucketed import fail_valid
    from dgc_tpu_torch.kernels import superstep as ks

    if hasattr(engine, "combined_buckets"):
        tables = [(r0, cb, p, fail_valid(cb.shape[1], p, k)) for r0, cb, p
                  in zip(engine.row0, engine.combined_buckets, engine.planes)]
        plans = getattr(engine, "plans", [None] * len(tables))
        packed0 = torch.where(engine.degrees == 0, 0, 1).to(torch.int32)
        step0, k_run = 1, k
    else:
        tables = [(0, engine.table, engine.num_planes, True)]
        plans = [getattr(engine, "plan", None)]
        packed0 = torch.where(engine.degrees == 0, 0, -1).to(torch.int32)
        step0, k_run = 0, clamp_budget(k, 32 * engine.num_planes)
    v = packed0.shape[0]
    ctrl = ks.new_ctrl(step0, v + 1, packed0.device)
    state = ks.new_state(packed0)

    def k1():
        for (row0, table, planes, fv), plan in zip(tables, plans):
            ks.superstep_rows(ctrl, state, table, row0, planes, k_run, fv,
                              *(() if plan is None else (plan,)))

    return cs._device_ms(k1, 20, "superstep_rows", per_call=len(tables))


def k1_costs() -> None:
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import superstep as ks

    for argv, backends in ((cs.MAIN_ARGS, ("ell", "ell-bucketed")),
                           (cs.RMAT_ARGS, ("ell-bucketed",))):
        for backend in backends:
            args = cli.build_parser().parse_args(
                argv + ["--backend", backend,
                        "--output-coloring", "unused.json"])
            graph = cli.load_graph(args)
            engine = cli.make_engine(args, graph)
            k = graph.initial_k()
            out = {"kernel": "superstep_rows", "backend": backend,
                   "graph": args.gen_method,
                   "first_superstep_ms": _k1_first_superstep(engine, k)}
            if args.gen_method == "rmat":
                result = cli.sweep(args, graph, engine)
                ks_swept = [a.k for a in result.attempts]

                def replay():
                    for k_ in ks_swept:
                        engine.attempt(k_)

                torch.cuda.synchronize()
                t = time.perf_counter()
                replay()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
                ks.reset_launch_counts()
                replay()
                n = ks.launch_counts["superstep_rows"]
                total, kept, _ = cs._profiled(
                    replay, {"superstep_rows": n},
                    names={"superstep_rows": "superstep_rows"})[
                        "superstep_rows"]
                out.update(attempts=len(ks_swept),
                           supersteps=result.total_supersteps,
                           replay_wall_ms=wall, sweep_k1_ms=total,
                           sweep_k1_launches=kept)
            print(json.dumps(out), flush=True)
            del engine


def k23_costs() -> None:
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import ring as kr

    for argv in (cs.MAIN_ARGS, cs.RMAT_ARGS):
        args = cli.build_parser().parse_args(
            argv + ["--backend", "sharded-ring",
                    "--output-coloring", "unused.json"])
        graph = cli.load_graph(args)
        engine = cli.make_engine(args, graph)
        k = engine._budget(graph.initial_k())
        engine.sweep(k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.sweep(k)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        kr.reset_launch_counts()
        engine.sweep(k)
        n = kr.launch_counts["ring_stats"]
        total, kept, _ = cs._profiled(
            lambda: engine.sweep(k), {"ring_stats": n},
            names={"ring_stats": "ring_stats_kernel"})["ring_stats"]
        print(json.dumps({"kernel": "ring_stats", "graph": args.gen_method,
                          "sweep_wall_ms": wall, "sweep_k23_ms": total,
                          "sweep_k23_launches": kept}), flush=True)
        del engine


def k20_costs() -> None:
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import shard as ks

    args = cli.build_parser().parse_args(
        cs.MAIN_ARGS + ["--backend", "sharded",
                        "--output-coloring", "unused.json"])
    graph = cli.load_graph(args)
    engine = cli.make_engine(args, graph)
    k = engine._budget(graph.initial_k())
    with cs._HeldShardKernels() as held:
        engine.sweep(k)
        torch.cuda.synchronize()
    cs.check(held.err == 0, f"K20-K22 differ from their plain versions by "
                            f"{held.err}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.sweep(k)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    ks.reset_launch_counts()
    engine.sweep(k)
    n = ks.launch_counts["shard_superstep"]
    total, kept, each = cs._profiled(
        lambda: engine.sweep(k), {"shard_superstep": n},
        names={"shard_superstep": "shard_superstep_kernel"})[
            "shard_superstep"]
    # a fresh attempt's first superstep, through the engine's own call
    ctrl0 = engine._start(k)
    v = engine.state.shape[1] - 2
    engine.mesh.all_gather(engine.state[0, :v], engine.packed_l)
    ctrl = ctrl0.clone()

    def first():
        ctrl.copy_(ctrl0)
        engine._superstep(ctrl, k)

    print(json.dumps({
        "kernel": "shard_superstep", "graph": "1M uniform",
        "held_sweep_calls": held.calls, "sweep_wall_ms": wall,
        "sweep_k20_ms": total, "sweep_k20_launches": kept,
        "mean_ms": total / kept, "min_ms": min(each), "max_ms": max(each),
        "first_superstep_ms": cs._device_ms(first, 20,
                                            "shard_superstep_kernel")}),
        flush=True)
    del engine


# K14's rebuilds timed alone: (name, lanes, rows) of the class v{rows}w32
K14_REBUILDS = (("32 lanes of v32768w32", 32, 32768),
                ("one lane of v32768w32", 1, 32768),
                ("one lane of v131072w32", 1, 131072),
                ("one lane of v524288w32", 1, 524288))
K14_ACTIVE = 0.4  # a rebuilt lane's share of active rows (rung 1's pad: V/2)


def _k14_lanes(rng, b: int, v: int):
    """``b`` lanes of the class v{v}w32 at the entry of its ladder's rung
    1: every lane live, its slot list built at rung 0, ``K14_ACTIVE`` of
    its rows active; the control block routing rung 1."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_LEN, CARRY_P1,
                                      CARRY_P2, CARRY_PACKED)
    from dgc_tpu_torch.serve.batched import resolve_stages
    from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER,
                                                   stage_schedule_for)

    cls = DEFAULT_LADDER.class_for(v // 2 + 1, 32)
    cs.check(cls.v_pad == v, f"class {cls.name} for {v} rows")
    stages, _pads, a0 = resolve_stages(stage_schedule_for(cls, "auto"), v)
    carry = [torch.zeros((b, a0) if j == CARRY_IDX else
                         (b, v) if j in (CARRY_PACKED, CARRY_P1, CARRY_P2)
                         else (b,), dtype=torch.int32, device="cuda")
             for j in range(CARRY_LEN)]
    carry[CARRY_PACKED].copy_(torch.from_numpy(np.stack(
        [cs._packed_words(rng, v, 33, K14_ACTIVE) for _ in range(b)])))
    carry[CARRY_IDX].fill_(v)
    ctrl = ks.ladder_ctrl(stages, "cuda")
    ctrl[ks.CTRL_LIVE] = 1
    ctrl[ks.CTRL_REXEC] = 1
    lanes = torch.zeros(b, dtype=torch.int32, device="cuda")
    return ks.new_lanes(carry, torch.full((b, v, 32), v, dtype=torch.int32,
                                          device="cuda"),
                        torch.zeros((b, v), dtype=torch.int32,
                                    device="cuda"), lanes, lanes, lanes,
                        ctrl, planes=cls.planes, stall_window=64, budget=1)


def k14_rebuilds() -> None:
    """One K14 rebuild at each of ``K14_REBUILDS``: held once against its
    plain version (the slot lists and ``idx_rung``), then timed with every
    lane's ``idx_rung`` cleared before each launch; its bound (each lane's
    words read, its slot list written) and ``torch.nonzero`` on the same
    active rows."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_IDX, CARRY_IDX_RUNG, CARRY_PACKED

    rng = np.random.default_rng(14)
    for name, b, v in K14_REBUILDS:
        L = _k14_lanes(rng, b, v)
        plain = _k14_lanes(np.random.default_rng(0), b, v)
        for j in (CARRY_PACKED, CARRY_IDX, CARRY_IDX_RUNG):
            plain.carry[j].copy_(L.carry[j])
        ks.lane_compact(L)
        ks.lane_compact_reference(plain)
        err = max(cs._diff(L.carry[j], plain.carry[j])
                  for j in (CARRY_IDX, CARRY_IDX_RUNG))
        cs.check(err == 0, f"K14 ({name}) differs from its plain version "
                           f"by {err}")

        def rebuild():
            L.carry[CARRY_IDX_RUNG].zero_()
            ks.lane_compact(L)

        pk = L.carry[CARRY_PACKED]
        ms = cs._device_ms(rebuild, 20, "lane_compact_kernel")
        lib = cs._device_ms(
            lambda: torch.nonzero((pk < 0) | ((pk & 1) == 1)), 20)
        moved = (b * v + b * L.a0) * 4
        print(json.dumps({"kernel": "lane_compact", "case": name,
                          "a0": L.a0, "max_abs_err": err, "ms": ms,
                          "bytes": moved,
                          "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3,
                          "library_nonzero_ms": lib}), flush=True)
        del L, plain


def _k14_kind(L) -> str:
    """What a K14 launch on ``L`` finds (a host read of the control block
    and the lanes' phases and rungs)."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_IDX_RUNG, CARRY_PHASE

    ctrl = L.ctrl.tolist()
    s = ctrl[ks.CTRL_REXEC]
    if not ctrl[ks.CTRL_LIVE]:
        return "past the live word"
    if ctrl[ks.CTRL_PAD0 + s] == 0:
        return "full table"
    need = (L.carry[CARRY_PHASE] < 2) & (L.carry[CARRY_IDX_RUNG] < s)
    return "rebuild" if bool(need.any()) else "live, none to rebuild"


_SERVE_PARTS = {"k13": "lane_superstep", "k14": "lane_compact",
                "k15": "lane_finish"}


def _replay(out_dir: Path, i: int) -> tuple:
    """``serve_main`` on ``chip_smoke.SERVE_STREAM``, continuous, batch 8:
    (rc, wall seconds)."""
    from dgc_tpu_torch.serve.cli import serve_main

    d = out_dir / f"replay{i}"
    d.mkdir()
    req = d / "requests.jsonl"
    req.write_text("".join(json.dumps(x) + "\n" for x in cs.SERVE_STREAM))
    t = time.perf_counter()
    rc = serve_main(["--requests", str(req), "--results",
                     str(d / "results.jsonl"), "--output-colorings",
                     str(d / "colorings"), "--device", "cuda",
                     "--batch-max", "8"])
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t


def _drawn_once(graphs: dict) -> float:
    """The stream's graphs, drawn once, through a ``ServeFrontEnd``
    (continuous, batch 8, as ``chip_smoke._serve_front_runs``): graphs/s."""
    from dgc_tpu_torch.serve.queue import ServeFrontEnd

    front = ServeFrontEnd(batch_max=8, workers=8, mode="continuous",
                          queue_depth=max(64, 2 * len(graphs)),
                          device="cuda").start()
    t = time.perf_counter()
    tickets = [front.submit(g.arrays, request_id=rid)
               for rid, g in graphs.items()]
    for x in tickets:
        cs.check(x.result(timeout=900).ok, "a drawn-once request failed")
    wall = time.perf_counter() - t
    front.shutdown()
    return len(graphs) / wall


def _rung_sweep(inputs, cls, stages, names: dict) -> dict:
    """One sweep of ``inputs`` in one batch (``chip_smoke._serve_sweep``)
    under the profiler, K13's launches split by the executed rung (read
    from the control block before each)."""
    from dgc_tpu_torch.kernels import serve as ks

    staged = stages is not None
    plan = getattr(ks, "superstep_plan", None)
    rungs, paths = [], []

    def sweep(L):
        rungs.clear()
        paths.clear()
        ks.lane_reset(L)
        while int(L.ctrl[ks.CTRL_LIVE]):
            rungs.append(int(L.ctrl[ks.CTRL_REXEC]))
            if staged:
                ks.lane_compact(L)
            if plan is not None:
                p = plan(L)
                paths.append("shared" if p["global"] == 0 else
                             "global" if p["shared"] == 0 else "both")
            ks.lane_superstep(L)
            ks.lane_finish(L)

    def make():
        return cs._serve_lanes_of(inputs, cls, stages, "cuda", ks.INT32_MAX)

    sweep(make())
    torch.cuda.synchronize()
    n = len(rungs)
    want = {name: n for name in names.values()
            if name != "lane_compact" or staged}
    prof = cs._profiled(sweep, want, cs._DEVICE_MS_KEPT,
                        {k: cs._SERVE_NAMES[k] for k in want}, prepare=make)
    out = {"rounds": n}
    for name in want:
        t, kept, _each = prof[name]
        out[name] = {"launches": n, "profiled": kept, "mean_ms": t / kept,
                     "sum_ms": t / kept * n}
    # the split needs every launch's record, in order
    if "lane_superstep" in want and prof["lane_superstep"][1] == n:
        by = {}
        for r, ms in zip(rungs, prof["lane_superstep"][2]):
            by.setdefault(r, []).append(ms)
        out["lane_superstep"]["by_rung"] = {
            str(r): {"launches": len(x), "mean_ms": sum(x) / len(x),
                     "sum_ms": sum(x)} for r, x in sorted(by.items())}
        if paths:  # by the path its plan gave: all blocks staged or not
            by = {}
            for path, ms in zip(paths, prof["lane_superstep"][2]):
                by.setdefault(path, []).append(ms)
            out["lane_superstep"]["by_path"] = {
                k: {"launches": len(x), "mean_ms": sum(x) / len(x),
                    "sum_ms": sum(x)} for k, x in sorted(by.items())}
    return out


def _noop_ms(inputs, cls, stages) -> dict:
    """K14, K13 and K15 launched in turn, as a slice launches them, on
    lanes whose sweep is over (the live word 0: each returns at once, as
    in the rounds a slice enqueues past its last live superstep): each
    kernel's device time a launch."""
    from dgc_tpu_torch.kernels import serve as ks

    L = cs._serve_lanes_of(inputs, cls, stages, "cuda", ks.INT32_MAX)
    cs._serve_sweep(L, stages is not None, False)
    n = 100

    def rounds():
        for _ in range(n):
            ks.lane_compact(L)
            ks.lane_superstep(L)
            ks.lane_finish(L)

    rounds()
    prof = cs._profiled(rounds, {k: n for k in _SERVE_PARTS.values()},
                        cs._DEVICE_MS_KEPT,
                        {k: cs._SERVE_NAMES[k] for k in _SERVE_PARTS.values()})
    return {k: t / kept for k, (t, kept, _each) in prof.items()}


def _k15_instances(cls, stages, inputs) -> dict:
    """K15's kTiming instance (a timing sweep of ``inputs``), K15 on armed
    lanes (every other lane spec-tagged) and its partial instance (the
    first 8 lanes over a mesh of 4 slots on the card, as
    ``chip_smoke.measure_mesh``): device time a launch of each."""
    from dgc_tpu_torch.kernels import serve as ks

    staged = stages is not None

    def sweep(timing):
        def run(L):
            ks.lane_reset(L, timing)
            while int(L.ctrl[ks.CTRL_LIVE]):
                if staged:
                    ks.lane_compact(L)
                ks.lane_superstep(L)
                ks.lane_finish(L, timing)
        return run

    def mesh_sweep(M):
        ks.mesh_reset(M)
        while int(M.ctrl[ks.CTRL_LIVE]):
            ks.mesh_superstep(M, staged)

    eight = tuple(x[:8] for x in inputs)
    cases = {
        "timing": (sweep(True), lambda: cs._serve_lanes_of(
            inputs, cls, stages, "cuda", ks.INT32_MAX), "lane_finish_kernel"),
        "spec": (sweep(False), lambda: cs._serve_lanes_of(
            inputs, cls, stages, "cuda", ks.INT32_MAX, armed=True),
                 "lane_finish_kernel"),
        "partial, 4 slots of 2 lanes": (mesh_sweep, lambda: cs._mesh_lanes(
            eight, cls, stages, [torch.device("cuda")] * 4),
            "lane_finish_kernel<false, true>")}
    out = {}
    for name, (run, make, kname) in cases.items():
        before = ks.launch_counts["lane_finish"]
        run(make())
        torch.cuda.synchronize()
        n = ks.launch_counts["lane_finish"] - before
        t, kept, _each = cs._profiled(run, {"k": n}, cs._DEVICE_MS_KEPT,
                                      {"k": kname}, prepare=make)["k"]
        out[name] = {"launches": n, "profiled": kept, "mean_ms": t / kept}
    return out


def serve_costs(parts: list[str]) -> None:
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.serve.cli import _load_request_graph

    names = {p: _SERVE_PARTS[p] for p in parts}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp)
        rc, wall = _replay(out_dir, 0)
        cs.check(rc == 0, f"the serve replay: rc {rc}")
        ks.reset_launch_counts()
        rc, wall = _replay(out_dir, 1)
        cs.check(rc == 0, f"the serve replay: rc {rc}")
        launches = {n: ks.launch_counts[n] for n in names.values()}
        i = [2]
        # each launch's batch (class rows x lanes), in launch order, and
        # what each K14 launch found
        shapes = {n: [] for n in names.values()}
        kinds = []
        real = {n: getattr(ks, n) for n in names.values()}

        def recorded(n):
            def launch(L, *args, **kw):
                shapes[n].append(f"v{L.v} x{L.b}")
                if n == "lane_compact":
                    kinds.append(_k14_kind(L))
                return real[n](L, *args, **kw)
            return launch

        def replay():
            for n in shapes:
                shapes[n].clear()
            kinds.clear()
            _replay(out_dir, i[0])
            i[0] += 1

        for n in names.values():
            setattr(ks, n, recorded(n))
        try:
            prof = cs._profiled(replay, launches, 0.5,
                                {n: cs._SERVE_NAMES[n] for n in names.values()})
        finally:
            for n in names.values():
                setattr(ks, n, real[n])
    n_req = len(cs.SERVE_STREAM)
    rec = {"kernel": "serve", "run": "replay, continuous, batch 8",
           "wall_s": wall, "graphs_per_s": n_req / wall}
    for name in names.values():
        t, kept, each = prof[name]
        rec[name] = {"launches": launches[name], "profiled": kept,
                     "mean_ms": t / kept,
                     "sum_ms": t / kept * launches[name]}
        if kept == len(shapes[name]):  # every record kept: split by batch
            by = {}
            for shape, ms in zip(shapes[name], each):
                by.setdefault(shape, []).append(ms)
            rec[name]["by_batch"] = {k: {"launches": len(x), "sum_ms": sum(x)}
                                     for k, x in sorted(by.items())}
        if name == "lane_compact" and kept == len(kinds):
            by = {}
            for kind, ms in zip(kinds, each):
                by.setdefault(kind, []).append(ms)
            rec[name]["by_kind"] = {
                k: {"launches": len(x), "sum_ms": sum(x),
                    "mean_ms": sum(x) / len(x)} for k, x in sorted(by.items())}
    graphs = {d["id"]: _load_request_graph(d) for d in cs.SERVE_STREAM}
    _drawn_once(graphs)  # warm
    rec["drawn_once_graphs_per_s"] = _drawn_once(graphs)
    print(json.dumps(rec), flush=True)

    for prefix in ("u", "w"):
        cls, stages, inputs = cs._serve_inputs(
            [g for rid, g in graphs.items() if rid.startswith(prefix)], "cuda")
        out = _rung_sweep(inputs, cls, stages, names)
        print(json.dumps({"kernel": "serve", "run": f"one sweep of "
                          f"{inputs[1].shape[0]} lanes", "class": cls.name,
                          **out}), flush=True)
        print(json.dumps({"kernel": "serve", "run": "rounds past the live "
                          "word", "class": cls.name,
                          "lanes": inputs[1].shape[0],
                          "noop_ms": _noop_ms(inputs, cls, stages)}),
              flush=True)
        if prefix == "u" and "lane_finish" in names.values():
            print(json.dumps({"kernel": "lane_finish", "class": cls.name,
                              "instances": _k15_instances(cls, stages,
                                                          inputs)}),
                  flush=True)
        del inputs
    if "lane_compact" in names.values():
        k14_rebuilds()


RATE_RUNS = 3
SAMPLE_S = 0.001


def _host_samples(fn) -> tuple:
    """``fn()`` with every other thread's Python stack sampled each
    ``SAMPLE_S``: (its result, the samples, the share of them by innermost
    frame, and by innermost frame of the port's package, the first 15
    each)."""
    import threading
    from collections import Counter

    leaf, ours = Counter(), Counter()
    n = [0]
    done = threading.Event()
    me = threading.get_ident()

    def where(f):
        return (f"{Path(f.f_code.co_filename).name}:{f.f_lineno} "
                f"{f.f_code.co_name}")

    def sample():
        while not done.wait(SAMPLE_S):
            for tid, f in sys._current_frames().items():
                if tid in (me, sampler.ident):
                    continue
                n[0] += 1
                leaf[where(f)] += 1
                while f is not None and "dgc_tpu_torch" not in \
                        f.f_code.co_filename:
                    f = f.f_back
                if f is not None:
                    ours[where(f)] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    share = lambda c: {k: v / max(n[0], 1) for k, v in c.most_common(15)}
    return out, n[0], share(leaf), share(ours)


def rate_costs() -> None:
    """``rate``: the serve stream's graphs drawn once (``_drawn_once``:
    continuous, batch 8, as ``chip_smoke._serve_front_runs``): a warm
    run, then ``RATE_RUNS`` runs' graphs/s, then one more under a sampling
    profiler of the host threads (``_host_samples``)."""
    from dgc_tpu_torch.serve.cli import _load_request_graph

    graphs = {d["id"]: _load_request_graph(d) for d in cs.SERVE_STREAM}
    _drawn_once(graphs)  # warm
    rates = [_drawn_once(graphs) for _ in range(RATE_RUNS)]
    rate, n, leaf, ours = _host_samples(lambda: _drawn_once(graphs))
    print(json.dumps({"kernel": "serve", "run": "drawn once, continuous, "
                      "batch 8", "graphs_per_s": rates,
                      "sampled_graphs_per_s": rate, "host_samples": n,
                      "by_frame": leaf, "by_port_frame": ours}), flush=True)


def main(argv: list[str] | None = None) -> int:
    if not torch.cuda.is_available():
        print("kernel_costs: no CUDA device available", file=sys.stderr)
        return 1
    parts = list(sys.argv[1:] if argv is None else argv)
    if parts[:1] == ["--tree"]:
        sys.path.insert(0, str(Path(parts[1]).resolve()))
        parts = parts[2:]
    parts = parts or ["k3", "k11", "k12", "ring", "k5", "k8", "k1", "k23",
                      "k13", "k14", "k15", "k20", "k26", "rate"]
    serve = [p for p in parts if p in _SERVE_PARTS]
    for part in parts:
        if part in _SERVE_PARTS:
            if part == serve[0]:
                serve_costs(serve)
            continue
        {"k3": k3_costs, "k11": k11_costs, "k12": k12_costs,
         "ring": ring_costs, "k5": k5_costs, "k8": k8_costs, "k1": k1_costs,
         "k23": k23_costs, "k20": k20_costs, "k26": k26_costs,
         "rate": rate_costs}[part]()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
