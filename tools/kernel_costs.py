"""Where K1 (`superstep_rows`), K3 (`compact_slots`), K5
(`segmented_superstep`), K8 (`hub_superstep`), K11 (`dense_forbid`), K23
(`ring_stats`), K24 (`ring_stats_wide`) and K25 (`ring_apply`) spend their
time on the card:
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

    python tools/kernel_costs.py [k3] [k11] [ring] [k5] [k8] [k1] [k23]
    python tools/kernel_costs.py --tree DIR k1 k23   # all parts if none

``--tree DIR`` times another checkout's package (an unpacked ``git
archive``, e.g. the parent commit's) with these parts. Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def main(argv: list[str] | None = None) -> int:
    if not torch.cuda.is_available():
        print("kernel_costs: no CUDA device available", file=sys.stderr)
        return 1
    parts = list(sys.argv[1:] if argv is None else argv)
    if parts[:1] == ["--tree"]:
        sys.path.insert(0, str(Path(parts[1]).resolve()))
        parts = parts[2:]
    parts = parts or ["k3", "k11", "ring", "k5", "k8", "k1", "k23"]
    for part in parts:
        {"k3": k3_costs, "k11": k11_costs, "ring": ring_costs,
         "k5": k5_costs, "k8": k8_costs, "k1": k1_costs,
         "k23": k23_costs}[part]()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
