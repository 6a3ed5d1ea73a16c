"""Where K3 (`compact_slots`), K11 (`dense_forbid`), K24
(`ring_stats_wide`) and K25 (`ring_apply`) spend their time on the card:
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

    python tools/kernel_costs.py [k3] [k11] [ring]    # all three if none

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the timing helpers)
from dgc_tpu_torch.kernels import compact as kc  # noqa: E402
from dgc_tpu_torch.kernels import dense as kd  # noqa: E402

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
    for rows, table in engine.rot[0]:
        kr.ring_stats(ctrl, block, engine.packed_l, table, rows, acc, planes)
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


def main(argv: list[str] | None = None) -> int:
    if not torch.cuda.is_available():
        print("kernel_costs: no CUDA device available", file=sys.stderr)
        return 1
    parts = (sys.argv[1:] if argv is None else argv) or ["k3", "k11", "ring"]
    for part in parts:
        {"k3": k3_costs, "k11": k11_costs, "ring": ring_costs}[part]()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
