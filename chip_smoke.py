"""Drive the PyTorch port (``dgc_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

0. Build: every CUDA source of the port, one ``nvcc`` each.
1. Kernels vs plain: the superstep kernel (K1) and the loop-control
   kernel (K2) against their plain PyTorch versions on seeded random
   blocks — plane counts 1, 2, 3, 32, 40; budgets 1, 31, 32, 33, 32P, above
   the window; exact and capped windows; rows full of pad sentinels;
   either state buffer current; an attempt no longer running. Exact.
2. Engines vs the CPU: ``ell-bucketed`` and ``ell`` on a 20k-vertex uniform
   graph and ``ell-bucketed`` on a 20k RMAT graph, jump and strict mode:
   every attempt's (k, status, supersteps, colors_used) and the final
   colors equal the ``device="cpu"`` run byte for byte; so do single
   attempts on K40 under a 1-plane window cap, on isolated vertices, and
   at budgets below 1.
3. The main path at full size: the CLI's calls (``cli.load_graph``,
   ``cli.make_engine``, ``cli.sweep``, ``Graph.save_coloring``) on a
   1M-vertex uniform graph of average degree 16 (``--max-degree 32
   --gen-method fast``), for ``ell-bucketed`` then ``ell``. The launch
   counts are zeroed just before each sweep and read just after; the
   coloring must validate. Then each kernel is timed with CUDA events at
   the shapes of that path and held against its plain version there.

Output: one JSON line per phase-3 run, the card's name and power limit as
``nvidia-smi`` gives them, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the port is missing. Imports no JAX and nothing
of ``dgc_tpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SMOKE_V = 20_000
MAIN_ARGS = ["--node-count", "1000000", "--max-degree", "32",
             "--gen-method", "fast", "--seed", "0", "--device", "cuda"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---- phase 1: kernels vs plain ----------------------------------------------

def _random_case(rng, planes: int, k: int, capped: bool, cur: int, device):
    from dgc_tpu_torch.engine.bucketed import fail_valid
    from dgc_tpu_torch.kernels.superstep import CTRL_CUR, new_ctrl, new_state

    v, rows = 3000, 700
    width = 32 * planes + 16 if capped else 32 * planes - 1
    colors = rng.integers(0, 32 * planes + 40, size=v)
    packed = np.where(rng.random(v) < 0.3, -1,
                      colors * 2 + rng.integers(0, 2, size=v)).astype(np.int32)
    state = new_state(torch.from_numpy(packed).to(device))
    state[1, :v] = torch.from_numpy(rng.permutation(packed)).to(device)
    nbrs = rng.integers(0, v + 1, size=(rows, width))
    nbrs[rng.random(rows) < 0.05] = v  # rows full of pad sentinels
    beats = rng.integers(0, 2, size=(rows, width))
    table = torch.from_numpy((nbrs | beats << 30).astype(np.int32)).to(device)
    ctrl = new_ctrl(step=3, prev_active=v, device=device)
    ctrl[CTRL_CUR] = cur
    row0 = int(rng.integers(0, v - rows + 1))
    return ctrl, state, table, row0, fail_valid(width, planes, k)


def phase_kernels(device) -> int:
    """K1 and K2 vs their plain versions; returns the max abs difference."""
    from dgc_tpu_torch.kernels import superstep as ks

    rng = np.random.default_rng(0)
    err = 0
    cases = 0
    for planes in (1, 2, 3, 32, 40):  # 40: a widened window, two groups
        for k in (1, 31, 32, 33, 32 * planes, 32 * planes + 7):
            for capped in (False, True):
                cur = cases % 2
                ctrl, state, table, row0, fv = _random_case(
                    rng, planes, k, capped, cur, device)
                ctrl_p, state_p = ctrl.clone(), state.clone()
                ks.superstep_rows(ctrl, state, table, row0, planes, k, fv)
                ks.superstep_rows_reference(ctrl_p, state_p, table, row0,
                                            planes, k, fv)
                err = max(err, int((state - state_p).abs().max()),
                          int((ctrl - ctrl_p).abs().max()))
                cases += 1
    # an attempt that already left RUNNING: K1 must touch nothing
    ctrl, state, table, row0, fv = _random_case(rng, 2, 40, False, 0, device)
    ctrl[ks.CTRL_STATUS] = 1
    before = (ctrl.clone(), state.clone())
    ks.superstep_rows(ctrl, state, table, row0, 2, 40, fv)
    err = max(err, int((state - before[1]).abs().max()),
              int((ctrl - before[0]).abs().max()))
    # K2 over random loop carries and both stall rules
    for _ in range(300):
        status = int(rng.choice([0, 0, 0, 1, 2, 3]))
        step = int(rng.integers(0, 100))
        prev = int(rng.integers(0, 50))
        fail = int(rng.choice([0, 0, int(rng.integers(1, 5))]))
        active = int(rng.choice([0, prev, int(rng.integers(0, 60))]))
        vals = [status, step, prev, int(rng.integers(0, 70)),
                int(rng.integers(0, 2)), fail, active, int(rng.integers(-1, 9))]
        ctrl = torch.tensor(vals, dtype=torch.int32, device=device)
        ctrl_p = ctrl.clone()
        max_steps = int(rng.choice([ks.INT32_MAX, int(rng.integers(1, 110))]))
        window = int(rng.choice([64, ks.INT32_MAX, int(rng.integers(1, 70))]))
        ks.superstep_finish(ctrl, max_steps, window)
        ks.superstep_finish_reference(ctrl_p, max_steps, window)
        err = max(err, int((ctrl - ctrl_p).abs().max()))
    torch.cuda.synchronize()
    check(err == 0, f"kernels disagree with their plain versions: max abs "
                    f"err {err}")
    return err


# ---- phase 2: engines vs the CPU --------------------------------------------

def _attempt_rows(result) -> list[tuple]:
    return [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in result.attempts]


def phase_engines(device, v: int = SMOKE_V) -> list[dict]:
    from dgc_tpu_torch.cli import make_engine
    from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring, make_validator
    from dgc_tpu_torch.models.graph import Graph

    rows = []
    graphs = [("uniform", Graph.generate(v, 32, seed=1, method="fast"),
               ("ell-bucketed", "ell")),
              ("rmat", Graph.generate(v, 32, seed=2, method="rmat"),
               ("ell-bucketed",))]
    for gname, graph, backends in graphs:
        for backend in backends:
            k0 = graph.initial_k()
            for strict in (False, True):
                if strict and gname == "rmat":
                    # the hub degree puts k0 in the hundreds; start the
                    # strict chain a few budgets above the jump result
                    k0 = rows[-1]["colors"] + 3
                runs = {}
                for dev in (device, "cpu"):
                    args = argparse.Namespace(backend=backend, device=dev)
                    runs[dev] = find_minimal_coloring(
                        make_engine(args, graph), k0, strict_decrement=strict,
                        validate=make_validator(graph.arrays))
                a, b = runs[device], runs["cpu"]
                same = (_attempt_rows(a) == _attempt_rows(b)
                        and np.array_equal(a.colors, b.colors))
                check(same, f"{backend} on {gname} (strict={strict}) differs "
                            f"from its CPU run: {_attempt_rows(a)} vs "
                            f"{_attempt_rows(b)}")
                rows.append({"graph": gname, "backend": backend,
                             "strict": strict, "k0": k0,
                             "attempts": len(a.attempts),
                             "colors": a.minimal_colors})
    rows += _edge_cases(device)
    return rows


def _edge_cases(device) -> list[dict]:
    """Single attempts on small graphs that take the engines' rare paths:
    K40 under a 1-plane window cap (capped fail gate, STALLED, widening),
    isolated vertices, and budgets below 1 (no launch at all)."""
    from dgc_tpu_torch.engine.bucketed import BucketedELLEngine
    from dgc_tpu_torch.engine.superstep import ELLEngine
    from dgc_tpu_torch.models.arrays import GraphArrays

    k40 = GraphArrays.from_edge_list(
        40, np.array([[i, j] for i in range(40) for j in range(i + 1, 40)]))
    iso = GraphArrays.from_neighbor_lists([[], [2, 3], [1], [1], [], [6], [5], []])
    cases = [
        ("k40-cap1", lambda d: BucketedELLEngine(k40, max_window_planes=1,
                                                 device=d), (41, 40, 39, 32, 0)),
        ("k40-ell", lambda d: ELLEngine(k40, device=d), (41, 40, 39, 1)),
        ("isolated-bucketed", lambda d: BucketedELLEngine(iso, device=d),
         (3, 2, 1, 0, -1)),
        ("isolated-ell", lambda d: ELLEngine(iso, device=d), (3, 2, 1, 0)),
    ]
    rows = []
    for name, make, budgets in cases:
        engines = {d: make(d) for d in (device, "cpu")}
        for k in budgets:
            a, b = (engines[d].attempt(k) for d in (device, "cpu"))
            check((a.status, a.supersteps) == (b.status, b.supersteps)
                  and np.array_equal(a.colors, b.colors),
                  f"{name} at k={k} differs from its CPU run")
        rows.append({"graph": name, "budgets": list(budgets),
                     "status": a.status.name})
    return rows


# ---- phase 3: the main path at full size ------------------------------------

def _cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def _device_ms(fn, reps: int, name: str | None = None) -> float:
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    durations of the CUDA events whose name contains ``name`` (every
    device event when None). Fails the run when the profiler saw no such
    event: the kernels' ``ms`` is device time, never a host-side rate."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.name)]
    check(bool(device), f"torch.profiler saw no device event"
                        f"{'' if name is None else ' of ' + name}")
    return sum(e.time_range.elapsed_us() for e in device) / 1e3 / reps


class _TimedEngine:
    """Host wall time of each ``attempt`` call of the wrapped engine."""

    def __init__(self, engine):
        self.engine = engine
        self.seconds: list[float] = []

    def attempt(self, k: int):
        t = time.perf_counter()
        res = self.engine.attempt(k)
        self.seconds.append(time.perf_counter() - t)
        return res


def _engine_parts(engine, k: int):
    """(k passed to the kernel, packed0, step0, parts) of one attempt."""
    from dgc_tpu_torch.engine.base import clamp_budget
    from dgc_tpu_torch.engine.bucketed import fail_valid

    if hasattr(engine, "combined_buckets"):
        parts = [(r0, cb, p, fail_valid(cb.shape[1], p, k)) for r0, cb, p in
                 zip(engine.row0, engine.combined_buckets, engine.planes)]
        packed0 = torch.where(engine.degrees == 0, 0, 1).to(torch.int32)
        return k, packed0, 1, parts
    k_eff = clamp_budget(k, 32 * engine.num_planes)
    packed0 = torch.where(engine.degrees == 0, 0, -1).to(torch.int32)
    return k_eff, packed0, 0, [(0, engine.table, engine.num_planes, True)]


def measure_kernels(engine, k: int, directed_edges: int) -> dict:
    """Time K1 (one superstep: every part) and K2 at the engine's shapes,
    hold K1 against its plain version on the first superstep and on a
    mid-attempt state, and compute the bound."""
    from dgc_tpu_torch.kernels import superstep as ks
    from dgc_tpu_torch.ops.speculative import NBR_MASK

    k_run, packed0, step0, parts = _engine_parts(engine, k)
    v = packed0.shape[0]

    def fresh():
        return (ks.new_ctrl(step0, v + 1, packed0.device),
                ks.new_state(packed0))

    def k1(ctrl, state, fn=ks.superstep_rows):
        for row0, table, planes, fv in parts:
            fn(ctrl, state, table, row0, planes, k_run, fv)

    err = 0
    for steps in (0, 3):  # the first superstep, then a mid-attempt one
        ctrl, state = fresh()
        for _ in range(steps):
            k1(ctrl, state)
            ks.superstep_finish(ctrl, ks.INT32_MAX, 64)
        ctrl_p, state_p = ctrl.clone(), state.clone()
        k1(ctrl, state)
        k1(ctrl_p, state_p, ks.superstep_rows_reference)
        torch.cuda.synchronize()
        err = max(err, int((state - state_p).abs().max()),
                  int((ctrl - ctrl_p).abs().max()))
    check(err == 0, f"K1 disagrees with its plain version at the main "
                    f"path's shapes: max abs err {err}")

    ctrl, state = fresh()
    k1_ms = _cuda_ms(lambda: k1(ctrl, state), reps=50)
    k1_device_ms = _device_ms(lambda: k1(ctrl, state), reps=20,
                              name="superstep_rows_kernel")
    ctrl, state = fresh()
    k1_plain_ms = _host_ms(
        lambda: k1(ctrl, state, ks.superstep_rows_reference), reps=3)
    ctrl, _ = fresh()
    k2_ms = _cuda_ms(lambda: ks.superstep_finish(ctrl, ks.INT32_MAX, 64),
                     reps=200)
    k2_device_ms = _device_ms(
        lambda: ks.superstep_finish(ctrl, ks.INT32_MAX, 64), reps=50,
        name="superstep_finish_kernel")
    ctrl, _ = fresh()
    k2_plain_ms = _host_ms(
        lambda: ks.superstep_finish_reference(ctrl, ks.INT32_MAX, 64), reps=50)
    # yardstick only (the port never calls it): one torch gather of the
    # state through every table entry
    src = state[0]
    masks = [(t & NBR_MASK).to(torch.int64) for _, t, _, _ in parts]
    gather_ms = _cuda_ms(lambda: [src[m] for m in masks], reps=20)

    # The bound counts what a superstep needs: each vertex's real neighbor
    # entries once (the sentinel padding past its degree is not needed
    # work), its degree, and the state read and written. The timed calls
    # all run a first superstep, where every vertex with a neighbor is
    # uncolored (ELL) or fresh (bucketed) and reads its whole list. The
    # padded tables' bytes are kept beside it.
    entries = sum(int(t.numel()) for _, t, _, _ in parts)
    real = sum(int(((t & NBR_MASK) != v).sum()) for _, t, _, _ in parts)
    check(real == directed_edges, f"tables hold {real} real entries, the "
                                  f"graph {directed_edges} directed edges")
    k1_bytes = real * 4 + 3 * v * 4 + 8 * 4
    table_bytes = entries * 4 + 2 * v * 4 + 8 * 4
    # one whole attempt: host wall clock against the device's busy time
    t = time.perf_counter()
    engine.attempt(k)
    attempt_wall_ms = (time.perf_counter() - t) * 1e3
    attempt_device_ms = _device_ms(lambda: engine.attempt(k), reps=1)
    return {
        "k1_ms": k1_device_ms, "k1_event_ms": k1_ms,
        "k1_plain_ms": k1_plain_ms,
        "k1_bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
        "k1_bytes": k1_bytes, "real_entries": real,
        "table_entries": entries, "k1_table_bytes": table_bytes,
        "k1_table_bound_ms": table_bytes / HBM_BYTES_PER_S * 1e3,
        "k1_launches_per_superstep": len(parts),
        "k2_ms": k2_device_ms, "k2_event_ms": k2_ms,
        "k2_plain_ms": k2_plain_ms,
        "attempt_k": k, "attempt_wall_ms": attempt_wall_ms,
        "attempt_device_busy_ms": attempt_device_ms,
        "k2_bound_ms": 2 * 8 * 4 / HBM_BYTES_PER_S * 1e3,
        "gather_yardstick_ms": gather_ms, "max_abs_err": err,
    }


def phase_main_path(card: str, out_dir: Path) -> list[dict]:
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import superstep as ks
    from dgc_tpu_torch.ops.validate import validate_coloring

    args = cli.build_parser().parse_args(
        MAIN_ARGS + ["--output-coloring", str(out_dir / "coloring.json")])
    t = time.perf_counter()
    graph = cli.load_graph(args)
    gen_s = time.perf_counter() - t
    records = []
    for backend in cli.BACKENDS:
        args.backend = backend
        t = time.perf_counter()
        engine = cli.make_engine(args, graph)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        ks.reset_launch_counts()
        engine.host_syncs = 0
        timed = _TimedEngine(engine)
        result = cli.sweep(args, graph, timed)
        torch.cuda.synchronize()
        launches = dict(ks.launch_counts)
        syncs_per_attempt = engine.host_syncs / len(result.attempts)
        peak_bytes = torch.cuda.max_memory_allocated()
        check(result.colors is not None, f"{backend}: no coloring")
        val = validate_coloring(graph.arrays.indptr, graph.arrays.indices,
                                result.colors)
        check(val.valid, f"{backend}: invalid coloring {val}")
        check(launches["superstep_rows"] > 0 and launches["superstep_finish"] > 0,
              f"{backend}: the sweep launched no kernel: {launches}")
        graph.save_coloring(args.output_coloring, result.colors)
        check(np.array_equal(graph.load_coloring(args.output_coloring),
                             result.colors), f"{backend}: coloring JSON")
        sweep_s = result.wall_time_s - result.post_reduce_s
        meas = measure_kernels(engine, graph.initial_k(),
                               graph.arrays.num_directed_edges)
        rec = {
            "phase": "main_path", "backend": backend,
            "vertices": graph.num_vertices,
            "directed_edges": graph.arrays.num_directed_edges,
            "max_degree": graph.max_degree, "gen_s": gen_s,
            "engine_build_s": build_s, "sweep_s": sweep_s,
            "post_reduce_s": result.post_reduce_s,
            "attempt_s": timed.seconds,
            "supersteps": result.total_supersteps,
            "attempts": [(a.k, a.status.name, a.supersteps, a.colors_used)
                         for a in result.attempts],
            "colors_swept": result.swept_colors,
            "colors_after_post_pass": result.minimal_colors,
            "launches": launches,
            "host_syncs_per_attempt": syncs_per_attempt,
            "max_memory_allocated": peak_bytes,
            "card": card, **meas,
        }
        emit(rec)
        records.append(rec)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from dgc_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 1
    card = card_line()
    t = time.perf_counter()
    for source in sorted(p.name for p in build.CSRC.glob("*.cu")):
        build.build(source)
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "nvcc": {k: v.strip().splitlines()[-8:]
                   for k, v in build.build_log.items()}})

    t = time.perf_counter()
    kernel_err = phase_kernels("cuda")
    emit({"phase": "kernels_vs_plain", "max_abs_err": kernel_err,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    rows = phase_engines("cuda")
    emit({"phase": "engines_vs_cpu", "runs": rows,
          "seconds": time.perf_counter() - t})

    with tempfile.TemporaryDirectory() as out_dir:
        main_runs = phase_main_path(card, Path(out_dir))
    bucketed = main_runs[0]
    print(card)
    source = "dgc_tpu_torch/csrc/superstep.cu"
    emit({"kernels": [
        {"name": "superstep_rows", "route": "cuda", "source": source,
         "replaces": "dgc_tpu/ops/speculative.py:124",
         "launches": bucketed["launches"]["superstep_rows"],
         "launches_by_backend": {r["backend"]: r["launches"]["superstep_rows"]
                                 for r in main_runs},
         "max_abs_err": max([kernel_err] + [r["max_abs_err"] for r in main_runs]),
         "ms": bucketed["k1_ms"], "plain_ms": bucketed["k1_plain_ms"],
         "bound_ms": bucketed["k1_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "superstep_finish", "route": "cuda", "source": source,
         "replaces": "dgc_tpu/engine/bucketed.py:273",
         "launches": bucketed["launches"]["superstep_finish"],
         "launches_by_backend": {r["backend"]: r["launches"]["superstep_finish"]
                                 for r in main_runs},
         "max_abs_err": kernel_err,
         "ms": bucketed["k2_ms"], "plain_ms": bucketed["k2_plain_ms"],
         "bound_ms": bucketed["k2_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
