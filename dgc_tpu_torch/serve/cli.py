"""``python -m dgc_tpu_torch serve`` — the request-replay front-end CLI
(port of ``dgc_tpu.serve.cli``'s replay path).

Reads a JSONL request stream (one request per line), serves it through
:class:`~dgc_tpu_torch.serve.queue.ServeFrontEnd` on the card, and writes
one JSONL result line per request. Request lines are either

- ``{"id": 3, "input": "graph.json"}`` — a reference-schema graph file;
- ``{"id": 4, "node_count": 1000, "max_degree": 16, "seed": 5,
  "gen_method": "fast"}`` — a generated graph (the CLI generator flags as
  JSON fields).

Dispatch defaults to continuous batching (lane recycling; ``--serve-mode
sync`` keeps the batch-complete baseline), ``--slice-steps`` sizes the
recycling slice (default: priced against dispatch overhead),
``--warm-classes`` runs the named shape classes' pads before the replay
clock starts, and ``--kernel-timing`` switches the slices' clock on (the
card's ``%globaltimer``). ``--device-carry`` keeps each lane pool's carry
and input stacks on the card (seats through K17, resizes through K18 and
K19, only done lanes' results home); ``--speculate-k DEPTH|auto`` serves
each batched request through the speculative minimal-k engine
(``serve.speculate``: jump-mode requests run the fused pair unchanged).
``--mesh-devices N|auto`` splits each lane pool over a lane mesh of N
shard slots (cards; 8 slots on a host without one: ``serve.batched``), the
same results as without it. ``--log-json`` / ``--run-manifest`` /
``--metrics-prom`` land the
``serve_*`` events in the schemas the sweep CLI uses. ``--device cpu``
runs the plain PyTorch versions of the kernels.

The other flags of ``dgc_tpu.serve.cli`` (network mode and its health
probe, the result cache, the fleet, fault injection, tuned configs, the
flight recorder, profiler and time series) are not ported yet: each is
refused with exit code 2.

Exit codes: 0 every request ok, 1 some request failed or was bad, 2 usage
or load error (a missing card for ``--device cuda`` included).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.models.graph import Graph

# the flags of dgc_tpu.serve.cli the port does not have yet (ROADMAP)
UNPORTED_FLAGS = (
    "--listen", "--listen-host", "--tenants", "--journal-dir",
    "--result-cache", "--result-cache-dir", "--result-cache-ttl",
    "--result-cache-max-bytes", "--replicas", "--probe-interval",
    "--brownout", "--brownout-sustain", "--brownout-clear",
    "--fleet-replica", "--fleet-incarnation", "--fleet-recover",
    "--inject-faults", "--dispatch-timeout", "--max-lane-aborts",
    "--auto-tune",
    "--tuned-cache-dir", "--metrics-port", "--flightrec-capacity",
    "--flightrec-dir", "--profile-logdir", "--no-trace",
    "--timeseries-interval", "--timeseries-capacity", "--timeseries-jsonl",
    "--slo-thresholds", "--burn-fast-window", "--burn-slow-window",
    "--burn-threshold", "--burn-profile-ms",
)


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dgc-tpu-torch serve",
        description="Batched multi-graph serving front-end (request replay) "
                    "on an NVIDIA GPU.",
    )
    p.add_argument("--requests", type=str, required=True,
                   help="JSONL request stream (module docstring schema)")
    p.add_argument("--results", type=str, default=None,
                   help="write per-request JSONL results here "
                        "(default: stdout)")
    p.add_argument("--output-colorings", type=str, default=None,
                   metavar="DIR",
                   help="also save each ok request's coloring as "
                        "DIR/<id>.json (reference coloring schema)")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max graphs per batched dispatch / lane pool "
                        "(default 8)")
    p.add_argument("--speculate-k", type=str, default=None,
                   metavar="DEPTH|auto",
                   help="speculative minimal-k (serve.speculate): keep a "
                        "window of DEPTH attempts at budgets below the live "
                        "one seated in otherwise idle lanes, below real "
                        "traffic (killed at slice boundaries when real "
                        "requests need the lanes); 'auto' prices the depth "
                        "off the free-lane count. Engages on strict-"
                        "decrement sweeps; jump-mode requests run the fused "
                        "pair unchanged. Unset: the speculation-free path")
    p.add_argument("--serve-mode", choices=["continuous", "sync"],
                   default="continuous",
                   help="continuous (default): lane recycling — finished "
                        "lanes swap in queued requests at every slice "
                        "boundary; sync: batch-complete dispatch (the A/B "
                        "baseline)")
    p.add_argument("--slice-steps", type=str, default="auto",
                   help="supersteps per continuous-mode slice, or 'auto' "
                        "to price the slice against dispatch overhead "
                        "per (class, pool width) (default auto)")
    p.add_argument("--no-affinity", action="store_true",
                   help="disable predicted-depth affinity batching")
    p.add_argument("--serve-stages", choices=["auto", "off"],
                   default="auto",
                   help="staged frontier ladder in the batched kernels: "
                        "auto (default) derives each shape class's ladder; "
                        "off runs the full table (the A/B arm)")
    p.add_argument("--device-carry", action="store_true",
                   help="device-resident lane carry (continuous mode): the "
                        "carry and the input stacks stay on the card, a "
                        "seat scatters one lane's row, a resize moves the "
                        "kept lanes there, and only done lanes' results "
                        "come home")
    p.add_argument("--mesh-devices", type=str, default=None,
                   metavar="N|auto",
                   help="split each lane pool over a lane mesh of N shard "
                        "slots (a power of two, at most the cards present; "
                        "8 slots with --device cpu), or 'auto' for the "
                        "largest such N; unset: the unsharded path")
    p.add_argument("--warm-classes", type=str, default=None,
                   metavar="CLS1,CLS2,...",
                   help="run these shape classes' kernels at every batch "
                        "pad at startup (e.g. v32768w32); warmup time is "
                        "reported separately in serve_summary")
    p.add_argument("--window-ms", type=float, default=2.0,
                   help="micro-batching window in milliseconds (default 2)")
    p.add_argument("--queue-depth", type=int, default=64,
                   help="bounded request queue capacity (default 64)")
    p.add_argument("--workers", type=int, default=None,
                   help="in-flight request bound (default: --batch-max)")
    p.add_argument("--submit-timeout", type=float, default=30.0,
                   help="seconds a submission may wait for queue space "
                        "before it is rejected (default 30)")
    p.add_argument("--no-reduce-colors", action="store_true",
                   help="disable the recolor post-pass (CLI parity)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip ground-truth validation per request")
    p.add_argument("--log-json", type=str, default=None,
                   help="write the structured JSONL run log")
    p.add_argument("--run-manifest", type=str, default=None,
                   help="write the run manifest (serve slot included)")
    p.add_argument("--metrics-prom", type=str, default=None,
                   help="write metrics in Prometheus text format")
    p.add_argument("--kernel-timing", action="store_true",
                   help="the slices' in-kernel clock: per-lane superstep "
                        "wall time in the carry, the sstep/overhead split "
                        "in serve_slice events, and measured slice-size "
                        "recalibration (continuous mode)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the kernels run (default: cuda; cpu runs "
                        "their plain PyTorch versions)")
    return p


def _unported(tokens: list) -> list:
    """The flags of ``tokens`` that ``dgc_tpu.serve.cli`` has and the port
    does not."""
    return [t.split("=", 1)[0] for t in tokens
            if t.split("=", 1)[0] in UNPORTED_FLAGS]


def _load_request_graph(doc: dict) -> Graph:
    if "input" in doc:
        return Graph.deserialize(doc["input"])
    if "node_count" in doc and "max_degree" in doc:
        return Graph.generate(int(doc["node_count"]), int(doc["max_degree"]),
                              seed=doc.get("seed"),
                              method=doc.get("gen_method", "fast"))
    raise ValueError(
        "request needs either 'input' or 'node_count'+'max_degree'")


def serve_main(argv: list[str] | None = None) -> int:
    parser = build_serve_parser()
    raw = list(sys.argv[2:] if argv is None else argv)
    refused = _unported(raw)
    if refused:
        print(f"{', '.join(refused)}: not yet ported to dgc_tpu_torch serve "
              f"(see ROADMAP.md)", file=sys.stderr)
        return 2
    args, unknown = parser.parse_known_args(raw)
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    try:
        resolve_device(args.device)
    except RuntimeError as e:  # a card asked for where there is none
        print(f"Cannot run on --device {args.device}: {e}", file=sys.stderr)
        return 2

    from dgc_tpu_torch.obs import MetricsRegistry, RunLogger, RunManifest

    requests = []
    try:
        lines = Path(args.requests).read_text().splitlines()
    except OSError as e:
        print(f"Cannot read --requests {args.requests}: {e}",
              file=sys.stderr)
        return 2
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError("request line must be a JSON object")
            requests.append((doc.get("id", lineno), doc))
        except (json.JSONDecodeError, ValueError) as e:
            print(f"{args.requests}:{lineno}: bad request: {e}",
                  file=sys.stderr)
            return 2
    if args.slice_steps != "auto":
        try:
            args.slice_steps = int(args.slice_steps)
        except ValueError:
            print(f"--slice-steps must be an integer or 'auto', got "
                  f"{args.slice_steps!r}", file=sys.stderr)
            return 2
    if args.mesh_devices is not None and args.mesh_devices != "auto":
        try:
            args.mesh_devices = int(args.mesh_devices)
        except ValueError:
            print(f"--mesh-devices must be 'auto' or an integer, got "
                  f"{args.mesh_devices!r}", file=sys.stderr)
            return 2
    if args.speculate_k is not None and args.speculate_k != "auto":
        try:
            args.speculate_k = int(args.speculate_k)
            if args.speculate_k < 1:
                raise ValueError
        except ValueError:
            print(f"--speculate-k must be a positive integer or 'auto', "
                  f"got {args.speculate_k!r}", file=sys.stderr)
            return 2

    # the event stream goes to --log-json only, as the port's sweep CLI
    logger = RunLogger(jsonl_path=args.log_json, echo=False)
    registry = MetricsRegistry()
    manifest = RunManifest()
    logger.add_sink(manifest)
    try:
        return _replay(args, requests, logger, registry, manifest)
    finally:
        logger.close()


def _replay(args, requests, logger, registry, manifest) -> int:
    """Serve ``requests`` through a started front end; write the result
    lines, the colorings, the summary event and the manifest and metrics
    files the arguments name. Returns the exit code."""
    from dgc_tpu_torch.serve.queue import QueueFull, ServeFrontEnd

    out_dir = Path(args.output_colorings) if args.output_colorings else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    try:
        front = ServeFrontEnd(
            batch_max=args.batch_max, window_s=args.window_ms / 1e3,
            queue_depth=args.queue_depth, workers=args.workers,
            mode=args.serve_mode,
            slice_steps=(None if args.slice_steps == "auto"
                         else args.slice_steps),
            affinity=not args.no_affinity,
            stages=args.serve_stages, device_carry=args.device_carry,
            mesh_devices=args.mesh_devices,
            speculate_k=args.speculate_k, timing=args.kernel_timing,
            validate=not args.no_validate,
            post_reduce=not args.no_reduce_colors,
            logger=logger, registry=registry, device=args.device,
        ).start()
    except ValueError as e:
        # a bad --mesh-devices (not a power of two, more than the host
        # has) is a usage error
        what = "--mesh-devices" if args.mesh_devices is not None else "serve"
        print(f"{what}: {e}", file=sys.stderr)
        return 2

    # warmup runs (and is reported) outside the serve clock
    warmup = None
    if args.warm_classes:
        try:
            warmup = front.warm(
                [c for c in args.warm_classes.split(",") if c.strip()])
        except ValueError as e:
            print(f"--warm-classes: {e}", file=sys.stderr)
            front.shutdown(drain=False)
            return 2

    t0 = time.perf_counter()
    with (open(args.results, "w") if args.results
          else contextlib.nullcontext(sys.stdout)) as results_fh:
        bad = 0
        tickets = []
        graphs = {}
        for rid, doc in requests:
            try:
                graph = _load_request_graph(doc)
            except (OSError, ValueError, KeyError) as e:
                bad += 1
                results_fh.write(json.dumps(
                    {"id": rid, "status": "error",
                     "error": f"bad request: {e}"}) + "\n")
                continue
            graphs[rid] = graph
            try:
                tickets.append(front.submit(graph.arrays, request_id=rid,
                                            timeout=args.submit_timeout))
            except QueueFull as e:
                bad += 1
                results_fh.write(json.dumps(
                    {"id": rid, "status": "rejected", "error": str(e)}) + "\n")
        for ticket in tickets:
            res = ticket.result()
            rid = res.request_id
            rec = {"id": rid, "status": res.status,
                   "minimal_colors": res.minimal_colors,
                   "queue_ms": round(res.queue_s * 1e3, 3),
                   "service_ms": round(res.service_s * 1e3, 3),
                   "batched": res.batched, "shape_class": res.shape_class,
                   "error": res.error}
            if res.ok and out_dir is not None:
                path = out_dir / f"{rid}.json"
                graphs[rid].save_coloring(path, np.asarray(res.colors))
                rec["coloring"] = str(path)
            if not res.ok:
                bad += 1
            results_fh.write(json.dumps(rec) + "\n")
    front.health(emit=True)
    front.shutdown(drain=True)
    wall = time.perf_counter() - t0

    st = front.stats_snapshot()
    sst = front.scheduler.stats_snapshot()
    done = st["completed"]
    summary_kw = {}
    latency = front.latency_summary()
    if latency is not None:
        summary_kw["latency_ms"] = latency
    if sst.get("recals"):
        summary_kw["recals"] = sst["recals"]
    mesh_snap = front.scheduler.mesh_snapshot()
    if mesh_snap is not None:
        summary_kw["mesh_devices"] = mesh_snap["mesh_devices"]
        summary_kw["device_occupancy"] = mesh_snap["device_occupancy"]
    if sst.get("mesh_degrades"):
        # the failure-domain plane's counters, only after a degrade
        summary_kw["mesh_degrades"] = sst["mesh_degrades"]
        summary_kw["lanes_evacuated"] = sst.get("lanes_evacuated", 0)
    if sst.get("spec_seated") or sst.get("spec_cancelled"):
        # the speculation plane's totals, only when an attempt speculated
        for key in ("spec_seated", "spec_wins", "spec_cancelled",
                    "spec_preempted", "spec_wasted_steps"):
            summary_kw[key] = sst[key]
    logger.event("serve_summary", requests=len(requests), completed=done,
                 failed=st["failed"],
                 rejected=st["rejected"],
                 wall_s=round(wall, 4),
                 graphs_per_s=round(done / wall, 3) if wall > 0 else None,
                 batches=sst["batches"],
                 slices=sst["slices"],
                 recycles=sst["recycles"],
                 mode=front.scheduler.mode,
                 warmup_s=warmup["seconds"] if warmup else None,
                 warmed_kernels=warmup["kernels"] if warmup else None,
                 compile_misses=sst["compile_misses"],
                 compile_hits=sst["compile_hits"],
                 h2d_mb=round(sst["h2d_bytes"] / 1e6, 3),
                 d2h_mb=round(sst["d2h_bytes"] / 1e6, 3),
                 **summary_kw)
    if args.run_manifest:
        manifest.finalize(registry=registry)
        manifest.write(args.run_manifest)
        logger.event("manifest_written", path=args.run_manifest)
    if args.metrics_prom:
        registry.write_prom(args.metrics_prom)
        logger.event("metrics_written", path=args.metrics_prom)
    return 1 if bad else 0
