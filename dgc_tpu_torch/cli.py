"""The port's command-line entry point — the core of ``dgc_tpu.cli``.

Keeps the reference's flags and mutual-requirement validation: ``--input``
*or* (``--node-count`` + ``--max-degree``), optional ``--output-graph``,
required ``--output-coloring``, in the reference's JSON schemas; the saved
coloring is the last *valid* one (``--compat-failed-output``: the
reference's failed final attempt's partial one). Adds the engine
(``--backend``: the three ELL engines, ``dense`` for V up to 16,384, and
the host parity targets ``oracle`` and ``reference-sim`` with
``--sim-variant``, whose counts the post-pass never touches), the device
(``--device``, default ``cuda``), the attempt block
(``--attempts-per-dispatch A|auto``: up to A budgets chained on the card
per block, ``ell-compact`` only) and checkpoint/resume
(``--checkpoint-dir``, ``--checkpoint-write-behind``), as ``dgc_tpu.cli``
has them. The graph drawn at ``--seed`` is ``dgc_tpu.cli``'s (the C++
generators above 50,000 vertices, where a toolchain exists).

Telemetry, with ``dgc_tpu.cli``'s semantics and file schemas:
``--log-json PATH`` appends the JSONL event stream (``obs.events``, the
schema of ``obs.schema``); ``--run-manifest PATH`` writes the run manifest
(``obs.manifest``) and ``--metrics-prom PATH`` the Prometheus text of the
run's metrics (``obs.metrics``; ``dgc_device_dispatches_total`` counts an
attempt block once). Either of the last two switches the engines'
in-kernel trajectories on (the recording kernels; one ``trajectory``
event per attempt); ``--superstep-timing`` then adds each superstep's
timestamp (``step_us``), on ``ell-compact`` only: it is the card's
``%globaltimer`` (the host clock with ``--device cpu``), not the JAX
package's host clock, so only its differences mean anything.

``--speculate-k DEPTH|auto`` routes the sweep through a one-request serve
pool (``serve.speculate.SpeculativeMinimalKEngine`` over the batched serve
kernels, the carry resident on the device): with ``--strict-decrement`` the budgets ``k-1 … k-DEPTH`` run as
spec-tagged lanes beside the attempt the driver consumes, with the same
attempts and colors as without it; ``auto`` prices the depth off the
starting budget (``utils.schedule_model.speculation_auto_cap``). A graph
beyond the serve shape ladder takes the normal path, and on this route
``--checkpoint-dir`` is ignored and ``--attempts-per-dispatch`` is 1, each
with a note on stderr, as ``dgc_tpu.cli``.

``--backend sharded`` and ``sharded-bucketed`` (``--shards N``, default:
every rank) run the vertex-sharded all-gather engines over
``torch.distributed``, and ``--backend sharded-ring`` the ring-halo engine
(the blocks passed around the ranks by point-to-point, O(V/n) state a
rank): a plain run is a one-rank mesh, and under ``torchrun`` every rank
runs the whole CLI as one shard of the mesh (NCCL on the card, gloo with
``--device cpu``), writing the same outputs as every process of
``dgc_tpu.cli`` does. Not ported: ``--reshard-on-loss`` (refused with rc 2
and a note), tuned configs, the profiler windows and flight recorder, and
the other resilience flags (ROADMAP).

    python -m dgc_tpu_torch --node-count 1000 --max-degree 10 --seed 42 \\
        --output-coloring colors.json [--backend ell-compact] [--device cpu] \\
        [--backend sharded-bucketed|sharded-ring --shards 2] \\
        [--log-json run.jsonl --run-manifest run.json \\
         --metrics-prom run.prom --superstep-timing] \\
        [--strict-decrement --speculate-k 3]

``python -m dgc_tpu_torch serve --requests load.jsonl ...`` is the batched
serve tier's request replay (``serve.cli``).

Exit codes: 0 success, 1 no valid coloring, 2 usage or load error (a
missing card for ``--device cuda`` included).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.minimal_k import (MinimalColoringResult,
                                            find_minimal_coloring,
                                            make_reducer, make_validator)
from dgc_tpu_torch.models.graph import Graph
from dgc_tpu_torch.obs import (MetricsRegistry, ObservedEngine,
                               PhaseCollector, RunLogger, RunManifest)

BACKENDS = ("ell-compact", "ell-bucketed", "ell", "dense", "sharded",
            "sharded-bucketed", "sharded-ring", "reference-sim", "oracle")
# the multi-device backends (one rank of the process group per device)
SHARDED_BACKENDS = ("sharded", "sharded-bucketed", "sharded-ring")
# the host backends are the reference's semantics: their count is the
# parity target, so the post-pass never touches it
HOST_BACKENDS = ("reference-sim", "oracle")
# the host work the attempt block saves per attempt: the engine time of the
# 1M-vertex uniform strict sweep (k0 = 33, 24 attempts), sequential less
# blocked at A = 4, over its attempts ((0.378 - 0.194 s) / 24), measured by
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W. ``auto`` picks the
# same A for any positive value (utils.schedule_model).
ATTEMPT_HOST_COST_S = 7.67e-3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dgc-tpu-torch",
        description="Minimal graph coloring on an NVIDIA GPU (PyTorch port "
                    "of dgc_tpu, hand-written CUDA kernels).",
    )
    p.add_argument("--input", type=str, default=None,
                   help="input graph JSON (reference schema)")
    p.add_argument("--node-count", type=int, default=None,
                   help="random graph: number of nodes")
    p.add_argument("--max-degree", type=int, default=None,
                   help="random graph: maximum degree")
    p.add_argument("--output-graph", type=str, default=None,
                   help="save the generated graph JSON")
    p.add_argument("--output-coloring", type=str, required=True,
                   help="save the coloring JSON")
    p.add_argument("--seed", type=int, default=None, help="generator seed")
    p.add_argument("--gen-method", choices=["reference", "fast", "rmat"],
                   default="reference",
                   help="random generator: reference semantics, vectorized "
                        "large-V, or RMAT")
    p.add_argument("--backend", choices=list(BACKENDS),
                   default="ell-compact",
                   help="coloring engine (default: ell-compact, the staged "
                        "frontier-compacted engine)")
    p.add_argument("--shards", type=int, default=None,
                   help="sharded backends: number of devices, one rank each "
                        "(default: every rank of the process group)")
    p.add_argument("--reshard-on-loss", action="store_true",
                   help="not ported yet (dgc_tpu.cli's re-shard rung)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs (default: cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--strict-decrement", action="store_true",
                   help="decrement k one-by-one like the reference instead "
                        "of jumping to colors_used-1")
    p.add_argument("--speculate-k", type=str, default=None,
                   metavar="DEPTH|auto",
                   help="speculative minimal-k: route the sweep through a "
                        "one-request serve pool that keeps the next DEPTH "
                        "budgets' attempts running in sibling lanes while "
                        "the driver consumes the current one (the same "
                        "results); 'auto' prices the depth off the starting "
                        "budget. The win needs --strict-decrement; the "
                        "sweep runs on the serve kernels, so --backend "
                        "applies only to the speculation-free path")
    p.add_argument("--no-reduce-colors", action="store_true",
                   help="disable the top-class recolor post-pass "
                        "(ops.reduce_colors)")
    p.add_argument("--attempts-per-dispatch", type=str, default=None,
                   metavar="A|auto",
                   help="chain up to A attempts of the minimal-k loop on the "
                        "card per block, the stopping rule, the ring resume "
                        "and the best row kept there (ell-compact); 'auto' "
                        "prices A off the expected attempt count; 1/unset "
                        "is the sequential driver; results are the same at "
                        "any A")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="checkpoint/resume directory (a completed "
                        "checkpoint short-circuits the run)")
    p.add_argument("--checkpoint-write-behind", action="store_true",
                   help="write checkpoints from a background thread (newest "
                        "snapshot wins), flushed before exit; the files are "
                        "the synchronous manager's")
    p.add_argument("--compat-failed-output", action="store_true",
                   help="reproduce the reference's quirk of saving the "
                        "failed attempt's partial coloring")
    p.add_argument("--sim-variant", choices=["optimized", "baseline"],
                   default="optimized",
                   help="reference-sim backend: which reference engine's "
                        "semantics")
    p.add_argument("--log-json", type=str, default=None,
                   help="append the structured JSONL event stream here")
    p.add_argument("--run-manifest", type=str, default=None,
                   help="write the run manifest JSON here (attempts with "
                        "their in-kernel superstep trajectories, phases, "
                        "metrics)")
    p.add_argument("--metrics-prom", type=str, default=None,
                   help="write the run's metrics in Prometheus text format")
    p.add_argument("--superstep-timing", action="store_true",
                   help="with --run-manifest/--metrics-prom: record each "
                        "superstep's timestamp in the trajectory "
                        "(ell-compact; the card's clock)")
    return p


def parse_attempts_per_dispatch(value: str | None) -> int | str:
    """``--attempts-per-dispatch``: 1 when unset, a positive int, or
    ``"auto"``; anything else raises ``ValueError`` with the JAX CLI's
    message."""
    if not value:
        return 1
    if value == "auto":
        return value
    try:
        a = int(value)
    except ValueError:
        a = 0
    if a < 1:
        raise ValueError(f"--attempts-per-dispatch must be a positive integer "
                         f"or 'auto', got {value!r}")
    return a


def parse_speculate_k(value: str | None) -> int | str | None:
    """``--speculate-k``: None when unset, a positive int, or ``"auto"``;
    anything else raises ``ValueError`` with the JAX CLI's message."""
    if value is None or value == "auto":
        return value
    try:
        depth = int(value)
    except ValueError:
        depth = 0
    if depth < 1:
        raise ValueError(f"--speculate-k must be a positive integer or "
                         f"'auto', got {value!r}")
    return depth


def speculation_depth(args, graph: Graph) -> int | None:
    """The speculative window's depth the arguments ask for on ``graph``
    (None: no speculation)."""
    depth = parse_speculate_k(getattr(args, "speculate_k", None))
    if depth == "auto":
        from dgc_tpu_torch.utils.schedule_model import speculation_auto_cap

        return speculation_auto_cap(graph.initial_k())
    return depth


def attempts_per_dispatch(args, graph: Graph) -> int:
    """The block size the arguments ask for on ``graph``."""
    a = parse_attempts_per_dispatch(getattr(args, "attempts_per_dispatch",
                                            None))
    if a == "auto":
        from dgc_tpu_torch.utils.schedule_model import \
            auto_attempts_per_dispatch

        return auto_attempts_per_dispatch(graph.initial_k(),
                                          overhead_s=ATTEMPT_HOST_COST_S)
    return a


def make_checkpoint(args, graph: Graph):
    """The checkpoint manager ``--checkpoint-dir`` names, or None."""
    if not getattr(args, "checkpoint_dir", None):
        return None
    from dgc_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                WriteBehindCheckpointManager,
                                                graph_fingerprint)

    cls = (WriteBehindCheckpointManager if args.checkpoint_write_behind
           else CheckpointManager)
    return cls(args.checkpoint_dir,
               fingerprint=graph_fingerprint(graph.arrays, args.backend,
                                             args.strict_decrement))


def load_graph(args) -> Graph:
    """The graph the arguments name: loaded and checked, or generated.
    Raises ``OSError``/``ValueError``/``KeyError`` on a bad input file."""
    if args.input is not None:
        graph = Graph.deserialize(args.input)
        problems = graph.arrays.validate()
        if problems:
            raise ValueError("; ".join(f"[{p['code']}] {p['message']}"
                                       for p in problems))
        return graph
    graph = Graph.generate(args.node_count, args.max_degree, seed=args.seed,
                           method=args.gen_method)
    if args.output_graph:
        graph.serialize(args.output_graph)
    return graph


def make_engine(args, graph: Graph):
    """The engine ``--backend`` names (the host backends ignore
    ``--device``: they are NumPy)."""
    if args.backend == "dense":
        from dgc_tpu_torch.engine.dense_engine import DenseEngine

        return DenseEngine(graph.arrays, device=args.device)
    if args.backend == "reference-sim":
        from dgc_tpu_torch.engine.reference_sim import ReferenceSimEngine

        return ReferenceSimEngine(graph.arrays, variant=args.sim_variant)
    if args.backend == "oracle":
        from dgc_tpu_torch.engine.oracle import OracleEngine

        return OracleEngine(graph.arrays)
    if args.backend == "sharded":
        from dgc_tpu_torch.engine.sharded import ShardedELLEngine

        return ShardedELLEngine(graph.arrays, num_shards=args.shards,
                                device=args.device)
    if args.backend == "sharded-bucketed":
        from dgc_tpu_torch.engine.sharded_bucketed import \
            ShardedBucketedEngine

        return ShardedBucketedEngine(graph.arrays, num_shards=args.shards,
                                     device=args.device)
    if args.backend == "sharded-ring":
        from dgc_tpu_torch.engine.ring import RingHaloEngine

        return RingHaloEngine(graph.arrays, num_shards=args.shards,
                              device=args.device)
    if args.backend == "ell":
        from dgc_tpu_torch.engine.superstep import ELLEngine

        return ELLEngine(graph.arrays, device=args.device)
    if args.backend == "ell-compact":
        from dgc_tpu_torch.engine.compact import CompactFrontierEngine

        return CompactFrontierEngine(graph.arrays, device=args.device)
    from dgc_tpu_torch.engine.bucketed import BucketedELLEngine

    return BucketedELLEngine(graph.arrays, device=args.device)


def _print_attempt(res, val) -> None:
    fields = [f"k={res.k}", f"status={res.status.name}",
              f"supersteps={res.supersteps}"]
    if res.success:
        fields.append(f"colors_used={res.colors_used}")
    if val is not None:
        fields.append(f"valid={val.valid}")
    print("attempt: " + " ".join(fields))


def sweep(args, graph: Graph, engine, checkpoint=None, on_attempt=None,
          on_block=None) -> MinimalColoringResult:
    """The minimal-k sweep the arguments ask for on ``engine`` (blocked at
    ``--attempts-per-dispatch``), with validation, the post-pass and
    ``checkpoint``; ``on_attempt(res, val)`` (default: the console line)
    and ``on_block(k, attempts)`` as ``find_minimal_coloring`` takes
    them."""
    return find_minimal_coloring(
        engine,
        initial_k=graph.initial_k(),
        strict_decrement=args.strict_decrement,
        validate=make_validator(graph.arrays),
        on_attempt=on_attempt if on_attempt is not None else _print_attempt,
        checkpoint=checkpoint,
        post_reduce=(None if args.no_reduce_colors
                     or args.backend in HOST_BACKENDS
                     else make_reducer(graph.arrays)),
        attempts_per_dispatch=attempts_per_dispatch(args, graph),
        on_block=on_block,
    )


def speculative_sweep(args, graph: Graph, depth: int, on_attempt, logger,
                      phases) -> MinimalColoringResult | None:
    """The sweep through a one-request serve pool with the speculative
    minimal-k driver (``serve.speculate``): sibling lanes of the batched
    serve kernels run the next ``depth`` budgets' attempts while the driver
    consumes the current one. None when the graph is beyond the serve
    shape ladder (the caller then takes the normal path)."""
    from dgc_tpu_torch.serve.engine import BatchScheduler
    from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER, pad_member
    from dgc_tpu_torch.serve.speculate import SpeculativeMinimalKEngine

    cls = DEFAULT_LADDER.class_for(graph.num_vertices, graph.max_degree)
    if cls is None:
        print("# --speculate-k: graph beyond the serve shape ladder; "
              "running the speculation-free path", file=sys.stderr)
        return None
    if not args.strict_decrement:
        print("# --speculate-k: jump mode fuses find+confirm (nothing "
              "to speculate); add --strict-decrement for the "
              "parallel-window win", file=sys.stderr)
    if args.checkpoint_dir:
        print("# --speculate-k: checkpointing does not apply to the "
              "serve-pool route; running without", file=sys.stderr)
    with phases.section("host_engine_build"):
        # one lane for the driver's own claims and `depth` sibling lanes;
        # the carry stays on the device, so a reseat uploads one lane's
        # table, not the pool's
        sched = BatchScheduler(
            batch_max=depth + 1, mode="continuous", device=args.device,
            device_carry=True,
            on_event=lambda kind, rec: logger.event(kind, **rec))
        sched.start()
        engine = SpeculativeMinimalKEngine(pad_member(graph.arrays, cls),
                                           sched, depth=depth)
    try:
        with phases.section("sweep_total"):
            return find_minimal_coloring(
                engine, initial_k=graph.initial_k(),
                strict_decrement=args.strict_decrement,
                validate=make_validator(graph.arrays), on_attempt=on_attempt,
                post_reduce=(None if args.no_reduce_colors
                             else make_reducer(graph.arrays)))
    finally:
        engine.close()
        sched.stop()


def write_obs_outputs(args, logger, manifest, phases, registry) -> None:
    """Write the manifest and the metrics files the arguments name."""
    if args.run_manifest:
        manifest.finalize(phases=phases, registry=registry)
        manifest.write(args.run_manifest)
        logger.event("manifest_written", path=args.run_manifest)
    if args.metrics_prom:
        registry.write_prom(args.metrics_prom)
        logger.event("metrics_written", path=args.metrics_prom)


def main(argv: list[str] | None = None) -> int:
    # the serve subcommand (dgc_tpu_torch.serve.cli), dispatched before
    # the sweep parser as in dgc_tpu.cli
    raw = sys.argv[1:] if argv is None else argv
    if raw and raw[0] == "serve":
        from dgc_tpu_torch.serve.cli import serve_main

        return serve_main(list(raw[1:]))
    t_start = time.perf_counter()
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.reshard_on_loss:  # exits 2 with the note, as argparse refuses
        parser.error("--reshard-on-loss: not yet ported to dgc_tpu_torch "
                     "(see ROADMAP.md)")
    if args.input is None and (args.node_count is None or args.max_degree is None):
        print("Either --input or both --node-count and --max-degree are required",
              file=sys.stderr)
        return 2
    try:
        parse_attempts_per_dispatch(args.attempts_per_dispatch)
        parse_speculate_k(args.speculate_k)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    if args.speculate_k is not None and \
            parse_attempts_per_dispatch(args.attempts_per_dispatch) != 1:
        # the speculative engine has no attempt block
        print("# --attempts-per-dispatch ignored with --speculate-k: the "
              "speculation pool dispatches attempts individually",
              file=sys.stderr)
        args.attempts_per_dispatch = None
    try:
        resolve_device(args.device)
    except RuntimeError as e:  # a card asked for where there is none
        print(f"Cannot run on --device {args.device}: {e}", file=sys.stderr)
        return 2
    # the event stream goes to --log-json only; the console keeps the
    # port's own lines
    logger = RunLogger(jsonl_path=args.log_json, echo=False)
    try:
        return _run(args, logger, t_start)
    finally:
        logger.close()


def _engine_sweep(args, graph: Graph, on_attempt, logger, phases,
                  registry) -> MinimalColoringResult:
    """The sweep on the engine ``--backend`` names, with the checkpoint and
    the telemetry the arguments ask for."""
    checkpoint = make_checkpoint(args, graph)
    try:
        if args.backend in SHARDED_BACKENDS:
            # the process group before any device work: no-op in a plain
            # run, every rank of the launcher's group under torchrun
            from dgc_tpu_torch.parallel.multihost import (initialize_multihost,
                                                          process_info)

            multi = initialize_multihost(args.device)
            logger.event("distributed", multi_process=multi, **process_info())
        if args.backend not in HOST_BACKENDS:
            logger.event("devices", **(
                dict(count=torch.cuda.device_count(), platform="gpu",
                     device_kind=torch.cuda.get_device_name(0))
                if args.device == "cuda" else
                dict(count=1, platform="cpu", device_kind="cpu")))
        with phases.section("host_engine_build"):
            engine = make_engine(args, graph)
        # the manifest or the metrics file switches the trajectories on,
        # and then --superstep-timing the clock, where the engine has one
        telemetry = bool(args.run_manifest or args.metrics_prom)
        if args.superstep_timing and telemetry \
                and hasattr(engine, "record_timing"):
            engine.record_timing = True
        engine = ObservedEngine(engine, phases=phases, registry=registry,
                                record_trajectory=telemetry)
        with phases.section("sweep_total"):
            return sweep(args, graph, engine, checkpoint,
                         on_attempt=on_attempt,
                         on_block=lambda k, a: logger.event(
                             "attempt_block", k=int(k), attempts=int(a)))
    finally:
        close = getattr(checkpoint, "close", None)  # write-behind: flush
        if close is not None:
            close()


def _run(args, logger, t_start: float) -> int:
    registry = MetricsRegistry()
    phases = PhaseCollector(logger=logger, registry=registry)
    manifest = RunManifest()
    logger.add_sink(manifest)
    with phases.section("host_graph"):
        try:
            graph = load_graph(args)
        except (OSError, ValueError, KeyError) as e:
            print(f"Failed to load graph from {args.input}: {e}",
                  file=sys.stderr)
            return 2
    if args.input is not None:
        logger.event("graph_loaded", path=args.input,
                     vertices=graph.num_vertices, max_degree=graph.max_degree)
    else:
        logger.event("graph_generated", vertices=graph.num_vertices,
                     max_degree=graph.max_degree, method=args.gen_method,
                     seed=args.seed)
        if args.output_graph:
            logger.event("graph_saved", path=args.output_graph)
    k0 = graph.initial_k()
    logger.event("sweep_start", backend=args.backend, initial_k=k0,
                 strict_decrement=args.strict_decrement)

    def on_attempt(res, val):
        _print_attempt(res, val)
        logger.attempt(res, val)

    depth = speculation_depth(args, graph)
    result = (None if depth is None else
              speculative_sweep(args, graph, depth, on_attempt, logger,
                                phases))
    if result is None:
        result = _engine_sweep(args, graph, on_attempt, logger, phases,
                               registry)
    phases.log_device_memory()
    if result.minimal_colors is not None and result.swept_colors is not None \
            and result.minimal_colors < result.swept_colors:
        logger.event("post_reduce", from_colors=result.swept_colors,
                     to_colors=result.minimal_colors,
                     time_s=round(result.post_reduce_s, 4))
    total_s = time.perf_counter() - t_start
    if result.colors is None:
        logger.event("sweep_failed", initial_k=k0)
        write_obs_outputs(args, logger, manifest, phases, registry)
        print("No valid coloring found", file=sys.stderr)
        return 1
    with phases.section("host_serialize"):
        out_colors = result.colors
        if args.compat_failed_output and result.attempts \
                and not result.attempts[-1].success:
            out_colors = result.attempts[-1].colors  # the reference's quirk
        graph.save_coloring(args.output_coloring, out_colors)
    logger.event("sweep_done", minimal_colors=result.minimal_colors,
                 attempts=len(result.attempts),
                 supersteps=result.total_supersteps,
                 wall_time_s=round(total_s, 4))
    registry.gauge("dgc_minimal_colors",
                   "final minimal color count").set(result.minimal_colors)
    registry.gauge("dgc_sweep_wall_seconds",
                   "wall time of the whole run").set(round(total_s, 4))
    write_obs_outputs(args, logger, manifest, phases, registry)
    print(f"Minimal number of colors: {result.minimal_colors}")
    print(f"Total time: {total_s:.4f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
