"""The port's command-line entry point — the core of ``dgc_tpu.cli``.

Keeps the reference's flags and mutual-requirement validation: ``--input``
*or* (``--node-count`` + ``--max-degree``), optional ``--output-graph``,
required ``--output-coloring``, in the reference's JSON schemas; the saved
coloring is the last *valid* one. Adds the engine (``--backend``) and the
device (``--device``, default ``cuda``).

    python -m dgc_tpu_torch --node-count 1000 --max-degree 10 --seed 42 \\
        --output-coloring colors.json [--backend ell-compact] [--device cpu]

Exit codes: 0 success, 1 no valid coloring, 2 usage or load error (a
missing card for ``--device cuda`` included).
"""

from __future__ import annotations

import argparse
import sys
import time

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.minimal_k import (MinimalColoringResult,
                                            find_minimal_coloring,
                                            make_reducer, make_validator)
from dgc_tpu_torch.models.graph import Graph

BACKENDS = ("ell-compact", "ell-bucketed", "ell")


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
    p.add_argument("--backend", choices=list(BACKENDS), default="ell-compact",
                   help="coloring engine (default: ell-compact, the staged "
                        "frontier-compacted engine)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs (default: cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--strict-decrement", action="store_true",
                   help="decrement k one-by-one like the reference instead "
                        "of jumping to colors_used-1")
    p.add_argument("--no-reduce-colors", action="store_true",
                   help="disable the top-class recolor post-pass "
                        "(ops.reduce_colors)")
    return p


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
    """The engine ``--backend`` names."""
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


def sweep(args, graph: Graph, engine) -> MinimalColoringResult:
    """The minimal-k sweep the arguments ask for on ``engine``, with
    validation and the post-pass."""
    return find_minimal_coloring(
        engine,
        initial_k=graph.initial_k(),
        strict_decrement=args.strict_decrement,
        validate=make_validator(graph.arrays),
        on_attempt=_print_attempt,
        post_reduce=None if args.no_reduce_colors else make_reducer(graph.arrays),
    )


def main(argv: list[str] | None = None) -> int:
    t_start = time.perf_counter()
    args = build_parser().parse_args(argv)
    if args.input is None and (args.node_count is None or args.max_degree is None):
        print("Either --input or both --node-count and --max-degree are required",
              file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)
    except RuntimeError as e:  # a card asked for where there is none
        print(f"Cannot run on --device {args.device}: {e}", file=sys.stderr)
        return 2
    try:
        graph = load_graph(args)
    except (OSError, ValueError, KeyError) as e:
        print(f"Failed to load graph from {args.input}: {e}", file=sys.stderr)
        return 2
    result = sweep(args, graph, make_engine(args, graph))
    total_s = time.perf_counter() - t_start
    if result.colors is None:
        print("No valid coloring found", file=sys.stderr)
        return 1
    graph.save_coloring(args.output_coloring, result.colors)
    print(f"Minimal number of colors: {result.minimal_colors}")
    print(f"Total time: {total_s:.4f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
