"""dgc_tpu_torch — the PyTorch/CUDA port of ``dgc_tpu`` for one NVIDIA H100.

It mirrors ``dgc_tpu``'s layout (``models/``, ``ops/``, ``engine/``,
``cli.py``) and imports nothing of it, nor JAX: it keeps its own copies of
the host modules it needs. Device work is hand-written CUDA
(``csrc/``, built at first use by ``kernels.build``); the plain PyTorch
versions in ``ops/`` are what the kernels are held against, and what runs
when a caller passes ``device="cpu"``. Every engine and entry point takes
an explicit ``device`` and defaults to ``cuda``.

Ported so far: the minimal-k sweep (sequential, fused and blocked, with
checkpoints) on the ``ell``, ``ell-bucketed``, ``ell-compact`` and
``dense`` engines, the host backends ``oracle`` and ``reference-sim``,
the native host paths (``native/``: the C++ generators, relabel, table
build and post-pass walks), and the batched serve tier (``serve/``, the
``serve`` subcommand). ROADMAP lists the rest.
"""
