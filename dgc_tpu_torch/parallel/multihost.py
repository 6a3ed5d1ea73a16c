"""Multi-process initialization for the sharded engines (port of
``dgc_tpu.parallel.multihost``).

``torchrun`` starts one process per rank and sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``;
``initialize_multihost`` turns that into the default process group before
any device work, and the vertex mesh (``parallel.mesh.make_mesh``) then
spans every rank, with no change to the engines:

- every rank runs the same program: the same superstep loop, the same
  collectives in the same order;
- the graph tables are built identically on every rank from the same
  seed or input file (deterministic table builds), and each rank keeps its
  own block;
- the only decisions (the superstep loop's end, the ring pushes, the
  minimal-k schedule, the window retry) are taken from values reduced
  over the ranks, so control flow cannot diverge.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dgc_tpu_torch.parallel.mesh import init_group, local_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_multihost(device="cuda") -> bool:
    """Initialize the default process group from ``torchrun``'s
    environment if it is set (and no group exists yet); returns True iff
    running multi-process. Without the environment it is a no-op, so the
    CLI can call it unconditionally; it must run before any device work."""
    if not dist.is_initialized():
        if not all(os.environ.get(name) for name in _ENV):
            return False  # plain single-process run
        dev = local_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_group(init_method="env://")
    return dist.get_world_size() > 1


def process_info() -> dict:
    """Topology summary for logs: each rank is one process with one
    device of the mesh."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if up else 1,
    }
