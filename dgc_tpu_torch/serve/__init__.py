"""Batched multi-graph serving path (port of ``dgc_tpu.serve``): request
graphs of many small and medium sizes colored B at a time on the card,
or over a lane mesh of shard slots (``--mesh-devices``).

- :mod:`~dgc_tpu_torch.serve.shape_classes` — pad request graphs onto a
  geometric ladder of ``(V_pad, W_pad)`` classes (``dgc_tpu``'s file,
  verbatim but for the package name);
- :mod:`~dgc_tpu_torch.serve.batched` — the batched fused jump-mode sweep
  over the four serve kernels (``kernels.serve``, ``csrc/serve.cu``), as
  one batch-complete sweep (sync mode) or bounded superstep slices whose
  carry stays on the card (continuous mode), with the staged frontier
  ladder, the speculation plane's spec/cancel vectors, and the
  device-resident carry's seat, permute and resize (``kernels.carry``,
  ``csrc/carry.cu``); the lane mesh and the ``_sharded`` twins;
- :mod:`~dgc_tpu_torch.serve.engine` — the sweep scheduler: lane
  recycling, affinity batching, the sync baseline, class warmup, the
  host-mirror and device-resident carries, the speculation plane, the
  lane mesh and its failure-domain plane;
- :mod:`~dgc_tpu_torch.serve.speculate` — speculative minimal-k: the
  strict chain's next budgets in sibling lanes (``dgc_tpu``'s file,
  verbatim but for the package name);
- :mod:`~dgc_tpu_torch.serve.queue` — the micro-batching front-end
  (bounded queue, workers, latency, health fed by the resilience
  supervisor's rung state);
- :mod:`~dgc_tpu_torch.serve.cli` — ``python -m dgc_tpu_torch serve``,
  the request-replay CLI.

Not ported yet (ROADMAP): the network front door, the result cache, the
fleet and the journal.
"""

from dgc_tpu_torch.serve.shape_classes import (  # noqa: F401
    DEFAULT_LADDER,
    ShapeClass,
    ShapeLadder,
    pad_member,
)
from dgc_tpu_torch.serve.engine import BatchScheduler, ServeError  # noqa: F401
from dgc_tpu_torch.serve.queue import (  # noqa: F401
    QueueFull,
    ServeFrontEnd,
    ServeRequest,
    ServeResult,
)
