"""The clock of the trajectory buffer's timing column (``obs.kernel`` col 5).

On the card the row-writing kernel reads its own clock: ``%globaltimer``
(nanoseconds), divided by 1000 and masked with ``US_MASK``
(``csrc/traj.cuh``), in the thread that writes the row, after the
superstep's counts are folded. The plain versions read the host clock
instead (``kernel_clock_us``): after a ``torch.cuda.synchronize`` for a
tensor on the card, directly on the CPU. The two clocks have different
origins; only differences between consecutive rows (``step_us``) mean
anything.

Timestamps are 31-bit microseconds (non-negative int32, wrapping every
~35.8 min); ``wrap_delta_us`` recovers deltas across the wrap.
"""

from __future__ import annotations

import time

from dgc_tpu_torch.layout import US_MASK


def host_clock_us() -> int:
    """Masked monotonic microseconds on the host clock."""
    return (time.perf_counter_ns() // 1000) & US_MASK


def wrap_delta_us(t0, t1):
    """Wrap-safe ``t1 − t0`` for masked timestamps (works elementwise on
    numpy arrays)."""
    return (t1 - t0) & US_MASK


def kernel_clock_us(device) -> int:
    """The plain versions' timestamp of a superstep boundary on ``device``:
    the host clock once the work queued there has finished."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return host_clock_us()
