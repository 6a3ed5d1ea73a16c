"""Structured run logging with reference-parity console output.

The reference prints per-superstep uncolored counts, per-k-iteration wall
times, validation results, and final totals (``coloring.py:89,222-224,
233-235``). ``RunLogger`` emits the same human-readable lines *and* an
optional machine-readable JSONL stream (one event object per line) — the
event half of the ``dgc_tpu.obs`` telemetry subsystem.

Schema contract: every JSONL record is ``{"t": float, "event": str,
**fields}``; field sets per event kind live in ``obs.schema`` and are
enforced by ``tools/validate_runlog.py``. ``None``-valued fields stay in
the JSONL as JSON ``null`` (fixed schema, machine-parseable) but are
dropped from the console line (``colors_used=None`` is noise to a human).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class RunLogger:
    def __init__(self, jsonl_path: str | None = None, stream=None, echo: bool = True):
        self.stream = stream if stream is not None else sys.stdout
        self.echo = echo
        self._jsonl = None
        self._sinks = []
        if jsonl_path:
            parent = Path(jsonl_path).parent
            if str(parent) not in ("", "."):
                parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._t0 = time.perf_counter()

    def add_sink(self, sink) -> None:
        """Register ``sink(record: dict)`` to observe every event (the run
        manifest builds itself from the same stream the JSONL gets)."""
        self._sinks.append(sink)

    def event(self, kind: str, **fields) -> None:
        record = {"t": round(time.perf_counter() - self._t0, 6), "event": kind, **fields}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        for sink in self._sinks:
            sink(record)
        if self.echo:
            # console drops None-valued fields; the JSONL keeps them as null
            pretty = " ".join(f"{k}={v}" for k, v in fields.items() if v is not None)
            print(f"[{record['t']:10.4f}s] {kind}: {pretty}", file=self.stream)

    def attempt(self, res, val=None) -> None:
        """Per-k-iteration line (reference prints elapsed time and validity
        per outer iteration, ``coloring.py:222-224``)."""
        fields = dict(
            k=res.k,
            status=res.status.name,
            supersteps=res.supersteps,
            colors_used=res.colors_used if res.success else None,
        )
        if val is not None:
            fields["valid"] = val.valid
            fields["uncolored"] = val.uncolored
            fields["conflicts"] = val.conflicts
        self.event("attempt", **fields)
        traj = getattr(res, "trajectory", None)
        if traj is not None:
            self.event("trajectory", k=res.k, **traj.to_dict())

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
