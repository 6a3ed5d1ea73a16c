"""Run manifest: one JSON document summarizing a whole run.

The machine-readable artifact the reference never produces (its outputs
are a coloring JSON and stdout prints): graph provenance, backend, device
topology, per-attempt results **with their in-kernel superstep
trajectories**, the host-phase timing breakdown (compile/device/host),
metrics snapshot, and the final color count. Built incrementally as a
``RunLogger`` sink — the manifest and the JSONL stream can never disagree
because they observe the same events.

``tools/report_run.py`` renders a manifest (or a raw JSONL log) into a
human-readable sweep report.
"""

from __future__ import annotations

import json
from pathlib import Path

MANIFEST_VERSION = 1

# events folded into the manifest by copying their fields verbatim
_INFO_EVENTS = {
    "graph_loaded": "graph",
    "graph_generated": "graph",
    "devices": "devices",
    "distributed": "distributed",
    "sweep_start": "sweep",
    "tuned_config": "tuning",
}


class RunManifest:
    """Incremental manifest builder; register with ``RunLogger.add_sink``."""

    def __init__(self):
        self.doc: dict = {
            "manifest_version": MANIFEST_VERSION,
            "graph": None,
            "devices": None,
            "distributed": None,
            "sweep": None,
            "tuning": None,
            "attempts": [],
            "phases": None,
            "device_memory": [],
            "aborts": [],
            "resilience": {"faults": [], "retries": [], "fallbacks": [],
                           "resumes": []},
            "result": None,
            "metrics": None,
        }

    # -- RunLogger sink -------------------------------------------------
    def __call__(self, record: dict) -> None:
        kind = record.get("event")
        fields = {k: v for k, v in record.items() if k not in ("t", "event")}
        slot = _INFO_EVENTS.get(kind)
        if slot is not None:
            self.doc[slot] = fields
        elif kind == "attempt":
            self.doc["attempts"].append(dict(fields, trajectory=None))
        elif kind == "trajectory":
            # attach to the most recent attempt with a matching k
            for att in reversed(self.doc["attempts"]):
                if att.get("k") == fields.get("k") and att["trajectory"] is None:
                    att["trajectory"] = {
                        k: v for k, v in fields.items() if k != "k"}
                    break
        elif kind == "device_memory":
            self.doc["device_memory"].append(fields)
        elif kind in ("watchdog_abort", "structured_abort"):
            self.doc["aborts"].append(dict(fields, event=kind))
        elif kind == "fault_injected":
            self.doc["resilience"]["faults"].append(fields)
        elif kind == "retry":
            self.doc["resilience"]["retries"].append(fields)
        elif kind == "fallback":
            self.doc["resilience"]["fallbacks"].append(fields)
        elif kind == "checkpoint_resume":
            self.doc["resilience"]["resumes"].append(fields)
        elif kind == "post_reduce":
            self.doc["post_reduce"] = fields
        # diagnose-after-the-fact layer (PR 11): flight-recorder dumps,
        # profiler-window artifacts, the timing cross-check verdict, and
        # perf-ledger verdicts — slots appear only when the events do,
        # so prior manifests stay byte-identical
        elif kind == "flightrec_dump":
            self.doc.setdefault("flightrec", []).append(fields)
        elif kind == "profile_window":
            self.doc.setdefault("profiles", []).append(fields)
        elif kind == "timing_crosscheck":
            self.doc["timing_crosscheck"] = fields
        elif kind == "perf_regression":
            self.doc.setdefault("perf", []).append(fields)
        elif kind in ("sweep_done", "sweep_failed"):
            self.doc["result"] = dict(fields, event=kind)
        # network front door (serve.netfront, PR 12): per-tenant
        # admit/reject AGGREGATES (a soak emits thousands of decisions —
        # the manifest keeps counts, the JSONL keeps every event) plus
        # the drain record; the slot appears only when net_* events do
        elif kind in ("net_admit", "net_reject", "net_drain",
                      "net_recover", "net_cache"):
            nf = self.doc.setdefault("netfront",
                                     {"tenants": {}, "drain": None})
            if kind == "net_cache":
                # content-addressed result cache: per-request outcomes
                # aggregate to action counts (hit/miss/coalesced/store/
                # promote) — the slot key appears only when the cache
                # is on, so cache-off manifests stay byte-identical
                counts = nf.setdefault("cache", {})
                act = fields.get("action", "?")
                counts[act] = counts.get(act, 0) + 1
            elif kind == "net_recover":
                # journal recovery: per-ticket actions aggregate to
                # counts, the summary record lands whole (the crash-safe
                # serve tier's restart provenance)
                if fields.get("action") == "summary":
                    nf["recover"] = fields
                else:
                    counts = nf.setdefault(
                        "recover_actions",
                        {"restored": 0, "replayed": 0, "replay_failed": 0})
                    act = fields.get("action", "?")
                    counts[act] = counts.get(act, 0) + 1
            elif kind == "net_drain":
                nf["drain"] = fields
            else:
                t = nf["tenants"].setdefault(
                    fields.get("tenant", "?"),
                    {"admitted": 0, "rejected": {}})
                if kind == "net_admit":
                    t["admitted"] += 1
                else:
                    reason = fields.get("reason", "?")
                    t["rejected"][reason] = t["rejected"].get(reason, 0) + 1
        elif (kind.startswith("serve_")
              or kind in ("lane_recycled", "slice_recalibrated",
                          "lane_rebuild", "mesh_degrade",
                          "mesh_restore", "spec_seated", "spec_win",
                          "spec_cancelled")):
            # serving path (dgc_tpu.serve) — the slot appears only when
            # serve events do, so non-serve manifests stay byte-identical
            serve = self.doc.setdefault(
                "serve", {"config": None, "batches": [], "slices": [],
                          "recycles": 0, "requests": [], "warmup": None,
                          "health": None, "summary": None})
            if kind == "serve_start":
                serve["config"] = fields
            elif kind == "serve_batch":
                serve["batches"].append(fields)
            elif kind == "serve_slice":
                # lane-recycling occupancy series (continuous mode) —
                # tools/report_run.py renders it over time
                serve["slices"].append(fields)
            elif kind == "lane_recycled":
                serve["recycles"] += 1
            elif kind == "slice_recalibrated":
                # measured slice-size re-pricing (timing mode)
                serve.setdefault("recalibrations", []).append(fields)
            elif kind == "lane_rebuild":
                # fault-plane recoveries (dispatch abort / watchdog
                # hang): the serve tier's resilience provenance
                serve.setdefault("rebuilds", []).append(fields)
            elif kind in ("mesh_degrade", "mesh_restore"):
                # failure-domain plane: every mesh reshape with its
                # direction — the degraded tier's restart provenance
                serve.setdefault("mesh_events", []).append(
                    dict(fields, event=kind))
            elif kind in ("spec_seated", "spec_win", "spec_cancelled"):
                # speculative minimal-k plane: per-attempt events
                # aggregate to counts (a deep sweep seats dozens) — the
                # slot key appears only when speculation is armed, so
                # speculation-off manifests stay byte-identical
                spec = serve.setdefault(
                    "speculation", {"seated": 0, "wins": 0,
                                    "claims_ready": 0, "cancelled": {},
                                    "wasted_steps": 0})
                if kind == "spec_seated":
                    spec["seated"] += 1
                elif kind == "spec_win":
                    spec["wins"] += 1
                    if fields.get("ready"):
                        spec["claims_ready"] += 1
                else:
                    where = fields.get("where", "?")
                    spec["cancelled"][where] = (
                        spec["cancelled"].get(where, 0) + 1)
                    spec["wasted_steps"] += int(
                        fields.get("wasted_steps", 0) or 0)
            elif kind == "serve_warmup":
                serve["warmup"] = fields
            elif kind == "serve_request":
                serve["requests"].append(fields)
            elif kind == "serve_health":
                serve["health"] = fields
            elif kind in ("serve_done", "serve_summary"):
                serve["summary"] = dict(serve["summary"] or {}, **fields)

    # -- finalization ---------------------------------------------------
    def finalize(self, phases=None, registry=None) -> dict:
        if phases is not None:
            self.doc["phases"] = phases.snapshot()
        if registry is not None:
            self.doc["metrics"] = registry.to_dict()
        return self.doc

    def write(self, path: str) -> None:
        p = Path(path)
        if str(p.parent) not in ("", "."):
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.doc, indent=2, sort_keys=False) + "\n")


def load_manifest(path: str) -> dict:
    doc = json.loads(Path(path).read_text())
    if not isinstance(doc, dict) or "manifest_version" not in doc:
        raise ValueError(f"{path}: not a dgc_tpu run manifest")
    return doc
