"""Machine-checkable schema of the JSONL run-log event stream.

One entry per event kind: required fields (name → allowed types) and
optional fields. ``tools/validate_runlog.py`` enforces this file against a
log and exits nonzero on unknown kinds, unknown fields, missing required
fields, or wrong types — so the schema cannot drift silently: adding an
event or a field means adding it HERE (and the obs tests run the validator
over every log they produce).

Types use a small vocabulary: ``int``, ``float`` (accepts int), ``str``,
``bool``, ``list``, ``dict``, ``null`` (None). A tuple means any-of.
"""

from __future__ import annotations

NUM = ("int", "float")

# event kind -> (required: {field: types}, optional: {field: types})
EVENT_SCHEMAS: dict = {
    "graph_loaded": (
        {"path": "str", "vertices": "int", "max_degree": "int"}, {}),
    "graph_generated": (
        {"vertices": "int", "max_degree": "int", "method": "str",
         "seed": ("int", "null")}, {}),
    "graph_saved": ({"path": "str"}, {}),
    "distributed": (
        {"multi_process": "bool"},
        {"process_index": "int", "process_count": "int",
         "local_devices": "int", "global_devices": "int"}),
    "devices": (
        {"count": "int", "platform": "str", "device_kind": "str"},
        {"memory_stats": ("dict", "null")}),
    "sweep_start": (
        {"backend": "str", "initial_k": "int", "strict_decrement": "bool"},
        {}),
    # schedule auto-tuner (dgc_tpu.tune): which tuned config produced the
    # engine schedule — lands in the manifest's "tuning" slot
    "tuned_config": (
        {"source": "str", "knobs": "dict", "backend_applies": "bool"},
        {"path": ("str", "null"), "graph_shape_hash": ("str", "null"),
         "hash_match": "bool", "win_total_pct": (*NUM, "null")}),
    "attempt": (
        {"k": "int", "status": "str", "supersteps": "int",
         "colors_used": ("int", "null")},
        {"valid": "bool", "uncolored": "int", "conflicts": "int"}),
    # device-resident minimal-k: one event per attempt-block dispatch,
    # BEFORE the kernel is issued — the flight recorder's in-flight
    # span marker (a hang inside the block dumps with this as the last
    # engine-facing event, bracketing budgets k .. k-attempts+1)
    "attempt_block": ({"k": "int", "attempts": "int"}, {}),
    "trajectory": (
        {"k": "int", "active": "list", "fail": "list", "mc": "list",
         "first_step": "int", "truncated": "bool"},
        {"bucket_active": "list", "gather_calls": "list",
         "max_unconf": "list", "max_unconf_bucket": "list",
         "step_us": "list"}),
    # request-scoped tracing (obs.trace): begin/end records of one span;
    # ``tools/validate_runlog.py`` additionally checks the structural
    # invariants (parent-before-child, every opened span closed) and
    # this schema rejects unknown span fields — per-span data lives in
    # the ``attrs`` dict, never in new top-level fields
    "span": (
        {"name": "str", "ph": "str", "trace": "str", "span": "str",
         "ts_us": "int"},
        {"parent": ("str", "null"), "attrs": ("dict", "null")}),
    "phase": (
        {"name": "str", "seconds": NUM},
        {"k": "int", "attempt_index": "int", "warm": "bool"}),
    "device_memory": (
        {"device": "str"}, {"bytes_in_use": "int", "peak_bytes_in_use": "int",
                            "bytes_limit": "int", "stats": ("dict", "null")}),
    "watchdog_abort": (
        {"what": "str", "diag": "str"}, {"timeout_s": NUM}),
    # resilience subsystem (dgc_tpu.resilience): every fault, retry,
    # fallback, resume, and structured abort flows through the same stream
    # ("fault_kind", not "kind": RunLogger.event's first positional is kind)
    "fault_injected": (
        {"point": "str", "fault_kind": "str", "occurrence": "int"},
        {"param": (*NUM, "null")}),
    "retry": (
        {"backend": "str", "k": "int", "error_class": "str", "error": "str",
         "delay_s": NUM, "budget_left": "int"}, {}),
    "fallback": (
        {"from_backend": "str", "to_backend": "str", "error_class": "str",
         "error": "str"}, {}),
    "checkpoint_resume": (
        {"backend": "str", "next_k": "int", "done": "bool"}, {}),
    "structured_abort": (
        {"reason": "str", "rc": "int"},
        {"ladder": "list", "error": ("str", "null")}),
    "graph_invalid": (
        {"path": "str", "problems": "list"}, {}),
    "post_reduce": (
        {"from_colors": "int", "to_colors": "int", "time_s": NUM}, {}),
    "sweep_done": (
        {"minimal_colors": "int", "attempts": "int", "supersteps": "int",
         "wall_time_s": NUM}, {}),
    "sweep_failed": ({"initial_k": "int"}, {}),
    "manifest_written": ({"path": "str"}, {}),
    "metrics_written": ({"path": "str"}, {}),
    # serving path (dgc_tpu.serve): micro-batching front-end lifecycle,
    # per-batch occupancy/padding accounting, per-request latency, and
    # the supervisor-rung-fed health snapshots
    "serve_start": (
        {"batch_max": "int", "window_ms": NUM, "queue_depth": "int",
         "workers": "int"},
        {"mode": "str", "slice_steps": ("int", "null"),
         "affinity": "bool", "timing": "bool", "tracing": "bool",
         # staged frontier ladder + device-resident carry (PR 9)
         "stages": "str", "device_carry": "bool",
         # multi-device serve tier (--mesh-devices): the resolved lane
         # mesh size — present ONLY when the lane axis is sharded, so
         # the unsharded event stream stays byte-identical
         "mesh_devices": "int",
         # speculative minimal-k (serve.speculate): the resolved window
         # depth — present ONLY when speculation is armed, so the
         # unarmed event stream stays byte-identical
         "speculate_k": "int"}),
    "serve_batch": (
        {"shape_class": "str", "batch": "int", "occupancy": NUM,
         "padding_waste": NUM},
        {"b_pad": "int", "compile_cache": "str", "device_ms": NUM,
         "queue_ms_max": NUM, "straggler_waste": NUM,
         "depth_buckets": "int",
         # compiled stage-branch count of the class's ladder (1 = the
         # full-table kernel; sync mode has no mid-sweep rung visibility)
         "stage_bodies": "int",
         # lane-mesh occupancy (mesh mode only): real lanes per device /
         # the device's lane count, one entry per mesh device
         "mesh_devices": "int", "device_occupancy": "list"}),
    # continuous batching (lane recycling): one serve_slice per sliced
    # kernel dispatch, one lane_recycled per completed sweep swapped out
    "serve_slice": (
        {"shape_class": "str", "live": "int", "b_pad": "int",
         "occupancy": NUM},
        {"done": "int", "admitted": "int", "slice_steps": "int",
         "compile_cache": "str", "device_ms": NUM,
         # in-kernel timing split (slice kernel timing slots): superstep
         # compute vs dispatch overhead within device_ms
         "sstep_ms": NUM, "overhead_ms": NUM,
         # stage-occupancy telemetry (CARRY_RUNG/CARRY_NC carry slots):
         # ladder rung range over live lanes, their summed frontier, and
         # frontier / gathered-slot occupancy for the slice
         "stage_min": "int", "stage_max": "int", "frontier": "int",
         "stage_occupancy": NUM,
         # per-slice host<->device transfer accounting (the
         # --device-carry A/B evidence; serve_summary totals them)
         "h2d_bytes": "int", "d2h_bytes": "int",
         # lane-mesh occupancy (mesh mode only): live lanes per device /
         # the device's lane count — the sharded tier's utilization
         "mesh_devices": "int", "device_occupancy": "list",
         # speculation plane (armed runs only): live speculative lanes
         # after the slice, speculative seats this slice, and cancelled
         # speculative lanes dropped at this boundary
         "spec_live": "int", "spec_admitted": "int",
         "spec_killed": "int"}),
    # speculative minimal-k (serve.speculate): one spec_seated per
    # speculative attempt seated into an idle lane, one spec_win per
    # attempt claimed by its driver at the budget the sequential
    # schedule reached (ready = the lane had already finished), one
    # spec_cancelled per attempt killed before its claim (reason e.g.
    # "sweep failed"/"superseded"/"preempted"/"evacuated"; where ∈
    # {"queue", "lane", "done"} — validate_runlog enforces the
    # vocabulary and wasted-superstep non-negativity)
    "spec_seated": (
        {"shape_class": "str", "lane": "int", "k": "int"}, {}),
    "spec_win": (
        {"shape_class": "str", "k": "int", "ready": "bool"}, {}),
    "spec_cancelled": (
        {"shape_class": "str", "k": "int", "reason": "str",
         "where": "str"},
        {"wasted_steps": "int"}),
    "lane_recycled": (
        {"shape_class": "str", "lane": "int"},
        {"k": "int", "depth_bucket": "int", "slices": "int",
         "queue_ms": NUM, "service_ms": NUM, "device_us": "int"}),
    # serve-tier fault recovery (crash-safe serve PR): a dispatch abort
    # or watchdog hang tore one class's lane pool down — survivors
    # reseated, poison requests quarantined (structured failure with rc
    # context). reason ∈ {"abort", "hang"} (validate_runlog enforces)
    "lane_rebuild": (
        {"shape_class": "str", "reason": "str"},
        {"reseated": "int", "quarantined": "int", "aborts_max": "int",
         "error": ("str", "null")}),
    # failure-domain plane (resilience.domains): a device loss
    # re-sharded the lane axis onto the largest surviving power-of-two
    # sub-mesh (mesh_degrade; devices_after 1 = collapsed to the
    # unsharded path), or a healthy-again mesh was rebuilt at full size
    # (mesh_restore). reseated counts the live lanes evacuated and
    # requeued; validate_runlog enforces the direction (degrade shrinks,
    # restore grows) and count non-negativity
    "mesh_degrade": (
        {"devices_before": "int", "devices_after": "int"},
        {"lost_device": ("int", "null"), "reseated": "int",
         "quarantined": "int", "error": ("str", "null")}),
    "mesh_restore": (
        {"devices_before": "int", "devices_after": "int"},
        {"reseated": "int"}),
    # slice-size recalibration from the measured overhead/compute split
    # (timing mode, slice_steps auto): once per shape class
    "slice_recalibrated": (
        {"shape_class": "str", "from_steps": "int", "to_steps": "int"},
        {"overhead_ms": NUM, "sstep_ms": NUM, "samples": "int",
         # ladder rung the pricing window sampled (post-ladder median)
         "rung": "int"}),
    # live scrape endpoint (obs.httpd) bound for this run
    "metrics_server": ({"port": "int"}, {"host": "str"}),
    # network front door (serve.netfront): one event per admission
    # decision and one per graceful drain. Semantic enforcement (reason
    # vocabulary, non-negative counts/delays) lives in
    # tools/validate_runlog.py; tools/report_run.py renders the
    # per-tenant breakdown
    "net_admit": (
        {"tenant": "str", "ticket": "str"},
        {"tier": "str", "priority": "int", "in_flight": "int",
         "v": "int",
         # cross-boundary trace propagation: the W3C trace id the caller
         # sent in ``traceparent`` — present ONLY when the request
         # carried one, so the unheadered event stream stays
         # byte-identical
         "trace": "str"}),
    # per-tenant usage metering (obs.usage): one accounting row per
    # tenant, shared by the live /admin/usage snapshot and the offline
    # journal fold of tools/usage_export.py. Semantic enforcement
    # (non-negative counts, source vocabulary, in_flight conservation)
    # lives in tools/validate_runlog.py
    "usage_rollup": (
        {"tenant": "str", "admitted": "int", "delivered": "int",
         "failed": "int", "aborted": "int"},
        {"in_flight": "int", "vertices": "int", "vertex_supersteps": "int",
         "device_ms": NUM, "queue_ms": NUM, "service_ms": NUM,
         "source": "str", "export_version": "int",
         # result-cache deliveries (the cheaper billing unit, a subset
         # of delivered/failed) — present only when nonzero, so
         # cache-off rows stay byte-identical
         "cached": "int"}),
    # content-addressed result cache + single-flight coalescing
    # (serve.resultcache / the netfront): one event per cache-served
    # request ("hit"), per follower attachment ("coalesced"), per
    # leader miss ("miss"), per published entry ("store"), and per
    # follower promoted to recompute after leader loss ("promote").
    # Action vocabulary and count non-negativity are enforced by
    # tools/validate_runlog.py
    # ("evict" = a disk-store entry unlinked by the GC sweep — reason
    # "ttl" or "max_bytes"; "recover_fill" = a journal-recovered
    # delivered result inserted on startup)
    "net_cache": (
        {"action": "str"},
        {"tenant": ("str", "null"), "ticket": ("str", "null"),
         # "mem" | "disk" — which cache tier answered (hit only)
         "source": "str",
         # provenance: the ticket whose compute produced the colors
         "cached_from": ("str", "null"),
         "key": "str", "v": "int",
         # disk-GC eviction context (evict only)
         "reason": "str", "bytes": "int"}),
    # continuous SLO burn-rate telemetry (obs.timeseries): one event per
    # objective whose fast AND slow trailing-window burns crossed the
    # threshold; ``dump``/``profile`` record the diagnostics the firing
    # triggered (ViolationHooks). Objective vocabulary and the
    # burn-needs-window rule are enforced by tools/validate_runlog.py
    "slo_burn": (
        {"objective": "str", "window_s": NUM, "burn": NUM},
        {"fast_window_s": NUM, "slow_window_s": NUM,
         "fast_burn": NUM, "slow_burn": NUM, "threshold": NUM,
         "value": (*NUM, "null"), "limit": NUM,
         "dump": ("str", "null"), "profile": "bool"}),
    "net_reject": (
        {"tenant": "str", "reason": "str"},
        {"retry_after_s": NUM, "queue_depth": "int", "capacity": "int",
         "tokens_left": NUM, "in_flight": "int", "limit": "int",
         # brownout context: the tenant's tier and the shed level that
         # refused it (reason="brownout" only)
         "tier": "str", "level": "int"}),
    # burn-driven brownout (netfront.admission.BrownoutController):
    # one event per shed-level transition. Action vocabulary
    # ("shed"/"restore"), level bounds, and shed⇒level≥1 are enforced
    # by tools/validate_runlog.py
    "net_brownout": (
        {"action": "str", "level": "int"},
        {"objectives": "list", "retry_after_s": NUM}),
    "net_drain": (
        {"in_flight": "int", "queued": "int"},
        {"completed": "int", "failed": "int", "timeout_s": NUM,
         "wall_s": NUM}),
    # journal recovery (serve.netfront.journal): one event per ticket
    # the listener restores/replays from the durable ticket journal on
    # startup plus a closing summary. Action vocabulary ("restored",
    # "replayed", "replay_failed", "summary") and count non-negativity
    # are enforced by tools/validate_runlog.py
    "net_recover": (
        {"action": "str"},
        {"ticket": ("str", "null"), "tenant": ("str", "null"),
         "error": ("str", "null"), "records": "int", "restored": "int",
         "replayed": "int", "failed": "int", "high_water": "int",
         "wall_s": NUM,
         # fleet recovery (summary only): namespaces merge-scanned and
         # in-flight tickets left to sibling replicas' recover sets
         "namespaces": "int", "foreign": "int"}),
    # automatic mesh-restore probe (resilience.probe.HealthProbe): one
    # event per canary attempt on a benched device, plus the restore
    # arm once the bench empties. Action vocabulary ("probed" /
    # "restore_requested"), backoff non-negativity, and ok/backoff
    # consistency are enforced by tools/validate_runlog.py
    "mesh_probe": (
        {"device": "int", "ok": "bool"},
        {"action": "str", "attempt": "int", "backoff_s": NUM}),
    "serve_warmup": (
        {"classes": "int", "kernels": "int", "seconds": NUM},
        # compiled stage branches across the warmed kernels (the staged
        # ladder's compile-cache growth, priced in PERF.md)
        {"stage_bodies": "int"}),
    # request_id accepts str: JSONL replay ids round-trip verbatim (the
    # PR 6 non-int-id contract, tests/test_serve.py) — found by driving
    # a string-id replay through validate_runlog
    "serve_request": (
        {"request_id": ("int", "str"), "status": "str", "queue_ms": NUM,
         "service_ms": NUM},
        {"minimal_colors": ("int", "null"), "v": "int",
         "shape_class": ("str", "null"), "batched": "bool",
         "attempts": "int", "error": ("str", "null")}),
    "serve_health": (
        {"ready": "bool", "queue_depth": "int"},
        {"in_flight": "int", "capacity": "int", "degraded": "bool",
         "backend": ("str", "null"), "rung": ("int", "null"),
         "retry_pressure": "int",
         # failure-domain mesh state (mesh mode only): devices
         # total/surviving, degraded flag, per-device health — the
         # /healthz mesh block verbatim
         "mesh": "dict"}),
    "serve_done": (
        {"requests": "int", "completed": "int", "failed": "int"},
        {"rejected": "int"}),
    # flight recorder (obs.flightrec): the self-describing trailer of a
    # ring dump — emitted into the live stream (metrics omitted there)
    # AND as the dump file's last record (metrics snapshot embedded)
    "flightrec_dump": (
        {"reason": "str", "records": "int"},
        {"path": ("str", "null"), "seen": "int", "capacity": "int",
         "dropped_spans": "int", "open_spans": "list",
         "trigger": ("str", "null"), "metrics": ("dict", "null")}),
    # programmatic profiler windows (obs.profiler): one event per closed
    # window; ``xplane`` is the located artifact tools/xplane_split.py
    # consumes (null when the backend produced none)
    "profile_window": (
        {"trigger": "str", "logdir": "str", "seconds": NUM},
        {"xplane": ("str", "null"), "first": "int", "count": "int",
         "ms": NUM}),
    # devclock timing column vs xplane op self-time cross-check
    # (tools/xplane_split.py --manifest): coverage = in_kernel/xplane
    "timing_crosscheck": (
        {"in_kernel_ms": NUM, "xplane_ms": NUM, "verdict": "str"},
        {"coverage": (*NUM, "null"), "lo": NUM, "hi": NUM,
         "xplane": ("str", "null"), "attempts": "int",
         "supersteps": "int", "platform": ("str", "null")}),
    # perf-history ledger verdict (tools/perf_db.py): median-vs-baseline
    # regression check over the (shape, config, host) key's history
    "perf_regression": (
        {"metric": "str", "value": (*NUM, "null"), "regression": "bool"},
        {"baseline_median": (*NUM, "null"), "delta_pct": (*NUM, "null"),
         "samples": "int", "better": "str", "threshold_pct": NUM,
         "db": ("str", "null"), "unit": ("str", "null")}),
    "serve_summary": (
        {"requests": "int", "completed": "int", "failed": "int",
         "wall_s": NUM},
        {"rejected": "int", "graphs_per_s": (*NUM, "null"),
         "batches": "int", "compile_misses": "int", "compile_hits": "int",
         "slices": "int", "recycles": "int", "mode": "str",
         "warmup_s": (*NUM, "null"), "warmed_kernels": ("int", "null"),
         # per-shape-class latency summary (bucket-interpolated
         # histogram quantiles, ms): {class: {p50, p95, p99, count}}
         "latency_ms": "dict", "recals": "int",
         # whole-run host<->device transfer totals (serve_slice sums)
         "h2d_mb": NUM, "d2h_mb": NUM,
         # lane-mesh summary (mesh mode only): mesh size + each
         # device's MEAN live-lane occupancy over the whole run
         "mesh_devices": "int", "device_occupancy": "list",
         # failure-domain plane: degrades survived and live lanes
         # evacuated across them (present only when a degrade happened)
         "mesh_degrades": "int", "lanes_evacuated": "int",
         # content-addressed result cache (present only when the cache
         # is enabled): lookup outcomes, coalesced followers, entries
         # published, and the LRU's final population
         "cache_hits": "int", "cache_misses": "int",
         "cache_coalesced": "int", "cache_stores": "int",
         "cache_entries": "int",
         # speculation plane (present only when an attempt actually
         # speculated): seats, claimed wins, cancellations (preemptions
         # a subset), and the supersteps cancelled lanes burnt
         "spec_seated": "int", "spec_wins": "int",
         "spec_cancelled": "int", "spec_preempted": "int",
         "spec_wasted_steps": "int"}),
}


def _type_ok(value, ty) -> bool:
    if isinstance(ty, tuple):
        return any(_type_ok(value, t) for t in ty)
    if ty == "null":
        return value is None
    if ty == "int":
        return isinstance(value, int) and not isinstance(value, bool)
    if ty == "float":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if ty == "str":
        return isinstance(value, str)
    if ty == "bool":
        return isinstance(value, bool)
    if ty == "list":
        return isinstance(value, list)
    if ty == "dict":
        return isinstance(value, dict)
    raise ValueError(f"unknown schema type {ty!r}")


def validate_record(record) -> list[str]:
    """Schema-check one parsed JSONL record; returns a list of problems
    (empty = valid)."""
    problems: list[str] = []
    if not isinstance(record, dict):
        return [f"record is not an object: {type(record).__name__}"]
    t = record.get("t")
    if not _type_ok(t, NUM):
        problems.append(f"missing/invalid 't': {t!r}")
    kind = record.get("event")
    if not isinstance(kind, str):
        return problems + [f"missing/invalid 'event': {kind!r}"]
    schema = EVENT_SCHEMAS.get(kind)
    if schema is None:
        return problems + [f"unknown event kind {kind!r}"]
    required, optional = schema
    fields = {k: v for k, v in record.items() if k not in ("t", "event")}
    for name, ty in required.items():
        if name not in fields:
            problems.append(f"{kind}: missing required field {name!r}")
        elif not _type_ok(fields[name], ty):
            problems.append(
                f"{kind}: field {name!r} has wrong type "
                f"({type(fields[name]).__name__}, want {ty})")
    for name, value in fields.items():
        if name in required:
            continue
        if name not in optional:
            problems.append(f"{kind}: unknown field {name!r}")
        elif not _type_ok(value, optional[name]):
            problems.append(
                f"{kind}: field {name!r} has wrong type "
                f"({type(value).__name__}, want {optional[name]})")
    return problems
