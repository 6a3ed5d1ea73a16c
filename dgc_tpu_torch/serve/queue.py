"""Micro-batching serve front-end: queue, workers, latency, health (port
of ``dgc_tpu.serve.queue``).

``submit()`` enqueues a request into a bounded queue (**backpressure**: a
full queue raises :class:`QueueFull` immediately or after the caller's
timeout). Worker threads pop requests and each runs the exact
single-graph minimal-k driver (``find_minimal_coloring``, jump mode,
validation and the recolor post-pass as the CLI defaults) over a
:class:`~dgc_tpu_torch.serve.engine.BatchMemberEngine` proxy, so the
concurrent requests' sweeps coalesce in the
:class:`~dgc_tpu_torch.serve.engine.BatchScheduler` and run as lane slices
(``mode="continuous"``) or whole-pair batches (``mode="sync"``) on the
card, while every per-request semantic stays the single-graph path's.

Graphs beyond the shape ladder (or a batched dispatch the scheduler
refuses) take the **single-graph fallback**: a supervised sweep down the
``ell-compact`` → ``ell-bucketed`` → ``reference-sim`` ladder
(``resilience.supervisor``) whose rung state feeds :meth:`health`. Every
request and batch lands in the obs event stream (``serve_request`` /
``serve_batch`` / ``serve_health``), the metrics registry, and the
manifest's ``serve`` slot.

``device_carry`` keeps each lane pool's carry and input stacks on the card
(``serve.engine._LanePool``); ``speculate_k`` (a depth or ``"auto"``)
serves each batched request through a
:class:`~dgc_tpu_torch.serve.speculate.SpeculativeMinimalKEngine` (jump
mode delegates to the fused pair unchanged; the attempt path speculates).

``mesh_devices`` splits every lane pool over a lane mesh
(``serve.engine``'s mesh mode: a count, ``"auto"`` or a
``serve.batched.LaneMesh``); its events carry ``mesh_devices`` and
``device_occupancy``, ``mesh_degrade``/``mesh_restore`` move the metrics,
and :meth:`ServeFrontEnd.health` gains a ``mesh`` document.

Not ported: tuned configs (``auto_tune``, ``tuned_cache``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from dgc_tpu_torch.device import resolve_device
from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                            make_reducer, make_validator)
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.obs.metrics import MetricsRegistry
from dgc_tpu_torch.obs.trace import tracer_for
from dgc_tpu_torch.resilience.faults import FaultInjected, fault_point
from dgc_tpu_torch.resilience.supervisor import (STRUCTURED_ABORT_RC,
                                                 RungState, supervise_sweep)
from dgc_tpu_torch.serve.engine import (BatchMemberEngine, BatchScheduler,
                                        PoisonedRequest, ServeError)
from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER, ShapeLadder,
                                               pad_member)


class QueueFull(RuntimeError):
    """Backpressure signal: the bounded request queue is at capacity,
    with ``queue_depth`` / ``capacity`` at rejection time and a
    ``retry_after_s`` suggestion."""

    def __init__(self, message: str, *, queue_depth: int | None = None,
                 capacity: int | None = None,
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.capacity = capacity
        self.retry_after_s = retry_after_s


@dataclass
class ServeRequest:
    request_id: int
    arrays: GraphArrays
    t_submit: float = field(default_factory=time.perf_counter)
    # priority tier: >0 jumps the request queue and shortens the batch
    # scheduler's window (engine.priority_window)
    priority: int = 0
    # request-scoped tracing (obs.trace): the root span covering the
    # request's whole life and the queue-wait child, begun at submit
    root_span: object = None
    queue_span: object = None


@dataclass
class ServeResult:
    request_id: int
    status: str                      # "ok" | "failed" | "error"
    colors: np.ndarray | None
    minimal_colors: int | None
    attempts: list                   # [(k, status_name, supersteps), ...]
    queue_s: float
    service_s: float
    batched: bool
    shape_class: str | None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class ServeTicket:
    """Handle returned by ``submit``; ``result()`` blocks for completion."""

    def __init__(self, request: ServeRequest):
        self.request = request
        self._done = threading.Event()
        self._result: ServeResult | None = None   # guarded-by: _lock
        self._lock = threading.Lock()

    def _complete(self, result: ServeResult) -> None:
        with self._lock:
            self._result = result
        self._done.set()

    def result(self, timeout: float | None = None) -> ServeResult:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} still in flight")
        with self._lock:
            return self._result


# the serve fallback ladder: the single-device compact engine first, the
# host reference last (the reference's ladder, on the port's engines)
def _default_fallback_factories(arrays, device):
    def compact():
        from dgc_tpu_torch.engine.compact import CompactFrontierEngine

        return CompactFrontierEngine(arrays, device=device)

    def bucketed():
        from dgc_tpu_torch.engine.bucketed import BucketedELLEngine

        return BucketedELLEngine(arrays, device=device)

    def refsim():
        from dgc_tpu_torch.engine.reference_sim import ReferenceSimEngine

        return ReferenceSimEngine(arrays)

    return [("ell-compact", compact), ("ell-bucketed", bucketed),
            ("reference-sim", refsim)]


class ServeFrontEnd:
    """Bounded-queue micro-batching server over the batch scheduler.

    ``queue_depth`` bounds admitted-but-unstarted requests; ``workers``
    bounds in-flight requests (default ``batch_max`` so one full batch can
    always form). ``validate``/``post_reduce`` default on — the CLI
    driver's semantics. ``stages`` ("auto"/"off"/explicit ladder)
    configures the batched kernels' staged frontier ladder;
    ``device_carry``, ``mesh_devices`` and ``speculate_k``: module
    docstring (a bad ``mesh_devices`` raises ``ValueError``). ``device``:
    where the kernels and the fallback engines run (default the card).
    ``fallback_factories(arrays) -> [(name, factory), ...]`` overrides the
    fallback ladder (tests inject failing rungs to exercise the health
    flip)."""

    def __init__(self, *, ladder: ShapeLadder = DEFAULT_LADDER,
                 batch_max: int = 8, window_s: float = 0.002,
                 queue_depth: int = 64, workers: int | None = None,
                 mode: str = "continuous", slice_steps: int | None = None,
                 affinity: bool = True, stages="auto",
                 device_carry: bool = False, mesh_devices=None,
                 timing: bool = False,
                 validate: bool = True, post_reduce: bool = True,
                 speculate_k=None,
                 fallback_factories=None,
                 logger=None, registry: MetricsRegistry | None = None,
                 device="cuda"):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.device = resolve_device(device)
        self.ladder = ladder
        self.batch_max = int(batch_max)
        # speculative minimal-k (serve.speculate) for batched requests;
        # "auto" prices the window depth off the free-lane count
        if speculate_k == "auto":
            from dgc_tpu_torch.serve.speculate import auto_depth

            speculate_k = auto_depth(self.batch_max)
        if speculate_k is not None and int(speculate_k) < 1:
            raise ValueError(
                f"speculate_k must be >= 1 or 'auto', got {speculate_k}")
        self.speculate_k = int(speculate_k) if speculate_k else None
        self.queue_depth = int(queue_depth)
        self.workers = int(workers) if workers is not None else self.batch_max
        self.validate = validate
        self.post_reduce = post_reduce
        self._fallback_factories = (
            fallback_factories
            or (lambda arrays: _default_fallback_factories(arrays,
                                                           self.device)))
        self.logger = logger
        self.registry = registry
        # request-scoped tracing: spans ride the same JSONL stream as
        # every other event, so tracing is on exactly when a logger is
        # attached
        self.tracer = tracer_for(logger)
        self.rung_state = RungState()
        self.scheduler = BatchScheduler(batch_max=batch_max,
                                        window_s=window_s,
                                        mode=mode, slice_steps=slice_steps,
                                        affinity=affinity, timing=timing,
                                        stages=stages,
                                        device_carry=device_carry,
                                        on_batch=self._on_batch,
                                        on_event=self._on_sched_event,
                                        tracer=self.tracer,
                                        mesh_devices=mesh_devices,
                                        device=self.device)
        # the Condition wraps an RLock, so guarded sections nest freely
        self._lock = threading.Condition()
        self._queue: deque = deque()   # guarded-by: _lock
        # shutdown serializer: a drain racing another shutdown() joins
        # the first call's teardown instead of double-joining workers
        self._shutdown_lock = threading.Lock()
        self._threads: list = []       # guarded-by: owner
        self._in_flight = 0            # guarded-by: _lock
        self._next_id = 0              # guarded-by: _lock
        self._started = False          # guarded-by: _lock
        self._draining = False         # guarded-by: _lock
        # recent mean service seconds (EWMA): the retry-after basis
        self._ewma_service = 0.0       # guarded-by: _lock
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "rejected": 0, "fallbacks": 0}   # guarded-by: _lock

    # -- obs plumbing ---------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        if self.logger is not None:
            self.logger.event(kind, **fields)

    def _on_batch(self, record: dict) -> None:
        self._event("serve_batch", **record)
        if self.registry is not None:
            self.registry.counter(
                "dgc_serve_batches_total", "batched sweep dispatches",
                shape_class=record["shape_class"]).inc()

    def _on_sched_event(self, kind: str, record: dict) -> None:
        """Continuous-mode scheduler telemetry (``serve_slice`` per slice,
        ``lane_recycled`` per lane swap) into the same event stream /
        registry the batch records use."""
        self._event(kind, **record)
        if self.registry is None:
            return
        if kind == "serve_slice":
            self.registry.counter(
                "dgc_serve_slices_total", "sliced lane dispatches",
                shape_class=record["shape_class"]).inc()
        elif kind == "lane_recycled":
            self.registry.counter(
                "dgc_serve_recycles_total", "lane swaps (sweeps completed)",
                shape_class=record["shape_class"]).inc()
        elif kind == "mesh_degrade":
            # the failure-domain plane: a lost slot re-sharded the lane
            # axis onto the survivors
            self.registry.counter(
                "dgc_serve_mesh_degrades_total",
                "mesh degrades (device loss -> survivor re-shard)").inc()
            self.registry.gauge(
                "dgc_serve_mesh_devices",
                "devices the lane axis currently shards over").set(
                record["devices_after"])
        elif kind == "mesh_restore":
            self.registry.counter(
                "dgc_serve_mesh_restores_total",
                "mesh restores back to the full device set").inc()
            self.registry.gauge(
                "dgc_serve_mesh_devices",
                "devices the lane axis currently shards over").set(
                record["devices_after"])

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "ServeFrontEnd":
        with self._lock:
            if self._started:
                return self
            self._started = True
        self.scheduler.start()
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"dgc-serve-worker-{i}")
            t.start()
            self._threads.append(t)
        # the mesh size appears only when the lane axis is sharded,
        # speculate_k only when armed
        spec_kw = ({"mesh_devices": self.scheduler.mesh_devices}
                   if self.scheduler.mesh is not None else {})
        if self.speculate_k:
            spec_kw["speculate_k"] = self.speculate_k
        self._event("serve_start", batch_max=self.batch_max,
                    window_ms=round(self.scheduler.window_s * 1e3, 3),
                    queue_depth=self.queue_depth, workers=self.workers,
                    mode=self.scheduler.mode,
                    slice_steps=self.scheduler.slice_steps,
                    affinity=self.scheduler.affinity,
                    timing=self.scheduler.timing,
                    stages=(self.scheduler.stages
                            if isinstance(self.scheduler.stages, str)
                            else "custom"),
                    device_carry=self.scheduler.device_carry,
                    tracing=self.tracer.enabled, **spec_kw)
        return self

    def warm(self, class_names: list) -> dict:
        """Run the named shape classes' kernels at every batch pad the
        scheduler can dispatch at (``--warm-classes``), so their first use
        lands in reported warmup instead of first-batch latency. Returns
        ``{"classes", "kernels", "stage_bodies", "seconds"}``."""
        by_name = {c.name: c for c in self.ladder.classes()}
        unknown = [n for n in class_names if n not in by_name]
        if unknown:
            raise ValueError(
                f"unknown shape class(es) {unknown}; ladder has "
                f"{sorted(by_name)}")
        t0 = time.perf_counter()
        kernels = 0
        stage_bodies = 0
        for name in class_names:
            w = self.scheduler.warm_class(by_name[name])
            kernels += w["kernels"]
            stage_bodies += w["stage_bodies"]
        seconds = time.perf_counter() - t0
        doc = {"classes": len(class_names), "kernels": kernels,
               "stage_bodies": stage_bodies,
               "seconds": round(seconds, 4)}
        self._event("serve_warmup", **doc)
        return doc

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting; with ``drain`` finish everything admitted
        first (no admitted request is dropped), then stop workers and the
        batch dispatcher. Safe to call concurrently."""
        with self._lock:
            self._draining = True
            if not drain:
                for req, ticket in self._queue:
                    if req.queue_span is not None:
                        req.queue_span.end({"error": "shutdown"})
                        req.root_span.end({"status": "error"})
                    ticket._complete(self._error_result(
                        req, "front-end shut down before dispatch"))
                    self.stats["failed"] += 1
                self._queue.clear()
            self._lock.notify_all()
        with self._shutdown_lock:
            if not self._threads:
                return   # another caller already tore down
            deadline = time.perf_counter() + timeout
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.perf_counter()))
            self._threads.clear()
            self.scheduler.stop()
        with self._lock:
            st = dict(self.stats)
        self._event("serve_done", requests=st["submitted"],
                    completed=st["completed"],
                    failed=st["failed"],
                    rejected=st["rejected"])

    # -- submission -----------------------------------------------------
    def _retry_after(self, queue_len: int, ewma_service: float) -> float:
        """Suggested resubmit delay when the queue sheds: queue length ×
        recent mean service seconds / workers, clamped to [0.05, 30]."""
        est = queue_len * (ewma_service or 0.5) / max(1, self.workers)
        return min(30.0, max(0.05, est))

    def submit(self, arrays: GraphArrays, request_id: int | None = None,
               timeout: float = 0.0, priority: int = 0) -> ServeTicket:
        """Admit one request; raises :class:`QueueFull` when the bounded
        queue stays full past ``timeout`` (0 = reject immediately).
        ``priority`` > 0 queues ahead of lower-priority waiters. The
        request's span tree has the trace id ``req-<id>``."""
        with self._lock:
            if not self._started:
                raise ServeError("front-end not started")
            if self._draining:
                raise ServeError("front-end shutting down")
            if len(self._queue) >= self.queue_depth and timeout > 0:
                deadline = time.perf_counter() + timeout
                while (len(self._queue) >= self.queue_depth
                       and not self._draining):
                    left = deadline - time.perf_counter()
                    if left <= 0 or not self._lock.wait(timeout=left):
                        break
            if self._draining:
                raise ServeError("front-end shutting down")
            if len(self._queue) >= self.queue_depth:
                self.stats["rejected"] += 1
                if self.registry is not None:
                    self.registry.counter(
                        "dgc_serve_rejected_total",
                        "requests shed by queue backpressure").inc()
                raise QueueFull(
                    f"queue at capacity ({self.queue_depth})",
                    queue_depth=len(self._queue),
                    capacity=self.queue_depth,
                    retry_after_s=self._retry_after(
                        len(self._queue), self._ewma_service))
            if request_id is None:
                request_id = self._next_id
            if isinstance(request_id, int):
                # non-int ids (string ids from a JSONL replay) skip the
                # auto-id bookkeeping; they are carried through as-is
                self._next_id = max(self._next_id, request_id) + 1
            req = ServeRequest(request_id=request_id, arrays=arrays,
                               priority=max(0, int(priority)))
            req.root_span = self.tracer.begin(
                "request", trace=f"req-{request_id}",
                attrs={"v": int(arrays.num_vertices)})
            req.queue_span = self.tracer.begin("queue",
                                               parent=req.root_span)
            ticket = ServeTicket(req)
            if req.priority > 0:
                # priority tiers jump the line: insert ahead of the first
                # strictly-lower-priority waiter (FIFO within a tier)
                idx = len(self._queue)
                for i, (other, _t) in enumerate(self._queue):
                    if other.priority < req.priority:
                        idx = i
                        break
                self._queue.insert(idx, (req, ticket))
            else:
                self._queue.append((req, ticket))
            self.stats["submitted"] += 1
            self._lock.notify_all()
        return ticket

    # -- latency summary -------------------------------------------------
    def latency_summary(self) -> dict | None:
        """Per-shape-class service-latency summary from the registry's
        histograms: ``{class: {p50, p95, p99, count}}`` in milliseconds.
        None when no registry is attached or nothing was observed."""
        if self.registry is None:
            return None
        out = {}
        for h in self.registry.histograms("dgc_serve_service_seconds"):
            with h._lock:
                n = h.n
            if n == 0:
                continue
            out[h.labels.get("shape_class", "?")] = {
                "p50": round(h.quantile(0.50) * 1e3, 3),
                "p95": round(h.quantile(0.95) * 1e3, 3),
                "p99": round(h.quantile(0.99) * 1e3, 3),
                "count": n,
            }
        return out or None

    def stats_snapshot(self) -> dict:
        """Locked copy of the request counters."""
        with self._lock:
            return dict(self.stats)

    # -- health/readiness -----------------------------------------------
    def health(self, emit: bool = False) -> dict:
        """Liveness/readiness snapshot. ``ready`` is False before
        ``start``, while draining, and once the fallback supervisor's
        ladder is exhausted; ``degraded`` flags a fallback below the
        primary engine."""
        rung = self.rung_state.snapshot()
        with self._lock:
            doc = {
                "ready": (self._started and not self._draining
                          and rung["ready"]),
                "queue_depth": len(self._queue),
                "in_flight": self._in_flight,
                "capacity": self.queue_depth,
                "degraded": rung["degraded"],
                "backend": rung["backend"],
                "rung": rung["rung"],
                "retry_pressure": rung["retry_pressure"],
            }
        # the failure-domain plane's document, only when the lane axis was
        # configured sharded (the unsharded health doc stays as it was)
        mesh = self.scheduler.mesh_health()
        if mesh is not None:
            doc["mesh"] = mesh
        if emit:
            self._event("serve_health", **doc)
        if self.registry is not None:
            self.registry.gauge("dgc_serve_queue_depth",
                                "requests waiting").set(doc["queue_depth"])
        return doc

    # -- workers --------------------------------------------------------
    def _error_result(self, req: ServeRequest, msg: str) -> ServeResult:
        return ServeResult(
            request_id=req.request_id, status="error", colors=None,
            minimal_colors=None, attempts=[], queue_s=0.0, service_s=0.0,
            batched=False, shape_class=None, error=msg)

    def _worker(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._draining:
                    self._lock.wait()
                if not self._queue:
                    return      # draining and empty: worker retires
                req, ticket = self._queue.popleft()
                self._in_flight += 1
                self._lock.notify_all()   # wake blocked submitters
            if req.queue_span is not None:
                req.queue_span.end()
            serve_span = self.tracer.begin("serve", parent=req.root_span)
            # the worker's current span: BatchScheduler.sweep parents its
            # sweep span here
            self.tracer.push(serve_span)
            try:
                result = self._serve_one(req)
                try:
                    # the result handoff's fault point: a fault here
                    # structured-fails THIS request with rc context
                    fault_point("deliver", request_id=req.request_id)
                except FaultInjected as e:
                    result = self._error_result(
                        req, f"delivery aborted "
                             f"(rc {STRUCTURED_ABORT_RC}): {e}")
            except Exception as e:
                result = self._error_result(req, f"{type(e).__name__}: {e}")
            finally:
                self.tracer.pop(serve_span)
                with self._lock:
                    self._in_flight -= 1
            serve_span.end({"status": result.status})
            with self._lock:
                if result.status == "ok":
                    self.stats["completed"] += 1
                else:
                    self.stats["failed"] += 1
                # EWMA of service time — QueueFull's retry-after basis
                self._ewma_service = (
                    result.service_s if self._ewma_service == 0.0
                    else 0.8 * self._ewma_service + 0.2 * result.service_s)
            self._event(
                "serve_request", request_id=req.request_id,
                status=result.status,
                queue_ms=round(result.queue_s * 1e3, 3),
                service_ms=round(result.service_s * 1e3, 3),
                minimal_colors=result.minimal_colors,
                v=int(req.arrays.num_vertices),
                shape_class=result.shape_class,
                batched=result.batched,
                attempts=len(result.attempts),
                error=result.error)
            if self.registry is not None:
                self.registry.counter("dgc_serve_requests_total",
                                      "served requests",
                                      status=result.status).inc()
                cls_label = result.shape_class or "fallback"
                self.registry.histogram(
                    "dgc_serve_service_seconds",
                    "request service time by shape class",
                    shape_class=cls_label).observe(result.service_s)
                self.registry.histogram(
                    "dgc_serve_queue_seconds",
                    "request queue wait by shape class",
                    shape_class=cls_label).observe(result.queue_s)
            if req.root_span is not None:
                req.root_span.end({"status": result.status})
            ticket._complete(result)

    def _serve_one(self, req: ServeRequest) -> ServeResult:
        t_start = time.perf_counter()
        queue_s = t_start - req.t_submit
        arrays = req.arrays
        cls = self.ladder.class_for(arrays.num_vertices, arrays.max_degree)
        batched = cls is not None
        attempts: list = []

        def on_attempt(res, val):
            attempts.append((int(res.k), res.status.name,
                             int(res.supersteps)))

        validate = make_validator(arrays) if self.validate else None
        post_reduce = make_reducer(arrays) if self.post_reduce else None

        if batched:
            try:
                member = pad_member(arrays, cls)
                spec = None
                if self.speculate_k:
                    # jump-mode requests delegate to the fused pair; close()
                    # frees whatever window the sweep left
                    from dgc_tpu_torch.serve.speculate import \
                        SpeculativeMinimalKEngine

                    spec = engine = SpeculativeMinimalKEngine(
                        member, self.scheduler, depth=self.speculate_k,
                        priority=req.priority)
                else:
                    engine = BatchMemberEngine(member, self.scheduler,
                                               priority=req.priority)
                try:
                    result = find_minimal_coloring(
                        engine, initial_k=engine.member.k0,
                        validate=validate, on_attempt=on_attempt,
                        post_reduce=post_reduce)
                finally:
                    if spec is not None:
                        spec.close()
            except PoisonedRequest:
                # quarantine is terminal: the request structured-fails
                # instead of migrating to the fallback ladder
                raise
            except ServeError:
                batched = False   # scheduler refused: single-graph path
        if not batched:
            result = self._fallback_sweep(arrays, validate, on_attempt,
                                          post_reduce)
        service_s = time.perf_counter() - t_start
        ok = result.colors is not None
        return ServeResult(
            request_id=req.request_id, status="ok" if ok else "failed",
            colors=result.colors, minimal_colors=result.minimal_colors,
            attempts=attempts, queue_s=queue_s, service_s=service_s,
            batched=batched, shape_class=cls.name if cls else None)

    def _fallback_sweep(self, arrays, validate, on_attempt, post_reduce):
        """Single-graph path for graphs beyond the shape ladder: a
        supervised sweep down the fallback ladder, rung state feeding
        :meth:`health`."""
        with self._lock:
            self.stats["fallbacks"] += 1
        k0 = int(arrays.max_degree) + 1
        result, _stats = supervise_sweep(
            self._fallback_factories(arrays), initial_k=k0,
            validate=validate, on_attempt=on_attempt,
            make_post_reduce=(lambda name: post_reduce),
            retry_budget=0,
            logger=self.logger, registry=self.registry,
            rung_state=self.rung_state)
        return result
