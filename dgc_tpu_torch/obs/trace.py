"""Request-scoped distributed tracing: spans over the run-log stream.

One request's life through the serving tier — queue wait, worker pickup,
batched sweep enqueue, lane seating, every recycle boundary, result
delivery — crosses four threads (submitter, worker, batch dispatcher,
and back); the ``serve_*`` events record each hop in isolation but
nothing ties them together. This module adds the missing spine: a
minimal span model (``trace_id``/``span_id``/``parent``, monotonic
microsecond clocks) whose begin/end records land in the SAME
schema-enforced JSONL stream every other event uses (kind ``span``,
``obs.schema``), so the trace and the event log can never disagree and
``tools/validate_runlog.py`` checks the structural invariants
(parent-before-child, every opened span closed).

``tools/export_trace.py`` converts a run log's span events into the
chrome-trace JSON Perfetto loads, one process track per trace — one
request's whole life is one clickable trace.

Design points:

- **Begin/end pairs, not completed-span records.** Spans cross threads
  (the ``queue`` span begins on the submitter and ends on a worker), so
  a span object is handed around and explicitly ended; emitting at both
  edges also means a crashed run's log shows exactly how far each
  request got (the validator then reports the unclosed spans).
- **Propagation is thread-local.** ``Tracer.push``/``pop`` maintain a
  per-thread current-span stack; code that cannot thread a span argument
  (the worker → ``find_minimal_coloring`` → ``BatchMemberEngine`` →
  ``BatchScheduler.sweep`` hop) reads ``Tracer.current()`` instead —
  the classic context-propagation pattern, no driver changes.
- **Null by default.** ``NULL_TRACER`` is a shared no-op whose ``begin``
  returns an inert span; call sites never branch on "is tracing on".
"""

from __future__ import annotations

import hashlib
import itertools
import re
import threading
import time


def now_us() -> int:
    """Monotonic microseconds (``time.perf_counter_ns`` base — the same
    clock family as ``RunLogger``'s relative ``t``)."""
    return time.perf_counter_ns() // 1000


# -- W3C trace context (cross-boundary propagation) ------------------------
#
# The fleet telemetry plane speaks the W3C Trace Context wire format on
# the HTTP boundary: ``traceparent: 00-<32hex trace>-<16hex parent>-<2hex
# flags>``. An inbound header roots the request's span tree under the
# CALLER's trace id (the span ``trace`` field becomes the 32-hex id, the
# caller's span id rides the root span's ``attrs.remote_parent`` — never
# the structural ``parent`` field, whose begin record the validator would
# demand in OUR log), so one trace id spans client, listener, and every
# restart incarnation that replays the journaled ticket.

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header) -> tuple[str, str] | None:
    """Parse a W3C ``traceparent`` header into ``(trace_id, parent_id)``
    (lowercase hex), or None for anything malformed: wrong shape, the
    forbidden version ``ff``, or the all-zero trace/parent ids the spec
    reserves as invalid. Absent/None headers return None — the caller's
    no-propagation path."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, parent_id, _flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id, parent_id


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    """Render a version-00 ``traceparent`` header value."""
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def boundary_span_id(ticket_id: str) -> str:
    """Deterministic 16-hex span id for the service boundary, derived
    from the ticket id — every incarnation that touches the same ticket
    derives the SAME id, so the ``traceparent`` echoed in the 202 (and
    any downstream hop keyed on it) stays stable across crash-resume
    replays. All-zero (spec-invalid) output is remapped."""
    digest = hashlib.sha256(ticket_id.encode()).hexdigest()[:16]
    return digest if digest != "0" * 16 else "1" * 16


class Span:
    """One begun span; ``end()`` emits the closing record exactly once."""

    __slots__ = ("tracer", "name", "trace", "span_id", "parent", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace: str,
                 span_id: str, parent: str | None):
        self.tracer = tracer
        self.name = name
        self.trace = trace
        self.span_id = span_id
        self.parent = parent
        self._ended = False

    def end(self, attrs: dict | None = None) -> None:
        if self._ended:
            return
        self._ended = True
        self.tracer._emit("E", self.name, self.trace, self.span_id,
                          self.parent, attrs)

    # context-manager sugar for same-thread spans
    def __enter__(self) -> "Span":
        self.tracer.push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.tracer.pop(self)
        self.end({"error": repr(exc)} if exc is not None else None)


class _NullSpan:
    """Inert span: every operation is a no-op (the tracing-off path)."""

    __slots__ = ()
    name = trace = span_id = parent = None

    def end(self, attrs: dict | None = None) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory bound to an event emitter (``RunLogger.event``).

    ``emit(kind, **fields)`` receives one ``span`` record per begin and
    per end; span/trace id generation is lock-protected (spans begin on
    submitter, worker, and dispatcher threads concurrently)."""

    enabled = True

    def __init__(self, emit):
        self._emit_fn = emit
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- ids ------------------------------------------------------------
    def _next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    # -- emission -------------------------------------------------------
    def _emit(self, ph: str, name: str, trace: str, span_id: str,
              parent: str | None, attrs: dict | None) -> None:
        self._emit_fn("span", name=name, ph=ph, trace=trace, span=span_id,
                      parent=parent, ts_us=now_us(),
                      attrs=attrs if attrs else None)

    # -- span lifecycle -------------------------------------------------
    def begin(self, name: str, *, trace: str | None = None,
              parent: "Span | None" = None,
              attrs: dict | None = None) -> Span:
        """Begin a span. ``trace`` defaults to the parent's trace (or a
        fresh auto trace id); ``parent`` defaults to the calling thread's
        current span when it shares the requested trace."""
        if parent is None:
            cur = self.current()
            if cur is not None and (trace is None or cur.trace == trace):
                parent = cur
        if trace is None:
            trace = parent.trace if parent is not None else f"t{self._next_id()}"
        span = Span(self, name, trace, f"s{self._next_id()}",
                    parent.span_id if parent is not None else None)
        self._emit("B", name, span.trace, span.span_id, span.parent, attrs)
        return span

    # -- thread-local propagation --------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def push(self, span: Span) -> None:
        self._stack().append(span)

    def pop(self, span: Span | None = None) -> None:
        st = self._stack()
        if not st:
            return
        if span is None or st[-1] is span:
            st.pop()
        elif span in st:
            st.remove(span)

    def current(self) -> Span | None:
        st = self._stack()
        return st[-1] if st else None


class _NullTracer(Tracer):
    """Shared no-op tracer: ``begin`` hands back the inert span and
    nothing is ever emitted — call sites stay branch-free."""

    enabled = False

    def __init__(self):
        self._tls = threading.local()

    def begin(self, name, *, trace=None, parent=None, attrs=None):
        return _NULL_SPAN

    def push(self, span) -> None:
        pass

    def pop(self, span=None) -> None:
        pass

    def current(self):
        return None


NULL_TRACER = _NullTracer()


def tracer_for(logger) -> Tracer:
    """The serve tier's tracer-construction convention: a real tracer
    over ``logger.event`` when a run logger exists, else the shared
    no-op."""
    if logger is None:
        return NULL_TRACER
    return Tracer(logger.event)
