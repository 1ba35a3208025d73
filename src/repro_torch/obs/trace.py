"""Per-request distributed tracing over a lock-cheap span ring buffer.

The paper's performance story (§6) attributes cutout latency to its
stages — disk reads, decompression, assembly, network.  This module is
the mechanism: a request-scoped :class:`TraceContext` travels down the
whole read/write pipeline (HTTP front door → cluster fan-out → node
fetch → decode workers → assembly sink) and every instrumented stage
emits a timestamped span into a fixed-size per-node ring buffer
(:class:`SpanRing`).  A completed request yields a span *tree* —
queue wait → admission → plan → per-node fetch → decode → assemble —
retrievable by trace id (``GET /trace/<id>`` on the front door).

Always-on-cheap is the design constraint: when no trace is sampled the
instrumentation reduces to one ``ContextVar.get()`` returning ``None``
per span site (:func:`span` returns a shared null context manager), so
the untraced hot path pays nanoseconds, not locks.  Sampling:

* ``configure(sample=...)`` — ``0`` (default) never samples, ``1``
  samples every request, a fraction ``0 < p < 1`` samples one request in
  ``round(1/p)`` (deterministic counter, not RNG — cheap and exact).
* An explicit ``X-Trace-Id`` request header always traces, whatever the
  sample rate — the operator's "trace THIS request" hook.

Propagation: spans cross thread-pool boundaries (node fan-out, decode
chunks, prefetch tasks) via :func:`bind`, which captures the caller's
active span and re-installs it inside the worker — a no-op returning the
original callable when nothing is traced, so pools pay nothing either.

The profiler: while ``torch.profiler.profile`` runs, every span is also a
profiler range of the same name, whether or not a request is traced, so
it lands on the profiler's clock, the one the device's operations are
placed on.  The check is one module attribute read
(``torch.autograd.profiler._is_profiler_enabled``, read through the module
on every call): with neither a profiler nor a request trace a span costs
that read and the ContextVar read, where a bare profiler range enters
the dispatcher on every call, profiler or not.  The port's hot path
(train step parts, the kernels' recomputes, the MoE layer, the data
pipeline, the decode step) opens its ranges through :func:`span` alone.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import torch.autograd.profiler as _profiler

from ..analysis.witness import ordered_lock

__all__ = [
    "configure",
    "SpanRing",
    "TraceContext",
    "RING",
    "current",
    "maybe_start",
    "activate",
    "span",
    "event",
    "bind",
    "trace_spans",
    "trace_tree",
    "sample_period",
]


class SpanRing:
    """Fixed-capacity ring of completed span records (dicts).

    One per process ("node" in this reproduction); appends take one short
    lock around an index bump + slot assignment, so a traced request costs
    O(spans) cheap appends and an untraced request costs zero.  Lookup
    scans the ring (capacity is small — observability data, not storage).
    """

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._buf: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._idx = 0
        self._lock = ordered_lock("obs.ring", 90)
        self.appended = 0  # lifetime spans recorded (monotonic)
        self.dropped = 0  # spans overwritten before ever being read

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._buf[self._idx] is not None:
                self.dropped += 1
            self._buf[self._idx] = record
            self._idx = (self._idx + 1) % self.capacity
            self.appended += 1

    def spans_for(self, trace_id: str) -> List[Dict[str, Any]]:
        """Every retained span of one trace, oldest first."""
        with self._lock:
            flat = self._buf[self._idx :] + self._buf[: self._idx]
        return [s for s in flat if s is not None and s["trace"] == trace_id]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            resident = sum(1 for s in self._buf if s is not None)
        return {
            "capacity": self.capacity,
            "resident": resident,
            "appended": self.appended,
            "dropped": self.dropped,
        }

    def clear(self, capacity: Optional[int] = None) -> None:
        """Drop every span; ``capacity`` resizes the ring."""
        if capacity is not None and capacity <= 0:
            raise ValueError("capacity must be positive")
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            self._buf = [None] * self.capacity
            self._idx = 0


#: The per-node ring every instrumented stage writes into and the
#: ``GET /trace/<id>`` verb reads from.
RING = SpanRing(4096)

_SAMPLE_RATE: Optional[float] = None


def configure(ring: Optional[int] = None, sample: Optional[float] = None) -> None:
    """Resize (and clear) the span ring, and set the sampling rate; an
    argument left ``None`` keeps its setting.  The ring starts at 4,096
    spans and sampling off."""
    global _SAMPLE_RATE
    if ring is not None:
        RING.clear(ring)
    if sample is not None:
        _SAMPLE_RATE = float(sample)

_span_ids = itertools.count(1)  # 0 is the implicit root parent


class TraceContext:
    """One sampled request's identity: trace id + destination ring."""

    __slots__ = ("trace_id", "ring")

    def __init__(self, trace_id: str, ring: Optional[SpanRing] = None):
        self.trace_id = trace_id
        self.ring = ring if ring is not None else RING


class _Active:
    """What the context variable holds: (context, innermost open span)."""

    __slots__ = ("ctx", "span_id")

    def __init__(self, ctx: TraceContext, span_id: int):
        self.ctx = ctx
        self.span_id = span_id


_current: contextvars.ContextVar[Optional[_Active]] = contextvars.ContextVar(
    "repro_torch_trace", default=None
)


def current() -> Optional[TraceContext]:
    """The active trace, or ``None`` (the untraced fast path)."""
    active = _current.get()
    return active.ctx if active is not None else None


def sample_period() -> int:
    """The sampling rate as a period: 0 = never, 1 = every request, k =
    one request in k (from a fractional rate)."""
    rate = _SAMPLE_RATE
    if rate is None:
        return 0
    if rate <= 0:
        return 0
    if rate >= 1:
        return 1
    return max(1, round(1.0 / rate))


_sample_counter = itertools.count()


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def maybe_start(
    trace_id: Optional[str] = None, ring: Optional[SpanRing] = None
) -> Optional[TraceContext]:
    """Sampling decision for one request.

    An explicit ``trace_id`` (the ``X-Trace-Id`` header) always traces;
    otherwise one request per :func:`sample_period` gets a minted id.
    Returns ``None`` for the (cheap) untraced majority.
    """
    if trace_id:
        return TraceContext(str(trace_id), ring)
    period = sample_period()
    if period <= 0:
        return None
    if next(_sample_counter) % period != 0:
        return None
    return TraceContext(mint_trace_id(), ring)


class _Activation:
    """Installs a context as the root of the current control flow."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: TraceContext):
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> TraceContext:
        self._token = _current.set(_Active(self._ctx, 0))
        return self._ctx

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)


def activate(ctx: TraceContext) -> _Activation:
    """``with activate(ctx): ...`` — make ``ctx`` current (root parent)."""
    return _Activation(ctx)


class _NullSpan:
    """Shared no-op context manager — the untraced path's entire cost."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Range:
    """A span while a profiler runs and no request is traced: the
    profiler's range alone.  Yields None, as the null span does."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = _profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return None

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False


class _Span:
    """An open span: times itself, nests children, records on exit.

    ``__enter__`` yields the (mutable) meta dict so stages can annotate
    results discovered mid-span (cache hits, byte counts) without a
    second record.  Made while a profiler runs, it is also the profiler's
    range of the same name.
    """

    __slots__ = ("_name", "_meta", "_active", "_sid", "_token", "_t0", "_range")

    def __init__(self, name: str, meta: Dict[str, Any], active: _Active,
                 profiled: bool = False):
        self._name = name
        self._meta = meta
        self._active = active
        self._sid = next(_span_ids)
        self._token = None
        self._t0 = 0.0
        self._range = _Range(name) if profiled else _NULL

    def __enter__(self) -> Dict[str, Any]:
        self._token = _current.set(_Active(self._active.ctx, self._sid))
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self._meta

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        self._range.__exit__(exc_type, exc, tb)
        _current.reset(self._token)
        if exc_type is not None:
            self._meta["error"] = exc_type.__name__
        ctx = self._active.ctx
        ctx.ring.append(
            {
                "trace": ctx.trace_id,
                "id": self._sid,
                "parent": self._active.span_id,
                "name": self._name,
                "t0": self._t0,
                "dur_s": dur,
                "thread": threading.current_thread().name,
                "meta": self._meta,
            }
        )
        return False


def span(name: str, **meta: Any):
    """``with span("node.fetch", node=3) as s:`` — time one stage.

    Untraced: returns a shared null context manager (one ContextVar read
    and one module attribute read, no allocation beyond the kwargs dict).
    Traced: opens a child of the innermost active span; the yielded dict
    accepts extra annotations.  While a profiler runs the span is also a
    profiler range named ``name``, traced or not (untraced it yields None).
    """
    active = _current.get()
    if _profiler._is_profiler_enabled:
        return _Range(name) if active is None else _Span(name, meta, active, True)
    if active is None:
        return _NULL
    return _Span(name, meta, active)


def event(name: str, **meta: Any) -> None:
    """A zero-duration span — point-in-time facts (prefetch admitted,
    cache verdicts) that should land in the tree without nesting."""
    active = _current.get()
    if active is None:
        return
    ctx = active.ctx
    ctx.ring.append(
        {
            "trace": ctx.trace_id,
            "id": next(_span_ids),
            "parent": active.span_id,
            "name": name,
            "t0": time.perf_counter(),
            "dur_s": 0.0,
            "thread": threading.current_thread().name,
            "meta": meta,
        }
    )


def bind(fn: Callable) -> Callable:
    """Carry the caller's active span across a thread-pool submit.

    Returns ``fn`` untouched when nothing is traced — pools on the
    untraced path pay a single ContextVar read per job.  Otherwise the
    wrapper re-installs the capturing span for the duration of the call,
    so worker-side spans nest under the submitting stage.
    """
    active = _current.get()
    if active is None:
        return fn

    def bound(*args, **kwargs):
        token = _current.set(active)
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)

    return bound


def trace_spans(trace_id: str, ring: Optional[SpanRing] = None) -> List[Dict[str, Any]]:
    """Flat retained spans of one trace (oldest first)."""
    return (ring if ring is not None else RING).spans_for(trace_id)


def trace_tree(trace_id: str, ring: Optional[SpanRing] = None) -> List[Dict[str, Any]]:
    """The span tree: roots (parent missing from the ring) with nested
    ``children``, each child list ordered by start time.  Spans record on
    *exit*, so a parent appears after its children in the ring — the tree
    is assembled from ids, not arrival order."""
    spans = trace_spans(trace_id, ring)
    by_id = {s["id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict[str, Any]] = []
    for s in spans:
        node = by_id[s["id"]]
        parent = by_id.get(s["parent"])
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda c: c["t0"])
    roots.sort(key=lambda c: c["t0"])
    return roots
