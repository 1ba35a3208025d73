"""Observability: request tracing, mergeable latency histograms, metric
registry/exposition, and structured logging.

Host code, as the reference's: the storage stack's spans (``plan``,
``assemble``, ``store.fetch``, ``decode``, ``write.*``, ``compact.*``) land
in the span ring, its compaction and flush durations in the registry's
histograms.  The hot path's spans (``train_step.forward``, ``.backward``,
``.optimizer``; ``moe_gemm.recompute``, ``flash_attention.recompute``,
``ssd_scan.recompute``; ``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``; ``data.get_batch``; ``serve.decode_step``) go through the
same `trace.span`.  Every span, the storage stack's too, is also a
profiler range while ``torch.profiler.profile`` runs.  Settings are
arguments, not environment variables: `trace.configure` (ring size,
sampling rate) and `log.configure` (access log, slow-request threshold).
"""

from .hist import BOUNDS, Histogram, describe
from .log import access_enabled, access_log, slow_request, slow_threshold_s
from .registry import REGISTRY, Metric, Registry, metric, render_labels
from .trace import (
    RING,
    SpanRing,
    TraceContext,
    activate,
    bind,
    current,
    event,
    maybe_start,
    mint_trace_id,
    sample_period,
    span,
    trace_spans,
    trace_tree,
)

__all__ = [
    "BOUNDS",
    "Histogram",
    "describe",
    "access_enabled",
    "access_log",
    "slow_request",
    "slow_threshold_s",
    "REGISTRY",
    "Metric",
    "Registry",
    "metric",
    "render_labels",
    "RING",
    "SpanRing",
    "TraceContext",
    "activate",
    "bind",
    "current",
    "event",
    "maybe_start",
    "mint_trace_id",
    "sample_period",
    "span",
    "trace_spans",
    "trace_tree",
]
