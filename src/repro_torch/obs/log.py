"""Structured (JSON-lines) logging: access log + slow-request dumps.

The stdlib ``BaseHTTPRequestHandler`` writes raw access lines to stderr,
which interleaves with test output and bench tables.  This module gives
the front door a structured replacement that is **silent by default**:

* ``configure(access_log=True)`` — emit one JSON line per HTTP request
  (method, path, status, duration, trace id when sampled).
* ``configure(slow_ms=<threshold>)`` — any request slower than the
  threshold dumps a structured ``slow_request`` record carrying its span
  tree (the trace the operator would otherwise have to re-trigger and
  re-capture).

Records go through a standard :mod:`logging` logger (``repro_torch.obs``), so
embedders can attach their own handlers; when nothing is configured and
a record *is* enabled, a stderr handler is attached lazily on first use.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any, Dict, Optional

from ..analysis.witness import ordered_lock

__all__ = ["LOGGER", "configure", "access_enabled", "slow_threshold_s", "access_log",
           "slow_request", "emit"]

LOGGER = logging.getLogger("repro_torch.obs")
LOGGER.setLevel(logging.INFO)

_handler_lock = ordered_lock("obs.log", 93)

_ACCESS_LOG = False
_SLOW_MS: Optional[float] = None


def configure(access_log: Optional[bool] = None, slow_ms: Optional[float] = None) -> None:
    """Set the access log on or off and the slow-request threshold in ms
    (negative = off); an argument left ``None`` keeps its setting.  Both
    start off."""
    global _ACCESS_LOG, _SLOW_MS
    if access_log is not None:
        _ACCESS_LOG = bool(access_log)
    if slow_ms is not None:
        _SLOW_MS = float(slow_ms)


def _ensure_handler() -> None:
    """Attach a stderr JSON-line handler once, only when something is
    actually emitted — a logger with no records configures nothing."""
    if LOGGER.handlers or LOGGER.propagate and logging.getLogger().handlers:
        return
    with _handler_lock:
        if LOGGER.handlers:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(message)s"))
        LOGGER.addHandler(handler)
        LOGGER.propagate = False


def access_enabled() -> bool:
    return _ACCESS_LOG


def slow_threshold_s() -> Optional[float]:
    """The slow-request threshold as seconds, or ``None`` when off."""
    ms = _SLOW_MS
    if ms is None:
        return None
    return ms / 1000.0 if ms >= 0 else None


def emit(kind: str, **fields: Any) -> None:
    """One JSON line: ``{"kind": ..., "ts": ..., **fields}``."""
    _ensure_handler()
    record: Dict[str, Any] = {"kind": kind, "ts": round(time.time(), 6)}
    record.update(fields)
    LOGGER.info(json.dumps(record, default=str, separators=(",", ":")))


def access_log(
    method: str,
    path: str,
    status: int,
    dur_s: float,
    trace_id: Optional[str] = None,
) -> None:
    """One structured access-log line, when the access log is on."""
    if not access_enabled():
        return
    fields: Dict[str, Any] = {
        "method": method,
        "path": path,
        "status": int(status),
        "dur_ms": round(dur_s * 1e3, 3),
    }
    if trace_id:
        fields["trace"] = trace_id
    emit("access", **fields)


def slow_request(
    method: str,
    path: str,
    dur_s: float,
    trace_id: Optional[str],
    tree: Any,
) -> None:
    """Threshold-triggered span-tree dump (caller already checked the
    duration against :func:`slow_threshold_s`)."""
    emit(
        "slow_request",
        method=method,
        path=path,
        dur_ms=round(dur_s * 1e3, 3),
        threshold_ms=round((slow_threshold_s() or 0.0) * 1e3, 3),
        trace=trace_id,
        spans=tree,
    )
