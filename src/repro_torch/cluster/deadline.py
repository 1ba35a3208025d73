"""Per-request deadline budgets for degraded-mode data paths.

A budget is a thread-local wall-clock allowance opened at the edge of a
request (the HTTP front door wraps every data-plane verb in one, sized by
its ``deadline_ms``, 2,000 ms by default) and consulted deep inside the
cluster's replicated read paths: each replica attempt is waited on for at
most the *remaining* budget, so a hung node can delay a request by its
deadline — never stall it indefinitely — before the read fails over to the
next surviving member.

Library callers that open no budget are unaffected: ``remaining()``
returns ``None`` and the cluster waits on nodes exactly as before.  The
budget only ever *shrinks* when nested, so an inner stage can tighten but
not extend the caller's allowance.  The budget is not carried into pool
threads by itself: a thread that does another request's work (the front
door's coalescer, its leader or the cluster's batch pool) runs it under
that request's own budget, taken with `expiry()` where the request was
admitted and installed with `adopt()`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

DEFAULT_DEADLINE_MS = 2000.0

_local = threading.local()


def default_budget_s(ms: Optional[float] = DEFAULT_DEADLINE_MS) -> Optional[float]:
    """A per-request allowance of ``ms`` milliseconds in seconds; ``None``
    when deadlines are disabled (``None``, zero or a negative value)."""
    if ms is None or ms <= 0:
        return None
    return ms / 1000.0


@contextlib.contextmanager
def budget(seconds: Optional[float] = DEFAULT_DEADLINE_MS / 1000.0):
    """Open a deadline budget of ``seconds`` for the calling thread.

    ``seconds=None`` opens none of its own (deadlines disabled): whatever
    budget is already active stays.  Nested budgets never extend an
    enclosing one — the tighter deadline wins.
    """
    prev = getattr(_local, "expires", None)
    if seconds is None:
        expires = prev  # disabled: inherit whatever is already active
    else:
        expires = time.monotonic() + float(seconds)
        if prev is not None:
            expires = min(expires, prev)
    _local.expires = expires
    try:
        yield
    finally:
        _local.expires = prev


def remaining() -> Optional[float]:
    """Seconds left in the active budget (clamped at 0), or ``None`` when
    the calling thread has no budget open — unbounded, the pre-deadline
    behaviour."""
    expires = getattr(_local, "expires", None)
    if expires is None:
        return None
    return max(0.0, expires - time.monotonic())


def expiry() -> Optional[float]:
    """The calling thread's budget as an absolute `time.monotonic()`
    instant, or ``None`` when it has none open."""
    return getattr(_local, "expires", None)


@contextlib.contextmanager
def adopt(expires: Optional[float]):
    """Run under another request's budget: install the instant ``expires``
    (its `expiry()`) in place of the calling thread's own, earlier or
    later, and restore the thread's own on exit."""
    prev = getattr(_local, "expires", None)
    _local.expires = expires
    try:
        yield
    finally:
        _local.expires = prev
