"""Streaming latency histograms: fixed log-spaced buckets, mergeable.

Every :class:`Histogram` in the process shares ONE bucket layout —
``BOUNDS[i] = 1e-6 * 2**i`` seconds, from 1µs up past a minute, plus the
+Inf overflow — so histograms merge across nodes, shards, and runs by
plain bucket-count addition (associative and commutative; the test suite
asserts both and that counts are conserved).  That is the property the
cluster needs: each node observes locally with no coordination, and the
``/metrics`` scrape (or a bench harness) merges after the fact.

``observe`` is lock-cheap: one ``bisect`` on a 27-entry tuple and three
updates under a short lock.  Percentiles are read from the bucket CDF
(upper bucket edge — a conservative estimate, exact to within one
log-bucket's resolution), which is how the bench sections report p50/p99
without keeping raw samples.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence

from ..analysis.witness import ordered_lock

__all__ = ["BOUNDS", "Histogram"]

# Upper bucket bounds in seconds: 1µs, 2µs, 4µs, ... ~67s (27 buckets),
# then +Inf.  Fixed for the whole process so histograms always merge.
BOUNDS: Sequence[float] = tuple(1e-6 * 2.0**i for i in range(27))


class Histogram:
    """One metric's latency distribution over the shared log buckets."""

    __slots__ = ("counts", "count", "sum", "_lock")

    def __init__(self):
        self.counts = [0] * (len(BOUNDS) + 1)  # last slot = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self._lock = ordered_lock("obs.hist", 92)

    # -- recording ----------------------------------------------------------
    def observe(self, seconds: float) -> None:
        idx = bisect_left(BOUNDS, seconds)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += seconds

    class _Timer:
        __slots__ = ("_hist", "_t0")

        def __init__(self, hist: "Histogram"):
            self._hist = hist
            self._t0 = 0.0

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._hist.observe(time.perf_counter() - self._t0)
            return False

    def time(self) -> "Histogram._Timer":
        """``with hist.time(): ...`` — observe one timed block."""
        return Histogram._Timer(self)

    # -- merging (the cross-node property) ----------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        """A NEW histogram holding both inputs' observations (inputs are
        untouched) — bucket-wise addition over the shared bounds."""
        out = Histogram()
        with self._lock:
            mine = list(self.counts)
            my_count, my_sum = self.count, self.sum
        with other._lock:
            theirs = list(other.counts)
            their_count, their_sum = other.count, other.sum
        out.counts = [a + b for a, b in zip(mine, theirs)]
        out.count = my_count + their_count
        out.sum = my_sum + their_sum
        return out

    @classmethod
    def merged(cls, parts: Iterable["Histogram"]) -> "Histogram":
        out = cls()
        for part in parts:
            out = out.merge(part)
        return out

    # -- reading ------------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` in [0, 1] (0.0 if empty).

        Overflow observations report the last finite bound ×2 — a floor,
        flagged by being beyond every bucket."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                return BOUNDS[i] if i < len(BOUNDS) else BOUNDS[-1] * 2.0
        return BOUNDS[-1] * 2.0

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "bounds": list(BOUNDS),
                "counts": list(self.counts),
                "count": self.count,
                "sum": self.sum,
            }

    def prometheus_lines(self, name: str, label_str: str) -> List[str]:
        """The text-exposition lines for one labeled histogram series:
        cumulative ``_bucket{le=...}`` rows, then ``_sum`` / ``_count``.
        ``label_str`` is the pre-rendered ``key="value",...`` body (may be
        empty)."""
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        sep = "," if label_str else ""
        lines = []
        cum = 0
        for bound, c in zip(BOUNDS, counts):
            cum += c
            le = format(bound, ".9g")
            lines.append(f'{name}_bucket{{{label_str}{sep}le="{le}"}} {cum}')
        lines.append(f'{name}_bucket{{{label_str}{sep}le="+Inf"}} {total}')
        head = f"{{{label_str}}}" if label_str else ""
        lines.append(f"{name}_sum{head} {format(s, '.9g')}")
        lines.append(f"{name}_count{head} {total}")
        return lines

    def __repr__(self) -> str:
        p50 = self.percentile(0.5)
        p99 = self.percentile(0.99)
        return f"Histogram(n={self.count}, p50={p50:.6f}s, p99={p99:.6f}s)"


def _fmt_seconds(seconds: float) -> str:
    if seconds <= 0:
        return "0"
    exp = math.floor(math.log10(seconds))
    if exp >= 0:
        return f"{seconds:.2f}s"
    if exp >= -3:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds * 1e6:.0f}us"


def describe(hist: Histogram) -> str:
    """Human one-liner for bench ``derived`` columns: p50/p99 from the
    bucket CDF, never from raw samples."""
    return (
        f"p50={_fmt_seconds(hist.percentile(0.5))}"
        f";p99={_fmt_seconds(hist.percentile(0.99))}"
        f";n={hist.count}"
    )
