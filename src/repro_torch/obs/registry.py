"""Metric registry + Prometheus text exposition (``GET /metrics``).

A :class:`Registry` owns named metric families.  Histograms register
lazily per label set (:meth:`Registry.histogram` returns the same
:class:`~repro_torch.obs.hist.Histogram` for the same ``(name, labels)`` every
time — callers observe without holding references).  Counters and gauges
are *collected*, not stored: the live system already maintains its
counters (`PathStats`, cache/queue counters, heat maps), so scrape-time
collectors translate them into samples instead of double-counting into a
second store.  :meth:`prometheus_text` renders the whole registry in the
Prometheus text exposition format (version 0.0.4).

One process-global :data:`REGISTRY` backs the HTTP surface; tests and
benches build private registries for isolation.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..analysis.witness import ordered_lock
from .hist import Histogram

__all__ = ["Labels", "Sample", "Metric", "Registry", "REGISTRY", "render_labels"]

# Label sets travel as sorted tuples of (key, value) so they hash.
Labels = Tuple[Tuple[str, str], ...]
# One exposed number: (labels, value).
Sample = Tuple[Labels, float]


class Metric:
    """One collected family: name, type, help, and its current samples."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help_text: str, samples: Iterable[Sample]):
        self.name = name
        self.mtype = mtype  # "counter" | "gauge"
        self.help = help_text
        self.samples = list(samples)


def _labels(labels: Optional[Dict[str, object]]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def render_labels(labels: Labels) -> str:
    """``key="value",...`` body (escaped) for one sample's label set."""
    parts = []
    for k, v in labels:
        v = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return ",".join(parts)


class Registry:
    """Histogram families + scrape-time collectors, rendered as text."""

    def __init__(self):
        self._lock = ordered_lock("obs.registry", 91)
        # {name: (help, {labels: Histogram})}
        self._hists: Dict[str, Tuple[str, Dict[Labels, Histogram]]] = {}
        self._collectors: List[Callable[[], Iterable[Metric]]] = []

    # -- histograms ---------------------------------------------------------
    def histogram(
        self,
        name: str,
        labels: Optional[Dict[str, object]] = None,
        help_text: str = "",
    ) -> Histogram:
        """The histogram for ``(name, labels)``, created on first use."""
        key = _labels(labels)
        with self._lock:
            entry = self._hists.get(name)
            if entry is None:
                entry = self._hists[name] = (help_text, {})
            series = entry[1]
            hist = series.get(key)
            if hist is None:
                hist = series[key] = Histogram()
            return hist

    def histograms(self, name: str) -> Dict[Labels, Histogram]:
        """Every label set of one family (live objects — merge, don't
        mutate)."""
        with self._lock:
            entry = self._hists.get(name)
            return dict(entry[1]) if entry else {}

    # -- collectors ---------------------------------------------------------
    def add_collector(self, fn: Callable[[], Iterable[Metric]]) -> None:
        """Register a scrape-time source of counter/gauge metrics."""
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], Iterable[Metric]]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -- exposition ---------------------------------------------------------
    def prometheus_text(self, extra: Iterable[Metric] = ()) -> str:
        """The Prometheus text exposition of everything registered plus
        ``extra`` metrics the caller collected itself (e.g. per-dataset
        store counters the registry has no handle on)."""
        lines: List[str] = []
        with self._lock:
            hists = {name: (h, dict(series)) for name, (h, series) in self._hists.items()}
            collectors = list(self._collectors)
        for name in sorted(hists):
            help_text, series = hists[name]
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} histogram")
            for labels in sorted(series):
                lines.extend(series[labels].prometheus_lines(name, render_labels(labels)))
        metrics: List[Metric] = []
        for fn in collectors:
            metrics.extend(fn())
        metrics.extend(extra)
        for metric in metrics:
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.mtype}")
            for labels, value in metric.samples:
                body = render_labels(labels)
                head = f"{{{body}}}" if body else ""
                if float(value) == int(value):
                    rendered = str(int(value))
                else:
                    rendered = format(float(value), ".9g")
                lines.append(f"{metric.name}{head} {rendered}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every histogram series and collector (test isolation)."""
        with self._lock:
            self._hists.clear()
            self._collectors.clear()


def metric(
    name: str,
    mtype: str,
    help_text: str,
    samples: Sequence[Tuple[Dict[str, object], float]],
) -> Metric:
    """Convenience constructor taking plain label dicts."""
    return Metric(name, mtype, help_text, [(_labels(ls), float(v)) for ls, v in samples])


#: The process-global registry the HTTP surface exposes.
REGISTRY = Registry()
