"""The device trace of a traced run, reduced to what the readers need.

`profile` runs a function under `torch.profiler` (CPU and CUDA activity)
and reads the profiler's raw events (`from_kineto`; the profiler's own
event tree costs ~50 us an event to build).  `Events` holds them in
plain lists, so a trace saved as JSON reads the same way (`from_json`).
`summarize` reduces them:

- ``busy_s``: the union of the intervals in which an operation ran on
  the device (kernels, copies, fills; overlapping work counts once);
- ``ops``: each device operation with the host ranges that hold the host
  call that launched it (the two share a correlation id): every named
  range of the trace, the benchmark's ``ocpbench.*`` ranges and each span
  that the program opens (`repro_torch.obs.trace.span`), so that a reader
  of a new span is a new file;
- ``ranges``: the device time launched inside each named range, and
  (`Summary.idle_s`) the device's waits between the ops of one range;
- ``spans``: each range's host intervals, and ``busy``: the merged
  intervals in which the device ran something, so that
  (`Summary.idle_within`) the device's idle time inside host intervals
  can be read;
- ``breakdown``: the operations that took most device time, and the
  longest idle gaps by the innermost host event under each.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# the host ranges reported even where the trace holds none (their device
# time 0): the benchmark's phases and the program's train step parts and
# kernel recomputes; every other named range of a trace is reported beside
RANGES = ("ocpbench.prefill", "ocpbench.decode", "ocpbench.train_step",
          "ocpbench.get_batch", "train_step.forward", "train_step.backward",
          "train_step.optimizer", "flash_attention.recompute", "moe_gemm.recompute",
          "ssd_scan.recompute")
TOP = 10
LOOK_BACK = 4096  # host events searched back from an idle gap for one spanning it


@dataclasses.dataclass
class Events:
    """Raw events, times in ns: device ops (name, start, end, correlation
    id), host launches (correlation id -> start), host ranges (name,
    start, end) and other host events (name, start, end)."""
    device: List[Tuple[str, int, int, int]]
    launches: Dict[int, int]
    ranges: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]


def from_json(obj: Dict) -> Events:
    """`Events` from a trace saved as JSON (the dataclass's fields, the
    launches as [correlation id, start] pairs)."""
    return Events(device=[tuple(x) for x in obj["device"]],
                  launches={int(k): int(v) for k, v in obj["launches"]},
                  ranges=[tuple(x) for x in obj["ranges"]],
                  host=[tuple(x) for x in obj["host"]])


def from_kineto(prof) -> Events:
    ev = Events([], {}, [], [])
    for e in prof.profiler.kineto_results.events():
        on_device = not str(e.device_type()).endswith("CPU")
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.is_user_annotation():
            if not on_device:
                ev.ranges.append((name, start, end))
        elif on_device:
            ev.device.append((name, start, end, e.correlation_id()))
        else:
            if name.startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync, ...
                ev.launches[e.correlation_id()] = start
            ev.host.append((name, start, end))
    return ev


def profile(fn: Callable, sync: Callable[[], None]):
    """(fn's result, its `Events`, the traced window's wall seconds)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, from_kineto(prof), wall


def union_s(intervals: Sequence[Tuple[int, int]]) -> Tuple[float, List[Tuple[int, int]]]:
    """(seconds covered by the union of [start, end) ns intervals, the
    merged intervals in order)."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e9, [(a, b) for a, b in merged]


@dataclasses.dataclass
class Op:
    name: str
    seconds: float
    ranges: frozenset
    start: int = 0  # ns on the device
    end: int = 0


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: List[Op]
    ranges: Dict[str, float]
    breakdown: Dict[str, list]
    spans: Dict[str, List[Tuple[int, int]]]  # each range's host intervals, in order
    busy: List[Tuple[int, int]]  # the device's busy intervals, merged, in order

    def device_s(self, match: Callable[[str], bool], within: Optional[str] = None) -> float:
        """Device seconds of the ops whose name ``match``es, launched
        inside range ``within`` (anywhere where None)."""
        return sum(o.seconds for o in self.ops
                   if match(o.name) and (within is None or within in o.ranges))

    def idle_s(self, within: str) -> Optional[float]:
        """Seconds in which the device waited between the ops launched
        inside range ``within``: their span on the device (the first one's
        start to the last one's end) less the union of their intervals;
        None where none was launched there."""
        ivs = [(o.start, o.end) for o in self.ops if within in o.ranges]
        if not ivs:
            return None
        busy, _ = union_s(ivs)
        return (max(b for _, b in ivs) - min(a for a, _ in ivs)) / 1e9 - busy

    def within(self, names: Sequence[str], inside: Optional[str] = None) -> List[Op]:
        """The ops launched inside any of the ranges ``names``, and inside
        range ``inside`` where given."""
        names = frozenset(names)
        return [o for o in self.ops
                if o.ranges & names and (inside is None or inside in o.ranges)]

    def idle_within(self, names: Sequence[str], inside: Optional[str] = None) -> Optional[float]:
        """Seconds of the host intervals of the ranges ``names`` (those that
        lie inside an interval of range ``inside``, where given; their
        union) in which no operation ran on the device.  None where the
        trace holds no such interval or no device operation."""
        ivs = [iv for n in names for iv in self.spans.get(n, ())]
        if inside is not None:
            outer = self.spans.get(inside, [])
            ivs = [(a, b) for a, b in ivs if any(oa <= a and b <= ob for oa, ob in outer)]
        if not ivs or not self.busy:
            return None
        total, merged = union_s(ivs)
        starts = [a for a, _ in self.busy]
        covered = 0
        for a, b in merged:
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(self.busy) and self.busy[i][0] < b:
                covered += max(0, min(b, self.busy[i][1]) - max(a, self.busy[i][0]))
                i += 1
        return total - covered / 1e9


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _under(ev: Events, host, host_starts, t: int) -> str:
    """The innermost host event spanning time t: the latest-starting host
    op among the last `LOOK_BACK` begun by then, else the latest-starting
    range."""
    i = bisect.bisect_right(host_starts, t) - 1
    for j in range(i, max(i - LOOK_BACK, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    spanning = [(a, n) for n, a, b in ev.ranges if a <= t <= b]
    return max(spanning)[1] if spanning else "(no host event)"


def summarize(ev: Events, window_s: float) -> Summary:
    spans: Dict[str, List[Tuple[int, int]]] = {n: [] for n in RANGES}
    for n, a, b in ev.ranges:
        spans.setdefault(n, []).append((a, b))
    starts = {}
    for n in spans:
        spans[n].sort()
        starts[n] = [a for a, _ in spans[n]]

    def holding(t: Optional[int]) -> frozenset:
        if t is None:
            return frozenset()
        inside = []
        for n, occ in spans.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and t <= occ[i][1]:
                inside.append(n)
        return frozenset(inside)

    ops = [Op(n, (b - a) / 1e9, holding(ev.launches.get(corr)), a, b)
           for n, a, b, corr in ev.device]
    ranges = {n: sum(o.seconds for o in ops if n in o.ranges) for n in spans}
    busy, merged = union_s([(a, b) for _, a, b, _ in ev.device])

    by_name: Dict[str, float] = {}
    for o in ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.seconds
    top_ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]

    host = sorted(ev.host, key=lambda x: x[1])
    host_starts = [a for _, a, _ in host]
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])[:4 * TOP]
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        name = _under(ev, host, host_starts, (a + b) // 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e9
    idle = sorted(by_host.items(), key=lambda x: -x[1])[:TOP]
    breakdown = {"device_ops": [[_short(n), s] for n, s in top_ops],
                 "idle_gaps": [[_short(n), s] for n, s in idle]}
    return Summary(window_s=window_s, busy_s=busy, ops=ops, ranges=ranges,
                   breakdown=breakdown, spans=spans, busy=merged)
