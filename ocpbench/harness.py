"""One run of one cell: set-up, the measured window, the traced iteration,
the check against the reference, and the result line.

Everything particular to a configuration, a traffic mix or kind, a cell's
limits or a per-layer metric family is a file found by its name in
``BENCHMARK.json`` (`files`): ``configs/<file>`` (the ``file`` of the
config entry, from the checkout's root), and under the benchmark's
directory ``mixes/<traffic>.json``, ``limits/<cell>.json``,
``layers/<family>.py`` (a metric's name up to its first dot),
``kinds/<kind>.py`` and ``reference/<name>.py``.  A kernel that a mix names
is counted through ``repro_torch.kernels.<name>.ops``.
"""
from __future__ import annotations

import dataclasses
import importlib
import pathlib
import subprocess
import sys
from contextlib import nullcontext
from typing import Dict, List, Optional

import torch

from repro_torch.models import moe as moe_mod

from . import files
from . import trace as trace_mod
from .counts import moe_lm as counts
from .files import HERE, load_json
from .traffic import KINDS, now

# every run counts these, and the kernels its mix names (`counter`)
COUNTED = ("flash_attention", "flash_decode", "moe_gemm", "cutout_gather")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """A cell and what its names lead to."""
    name: str
    entry: Dict
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    here: pathlib.Path = HERE  # the benchmark's directory: kinds, readers, references


def cell(bench: Dict, name: str, root: pathlib.Path, here: pathlib.Path = HERE) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name=name, entry=entry, config=load_json(root / conf["file"]),
                mix=load_json(here / "mixes" / f"{entry['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, here=here)


def reader(family: str, here: pathlib.Path = HERE):
    """The reader of a per-layer metric family: ``layers/<family>.py``."""
    return files.module(here, "layers", family)


def kind(name: str, here: pathlib.Path = HERE):
    """The traffic class of a mix's ``kind``: `traffic.KINDS`'s, else the
    class ``Kind`` of ``kinds/<name>.py``."""
    return KINDS[name] if name in KINDS else files.module(here, "kinds", name).Kind


def counter(kernel: str):
    """The launch counter of a kernel: its ``ops`` module (``launches``,
    ``reset_launches``)."""
    return importlib.import_module(f"repro_torch.kernels.{kernel}.ops")


@dataclasses.dataclass
class Run:
    """What a traced run hands the readers: the trace, the launches and
    per-call shapes of the one traced iteration, and the window's host
    clock readings and MoE dispatches."""
    model: Optional[Dict]  # None for a configuration without a model
    mix: Dict
    peaks: Optional[Dict[str, float]]
    trace: Optional[trace_mod.Summary]
    dispatches: List[Dict]
    host: Dict[str, List[float]]
    calls: Dict[str, list]
    launches: Dict[str, int]

    def phase(self, family: str) -> Optional[str]:
        """The phase of the traffic that the metric family reads in this
        mix (``phase_of`` in the mix file; all phases where absent)."""
        return self.mix.get("phase_of", {}).get(family)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(c: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, log=print) -> Dict:
    """The run's result: the contract's keys, the checks last."""
    cuda = device.type == "cuda"
    traffic = kind(c.mix["kind"], c.here)(c.config, c.mix, seed, device, c.here)
    traffic.setup()
    counters = {k: counter(k) for k in (*COUNTED, *c.mix["kernels"])}
    for ops in counters.values():
        ops.reset_launches()
    t_window = now()
    setup_s = t_window - t_start
    with moe_mod.observe(traffic.dispatches) if traced else nullcontext():
        traffic.window(seconds, traced)
        launched = {k: counters[k].launches for k in c.mix["kernels"]}
        summary, launches = None, {}
        if traced:
            for ops in counters.values():
                ops.reset_launches()
            traffic.dispatches.traced = True
            sync = traffic.sync if cuda else (lambda: None)
            _, events, wall = trace_mod.profile(traffic.iteration, sync)
            summary = trace_mod.summarize(events, wall)
            launches = {k: ops.launches for k, ops in counters.items()}
    traffic.dispatches.read()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = traffic.end_to_end()
    traffic.free()
    t_check = now()
    checks = traffic.check()
    # on the CPU the program runs its kernels' plain versions: nothing launches
    unlaunched = sum(1 for v in launched.values() if v == 0)
    checks["kernels_unlaunched"] = float(unlaunched) if cuda else 0.0
    log(f"check {now() - t_check:.1f} s; window {traffic.window_s:.3f} s; set-up "
        f"{setup_s:.3f} s; launches in the window {launched}")

    metrics = {}
    if not traced:
        for m in c.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        run = Run(model=c.config.get("model"), mix=c.mix,
                  peaks=counts.peaks(name) if cuda else None, trace=summary,
                  dispatches=traffic.dispatches.records, host=traffic.host,
                  calls=traffic.calls, launches=launches)
        for m in c.per_layer:
            value = reader(m["name"].split(".")[0], c.here).read(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = c.limits
    missing = sorted(set(limits) - set(checks))
    if missing:
        raise RuntimeError(f"limits without a reading: {missing}")
    compared = {k: {"value": checks[k], "limit": limits[k]} for k in sorted(limits)}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = power_limit()
    out = {"correct": bool(correct), "attempted": int(traffic.attempted),
           "failed": int(traffic.failed), "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = summary.breakdown
    out["checks"] = compared
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the whole name before the first dot)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})
