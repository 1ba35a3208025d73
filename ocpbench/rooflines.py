"""The arithmetic the readers share: a share of the card's roofline is the
least time the frozen counts allow (`counts`) over the time measured; a
phase's range, and the units (steps, prefills, decode steps) that a
traced iteration holds."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ocpbench.counts import moe_lm as counts

PHASE_RANGE = {"train": "ocpbench.train_step", "prefill": "ocpbench.prefill",
               "decode": "ocpbench.decode"}
# the range that holds one unit of a phase: a step, a prefill, a decode step
UNIT_RANGE = {"train": "ocpbench.train_step", "prefill": "ocpbench.prefill",
              "decode": "serve.decode_step"}
KERNEL_NAMES = {"flash_attention": ("flash_attention",), "flash_decode": ("flash_decode",),
                "moe_gemm": ("moe_gate_up", "moe_down")}


def share(least_s: float, measured_s: float) -> Optional[float]:
    """100 x least / measured; None where nothing was measured."""
    if least_s <= 0 or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s


def kernel_device_s(run, kernel: str, phase: Optional[str],
                    names: Sequence[str] = ()) -> float:
    """Device seconds of the kernel's ops in the phase's range: the ops
    whose names hold one of `KERNEL_NAMES`' parts, or for a kernel not
    listed there the caller's ``names``."""
    names = KERNEL_NAMES.get(kernel, names)
    if not names:
        raise KeyError(f"no device-op names for the kernel {kernel!r}")
    return run.trace.device_s(lambda n: any(k in n for k in names),
                              PHASE_RANGE.get(phase) if phase else None)


def kernel_share(run, kernel: str, least_s: float, phase: Optional[str],
                 names: Sequence[str] = ()) -> Optional[float]:
    if run.trace is None or run.peaks is None:
        return None
    return share(least_s, kernel_device_s(run, kernel, phase, names))


def per_unit(run, phase: Optional[str]) -> int:
    """How many units of the phase the traced iteration holds: train
    steps, prefills or decode steps (the host intervals of `UNIT_RANGE`'s
    range; 0 where it holds none), or 1 (the whole iteration) where the
    phase is None."""
    if phase is None:
        return 1
    return len(run.trace.spans.get(UNIT_RANGE[phase], ()))


def records(run, phase: Optional[str], traced: bool) -> List[Dict]:
    return [r for r in run.dispatches
            if r["traced"] == traced and (phase is None or r["phase"] == phase)]


def decode_least_s(run, recs: List[Dict]) -> float:
    """The least time of the decode steps whose dispatches are ``recs``
    (each step one dispatch a layer, steps in order, batches of
    ``new_tokens - 1`` steps in turn)."""
    m, mix = run.model, run.mix
    L, B, P, steps = m["n_layers"], mix["batch"], mix["prompt"], mix["new_tokens"] - 1
    total = 0.0
    for s in range(len(recs) // L):
        layers = recs[s * L:(s + 1) * L]
        touched = [sum(1 for c in r["counts"] if c > 0) for r in layers]
        lens = [P + s % steps + 1] * B
        total += counts.least_s(*counts.decode_step_cost(m, B, lens, touched), run.peaks)
    return total
