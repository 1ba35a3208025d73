"""``moe_gemm_roofline.*``: the grouped expert GEMM's share of its roofline
in the traced iteration's calls of the mix's phase: the frozen count of
each call (its live rows, the experts it touches, read through the
program's `observe` hook) over the device time of the kernel's two
launches (``moe_gate_up*``, ``moe_down*``) in that phase's range."""
from ocpbench.counts import moe_lm as counts
from ocpbench.rooflines import kernel_share, records


def read(name, run):
    if run.peaks is None:
        return None
    phase = run.phase("moe_gemm_roofline")
    least = sum(counts.least_s(*counts.moe_gemm_call(run.model, r["C"], r["counts"]), run.peaks)
                for r in records(run, phase, traced=True))
    return kernel_share(run, "moe_gemm", least, phase)
