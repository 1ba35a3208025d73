"""``moe_dispatch_ms.*``: the device time of the MoE's routing a unit of the
mix's phase (``phase_of``; a train step, a prefill or a decode step): the
ops launched inside the program's ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans in that phase's range of the traced iteration, not
``moe.experts`` (the expert GEMM, read by ``moe_gemm_roofline``)."""
from ocpbench.rooflines import PHASE_RANGE, per_unit

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(name, run):
    if run.trace is None:
        return None
    phase = run.phase("moe_dispatch_ms")
    ops = run.trace.within(SPANS, PHASE_RANGE.get(phase))
    n = per_unit(run, phase)
    return 1e3 * sum(o.seconds for o in ops) / n if ops and n else None
