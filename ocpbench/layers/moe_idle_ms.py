"""``moe_idle_ms.*``: how long the device waits inside the MoE a unit of the
mix's phase (``phase_of``): the time within the host intervals of the
program's four MoE spans (``moe.route``, ``.dispatch``, ``.experts``,
``.combine``) inside that phase's range in which no operation ran on the
device, in the traced iteration: a sync in the routing shows here."""
from ocpbench.rooflines import PHASE_RANGE, per_unit

SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(name, run):
    if run.trace is None:
        return None
    phase = run.phase("moe_idle_ms")
    idle, n = run.trace.idle_within(SPANS, PHASE_RANGE.get(phase)), per_unit(run, phase)
    return None if idle is None or not n else 1e3 * idle / n
