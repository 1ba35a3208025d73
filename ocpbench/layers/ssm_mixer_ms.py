"""``ssm_mixer_ms.*``: the device time of the Mamba-2 mixer outside its scan,
a unit of the mix's phase (``phase_of``; a train step): the ops launched
inside the program's ``ssm.inputs`` (projections, causal conv, softplus)
and ``ssm.output`` (skip, gate, norm, out-projection) spans in that
phase's range of the traced iteration, forward and recompute; not
``ssm.scan`` (read by ``ssd_scan_roofline``).  Nothing where the program
opens no such span."""
from ocpbench.rooflines import PHASE_RANGE, per_unit

SPANS = ("ssm.inputs", "ssm.output")


def read(name, run):
    if run.trace is None:
        return None
    phase = run.phase("ssm_mixer_ms")
    ops = run.trace.within(SPANS, PHASE_RANGE.get(phase))
    n = per_unit(run, phase)
    return 1e3 * sum(o.seconds for o in ops) / n if ops and n else None
