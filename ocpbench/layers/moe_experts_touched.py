"""``moe_experts_touched.*``: the experts that receive a pick, a dispatch (a
layer and a step) of the mix's phase for this family (``phase_of``), the
window's mean, read through the program's `observe` hook: at decode each
one's weights are read, so the step's bytes follow it."""
from ocpbench.rooflines import records


def read(name, run):
    recs = records(run, run.phase("moe_experts_touched"), traced=False)
    if not recs:
        return None
    return sum(sum(1 for c in r["counts"] if c > 0) for r in recs) / len(recs)
