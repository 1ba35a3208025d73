"""``moe_drop_share.*``: the share of the MoE's picks dropped at a full
expert, over every dispatch of the mix's phase for this family
(``phase_of``) in the window, read through the program's `observe` hook."""
from ocpbench.rooflines import records


def read(name, run):
    recs = records(run, run.phase("moe_drop_share"), traced=False)
    picks = sum(r["picks"] for r in recs)
    return 100.0 * sum(r["dropped"] for r in recs) / picks if picks else None
