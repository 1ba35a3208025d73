"""``ssm_mfu.*``: an SSM training step's share of the card's peak: the
model's own work (`counts.ssm_lm.train_step_flops`: 6 x parameters x
tokens and the SSD's products, no recompute) at the bf16 peak, over the
window's time of a step on the host clock.  The phase is the mix's
``phase_of`` for ``ssm_mfu``: ``train``, or nothing is read."""
from ocpbench.counts import ssm_lm
from ocpbench.rooflines import share


def read(name, run):
    steps = run.host.get("step_s")
    if run.peaks is None or run.phase("ssm_mfu") != "train" or not steps:
        return None
    flops = ssm_lm.train_step_flops(run.model, run.mix["batch"], run.mix["seq_len"])
    return share(flops / run.peaks["flops"] * len(steps), sum(steps))
