"""``mfu.*``: the whole step's share of the card's roofline: the least time
the model's own work allows (`counts.moe_lm`: the routed tokens' FLOPs,
no capacity padding, no recompute, the logits where the path computes
them; for a decode step also the bytes of the weights and experts it
touches and of the cache), over the window's time of that step on the
host clock.  The phase is the mix's ``phase_of`` for ``mfu``."""
from ocpbench.counts import moe_lm as counts
from ocpbench.rooflines import decode_least_s, records, share


def read(name, run):
    if run.peaks is None:
        return None
    m, mix, host = run.model, run.mix, run.host
    phase = run.phase("mfu")
    if phase == "train" and host.get("step_s"):
        least = counts.train_step_flops(m, mix["batch"], mix["seq_len"]) / run.peaks["flops"]
        return share(least * len(host["step_s"]), sum(host["step_s"]))
    if phase == "prefill" and host.get("prefill_s"):
        least = counts.prefill_flops(m, mix["batch"], mix["prompt"]) / run.peaks["flops"]
        return share(least * len(host["prefill_s"]), sum(host["prefill_s"]))
    if phase == "decode" and host.get("decode_s"):
        return share(decode_least_s(run, records(run, "decode", traced=False)),
                     sum(host["decode_s"]))
    return None
