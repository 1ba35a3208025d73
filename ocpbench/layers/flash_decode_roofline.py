"""``flash_decode_roofline.*``: the decode attention kernel's share of its
roofline in the traced iteration: each decode step's call in each layer
at its cache length (the frozen count), over the device time of the
kernels named ``flash_decode*`` in the decode range."""
from ocpbench.counts import moe_lm as counts
from ocpbench.rooflines import kernel_share


def read(name, run):
    steps, L = run.calls.get("flash_decode"), run.model["n_layers"]
    if run.peaks is None or not steps or run.launches.get("flash_decode") != L * len(steps):
        return None
    least = L * sum(counts.least_s(*counts.flash_decode_call(run.model, B, [n] * B), run.peaks)
                    for B, n in steps)
    return kernel_share(run, "flash_decode", least, "decode")
