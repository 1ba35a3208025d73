"""``flash_attention_roofline.*``: the attention kernel's share of its
roofline in the traced iteration: its launches (the program's counter)
times the frozen count of a causal call at the iteration's shape, over
the device time of the kernels named ``flash_attention*`` in the mix's
phase."""
from ocpbench.counts import moe_lm as counts
from ocpbench.rooflines import kernel_share


def read(name, run):
    shapes, n = run.calls.get("flash_attention"), run.launches.get("flash_attention", 0)
    if run.peaks is None or not shapes or not n:
        return None
    least = n * counts.least_s(*counts.flash_attention_call(run.model, *shapes[0]), run.peaks)
    return kernel_share(run, "flash_attention", least, run.phase("flash_attention_roofline"))
