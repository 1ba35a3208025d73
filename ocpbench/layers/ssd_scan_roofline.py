"""``ssd_scan_roofline.*``: the chunked SSD scan's share of its roofline in
the traced iteration: the frozen count of each launch (`counts.ssm_lm`;
the launches of the iteration, each over a microbatch of the mix's
``batch / microbatches`` sequences of ``seq_len``) over the device time
of the kernel's bodies (``ssd_scan_tc``, ``ssd_scan_kernel``) in the
mix's phase."""
from ocpbench.counts import moe_lm, ssm_lm
from ocpbench.rooflines import kernel_share

NAMES = ("ssd_scan",)


def read(name, run):
    n = run.launches.get("ssd_scan", 0)
    if run.peaks is None or not n:
        return None
    mix = run.mix
    call = ssm_lm.ssd_scan_call(run.model, mix["batch"] // mix["microbatches"], mix["seq_len"])
    least = n * moe_lm.least_s(*call, run.peaks)
    return kernel_share(run, "ssd_scan", least, run.phase("ssd_scan_roofline"), NAMES)
