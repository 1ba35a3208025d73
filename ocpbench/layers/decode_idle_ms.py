"""``decode_idle_ms.*``: how long the device waits a decode step for the
host's launches (A9): in the traced batch, the device's idle time between
the ops launched inside ``ocpbench.decode`` (their span on the device less
the union of their intervals), over the batch's decode steps."""


def read(name, run):
    steps = run.calls.get("flash_decode")
    if run.trace is None or not steps:
        return None
    idle = run.trace.idle_s("ocpbench.decode")
    return None if idle is None else 1e3 * idle / len(steps)
