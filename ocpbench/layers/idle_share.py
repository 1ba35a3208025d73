"""``idle_share.*``: 1 less the union of the intervals in which an operation
ran on the device, over the traced window."""


def read(name, run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
