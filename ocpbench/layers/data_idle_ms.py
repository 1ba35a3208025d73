"""``data_idle_ms.*``: how long the device waits for the data pipeline a
batch: the time within the host intervals of the program's
``data.get_batch`` span in which no operation ran on the device, in the
traced iteration, over its calls."""


def read(name, run):
    if run.trace is None:
        return None
    idle = run.trace.idle_within(("data.get_batch",))
    n = len(run.trace.spans.get("data.get_batch", ()))
    return None if idle is None else 1e3 * idle / n
