"""``optimizer_ms.*``: the device time a step launched inside the program's
``train_step.optimizer`` range, in the traced step."""


def read(name, run):
    if run.trace is None:
        return None
    s = run.trace.ranges.get("train_step.optimizer", 0.0)
    return 1e3 * s if s > 0 else None
