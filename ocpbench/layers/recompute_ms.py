"""``recompute_ms.*``: the device time a step launched inside the program's
``*.recompute`` ranges (the kernels' backward recomputes through their
plain versions), in the traced step."""


def read(name, run):
    if run.trace is None:
        return None
    s = sum(v for k, v in run.trace.ranges.items() if k.endswith(".recompute"))
    return 1e3 * s if s > 0 else None
