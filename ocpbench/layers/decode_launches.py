"""``decode_launches.*``: the device operations (kernels, copies, fills) a
decode step launches: those launched inside the program's
``serve.decode_step`` span in the traced iteration, over its steps."""


def read(name, run):
    if run.trace is None:
        return None
    ops = run.trace.within(("serve.decode_step",))
    steps = len(run.trace.spans.get("serve.decode_step", ()))
    return len(ops) / steps if ops else None
