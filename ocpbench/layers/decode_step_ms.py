"""``decode_step_ms.*``: a decode step's time on the host clock: each
batch's decode loop, from its first step to its tokens on the host, the
window's total over its steps."""


def read(name, run):
    xs, n = run.host.get("decode_s"), run.host.get("decode_steps")
    return 1e3 * sum(xs) / sum(n) if xs and sum(n) else None
