"""``prefill_ms.*``: the prefill step's time on the host clock, from the
prompts handed to it to a sync after it: the window's total over its
count."""


def read(name, run):
    xs = run.host.get("prefill_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
