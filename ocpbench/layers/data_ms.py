"""``data_ms.*``: the data pipeline's time a step (`DataPipeline.get_batch`
with a sync after it, on the host clock), the window's mean."""


def read(name, run):
    xs = run.host.get("data_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
