"""Port parity: `obs` (histograms, registry, spans, structured log) and the
lock-order witness.

The same observations go into the reference's `repro.obs` and the port's
`repro_torch.obs`: percentiles, merges, Prometheus lines and registry
text must be equal, and so must the access-log and slow-request fields.
Both witnesses flag the same ABBA cycle, rank inversion and
submit-while-locked case.  A cold read and a compaction on the port open
the reference's spans and histogram.  Settings are arguments in the port
(`trace.configure`, `log.configure`, `witness.enable`) where the reference
reads ``REPRO_*`` variables.
"""
import json
import logging
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile
from torch_witness import port_witness  # noqa: F401

from repro.analysis import witness as jwitness
from repro.core import cutout as jcut
from repro.core import store as jstore
from repro.core.cuboid import DatasetSpec as JSpec
from repro.obs import hist as jhist
from repro.obs import log as jlog
from repro.obs import registry as jreg
from repro.obs import trace as jtrace
from repro_torch import carry
from repro_torch.analysis import witness as twitness
from repro_torch.core import cutout as tcut
from repro_torch.core.compact import compact_store
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import CuboidStore, DecodePolicy, DeviceCuboidStore
from repro_torch.core.wal import TierPolicy, tiered_store
from repro_torch.obs import hist as thist
from repro_torch.obs import log as tlog
from repro_torch.obs import registry as treg
from repro_torch.obs import trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from ocpbench import trace as bench_trace  # noqa: E402

SHAPE = (32, 32, 16)
CUBOID = (8, 8, 4)
WITNESSES = {"reference": jwitness, "port": twitness}


def observations(seed, n=300):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(-7.0 + seed, 2.5, size=n)] + [0.0, 1e9]


# ------------------------------------------------------------- histograms --


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_equal_the_reference(seed):
    j = [jhist.Histogram() for _ in range(3)]
    t = [thist.Histogram() for _ in range(3)]
    for i in range(3):
        for v in observations(seed + i):
            j[i].observe(v)
            t[i].observe(v)
    jm, tm = j[0].merge(j[1]).merge(j[2]), t[0].merge(t[1]).merge(t[2])
    assert tm.counts == jm.counts and tm.count == jm.count == sum(tm.counts)
    assert tm.sum == jm.sum
    assert t[0].merge(t[1]).counts == t[1].merge(t[0]).counts
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert tm.percentile(q) == jm.percentile(q)
    assert tm.prometheus_lines("x_seconds", 'k="v"') == jm.prometheus_lines("x_seconds", 'k="v"')
    assert tm.prometheus_lines("x_seconds", "") == jm.prometheus_lines("x_seconds", "")
    assert thist.describe(tm) == jhist.describe(jm)
    assert tm.snapshot() == jm.snapshot()


def test_registry_text_equals_the_reference():
    texts = []
    for hist_mod, reg_mod in ((jhist, jreg), (thist, treg)):
        reg = reg_mod.Registry()
        for i, v in enumerate(observations(3, 50)):
            reg.histogram("t_seconds", {"k": i % 3, "path": 'a"b'}, "a histogram").observe(v)
        reg.histogram("u_seconds").observe(0.25)
        reg.add_collector(lambda m=reg_mod: [m.metric("c_total", "counter", "a counter",
                                                      [({"n": "0"}, 3), ({"n": "1"}, 2.5)])])
        texts.append(reg.prometheus_text(
            extra=[reg_mod.metric("g", "gauge", "a gauge", [({"n": "0"}, 2.5)])]))
    assert texts[1] == texts[0]
    assert "# TYPE t_seconds histogram" in texts[1]


def test_access_log_fields_equal_the_reference(monkeypatch):
    """Off by default; with the access log on and a 0 ms threshold, the
    records carry the reference's fields (all but the time stamp)."""
    records = {"reference": [], "port": []}

    def capture(key):
        class Capture(logging.Handler):
            def emit(self, record):
                records[key].append(json.loads(record.getMessage()))
        return Capture()

    handlers = {"reference": capture("reference"), "port": capture("port")}
    jlog.LOGGER.addHandler(handlers["reference"])
    tlog.LOGGER.addHandler(handlers["port"])
    try:
        tlog.access_log("GET", "/d/cutout", 200, 0.0125, trace_id="ab")
        assert not records["port"] and tlog.slow_threshold_s() is None
        monkeypatch.setenv("REPRO_ACCESS_LOG", "1")
        monkeypatch.setenv("REPRO_SLOW_MS", "0")
        tlog.configure(access_log=True, slow_ms=0)
        tree = [{"name": "request", "children": []}]
        for mod in (jlog, tlog):
            mod.access_log("GET", "/d/cutout", 200, 0.0125, trace_id="ab")
            mod.access_log("PUT", "/d/cutout", 500, 1.5)
            assert mod.slow_threshold_s() == 0.0
            mod.slow_request("GET", "/d/cutout", 0.0125, "ab", tree)
        strip = [[{k: v for k, v in r.items() if k != "ts"} for r in records[k]]
                 for k in ("reference", "port")]
        assert strip[1] == strip[0] and len(strip[1]) == 3
    finally:
        tlog.configure(access_log=False, slow_ms=-1)
        jlog.LOGGER.removeHandler(handlers["reference"])
        tlog.LOGGER.removeHandler(handlers["port"])
    assert not tlog.access_enabled() and tlog.slow_threshold_s() is None


# ---------------------------------------------------------------- tracing --


def _traced_tree(trace_mod, fn, tid):
    ring = trace_mod.SpanRing(256)
    with trace_mod.activate(trace_mod.TraceContext(tid, ring)):
        fn()
    return trace_mod.trace_tree(tid, ring)


def _shape(tree):
    return [(s["name"], s["meta"], _shape(s["children"])) for s in tree]


def test_span_trees_equal_the_reference():
    """Nested spans, events and a span carried across a thread by `bind`
    give the same tree in both packages."""
    def work(mod):
        def fn():
            with mod.span("outer", k=1) as meta:
                meta["extra"] = 2
                mod.event("point", n=3)
                with mod.span("inner"):
                    pass
                t = threading.Thread(target=mod.bind(lambda: mod.event("in_thread")))
                t.start()
                t.join(timeout=10)
        return fn

    j = _traced_tree(jtrace, work(jtrace), "t1")
    t = _traced_tree(ttrace, work(ttrace), "t1")
    assert _shape(t) == _shape(j)
    assert [c["name"] for c in t[0]["children"]] == ["point", "inner", "in_thread"]


def test_untraced_instrumentation_is_inert_and_configure_sets_sampling():
    appended = ttrace.RING.counters()["appended"]
    with ttrace.span("x", k=1) as meta:
        assert meta is None
        ttrace.event("y")

    def fn():
        return 41
    assert ttrace.bind(fn) is fn
    assert ttrace.RING.counters()["appended"] == appended
    assert ttrace.maybe_start(None) is None          # default: never sample
    assert ttrace.maybe_start("feedface00000001") is not None
    try:
        ttrace.configure(sample=1)
        assert ttrace.sample_period() == 1 and ttrace.maybe_start(None) is not None
        ttrace.configure(sample=0.25)
        assert ttrace.sample_period() == 4
        ttrace.configure(ring=8)
        assert ttrace.RING.capacity == 8 and ttrace.RING.counters()["resident"] == 0
    finally:
        ttrace.configure(ring=4096, sample=0)
    assert ttrace.sample_period() == 0 and ttrace.RING.capacity == 4096


def test_span_with_nothing_active_is_the_null_object(monkeypatch):
    """No request trace and no profiler: the shared null object, no ring
    write, and no profiler range made."""
    def no_range(*a, **k):
        raise AssertionError("a profiler range was made with no profiler on")

    monkeypatch.setattr(torch_profiler, "record_function", no_range)
    appended = ttrace.RING.counters()["appended"]
    assert not torch_profiler._is_profiler_enabled
    s = ttrace.span("moe.route", k=1)
    assert s is ttrace._NULL
    with s as meta:
        assert meta is None
    assert ttrace.RING.counters()["appended"] == appended


def _profiled_ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch_profiler._is_profiler_enabled
        fn()
    assert not torch_profiler._is_profiler_enabled
    return bench_trace.from_kineto(prof)


def test_span_under_the_profiler_is_a_range_holding_its_ops():
    """Under `torch.profiler.profile` a span with no request trace is a
    profiler range of its name (yielding None, as untraced), and its
    interval holds the operations run inside it."""
    appended = ttrace.RING.counters()["appended"]

    def fn():
        with ttrace.span("outer.step") as meta:
            assert meta is None
            x = torch.ones(64) * 3.0
            with ttrace.span("inner.part"):
                torch.cumsum(x, 0)

    ev = _profiled_ranges(fn)
    ranges = {n: (a, b) for n, a, b in ev.ranges}
    assert set(ranges) >= {"outer.step", "inner.part"}
    (a, b), (ia, ib) = ranges["outer.step"], ranges["inner.part"]
    assert a <= ia <= ib <= b
    ops = {n: (s, e) for n, s, e in ev.host if n in ("aten::mul", "aten::cumsum")}
    assert set(ops) == {"aten::mul", "aten::cumsum"}
    for s, e in ops.values():
        assert a <= s <= e <= b
    cs, ce = ops["aten::cumsum"]
    assert ia <= cs <= ce <= ib
    assert ttrace.RING.counters()["appended"] == appended


def test_traced_request_under_the_profiler_records_both():
    """A request trace and the profiler at once: the ring gets the span
    tree with its annotations, and the profiler the ranges."""
    ring = ttrace.SpanRing(64)

    def fn():
        with ttrace.activate(ttrace.TraceContext("both", ring)):
            with ttrace.span("outer", k=1) as meta:
                meta["extra"] = 2
                with ttrace.span("inner"):
                    torch.ones(8).sum()

    ev = _profiled_ranges(fn)
    assert {"outer", "inner"} <= {n for n, _, _ in ev.ranges}
    tree = ttrace.trace_tree("both", ring)
    assert _shape(tree) == [("outer", {"k": 1, "extra": 2}, [("inner", {}, [])])]


def _cold_read_tree(trace_mod, read):
    return _traced_tree(trace_mod, read, "cold")


def test_cold_read_spans_equal_the_reference():
    """One cold read, one decode worker: ``plan``, then ``assemble`` holding
    the store's ``store.fetch`` and ``decode`` spans, as in the reference."""
    kw = dict(name="sp", volume_shape=SHAPE, dtype="uint8", base_cuboid=CUBOID)
    vol = np.random.default_rng(0).integers(1, 255, size=SHAPE, dtype=np.uint8)
    ref = jstore.CuboidStore(JSpec(**kw), decode_policy=jstore.DecodePolicy(workers=1))
    jcut.ingest(ref, 0, vol)
    host = CuboidStore(DatasetSpec(**kw), backend=carry.backend_from_items(
        carry.backend_items(ref.read_backend)), decode_policy=DecodePolicy(workers=1))
    dev = DeviceCuboidStore(host.spec, device="cpu", backing=host)
    lo, hi = (3, 4, 1), (29, 30, 15)
    j = _cold_read_tree(jtrace, lambda: jcut.cutout(ref, 0, lo, hi))
    t = _cold_read_tree(ttrace, lambda: tcut.cutout(dev, 0, lo, hi))
    names = lambda tree: [(s["name"], [c["name"] for c in s["children"]]) for s in tree]
    assert names(t) == names(j)
    assert names(t)[0][0] == "plan" and names(t)[1][0] == "assemble"
    assert {"store.fetch", "decode"} <= set(names(t)[1][1])
    meta = lambda tree: [[(c["name"], c["meta"]) for c in s["children"]] for s in tree]
    assert meta(t) == meta(j)


def test_write_spans_and_compaction_histogram():
    """A write through the device store opens ``write.fetch`` (the cold
    load's ``store.fetch`` and ``decode`` inside it) and ``write.store``;
    compaction observes ``repro_compaction_seconds`` in the port's
    registry and emits ``compact.segment`` spans."""
    store = tiered_store(DatasetSpec("w", SHAPE, base_cuboid=CUBOID),
                         policy=TierPolicy(write_tier="log", fsync=False),
                         decode_policy=DecodePolicy(workers=1))
    dev = DeviceCuboidStore(store.spec, device="cpu", backing=store)
    data = np.full((20, 10, 6), 7, np.uint8)
    before = treg.REGISTRY.histogram("repro_compaction_seconds").count
    try:
        tree = _traced_tree(ttrace, lambda: tcut.write_cutout(dev, 0, (3, 2, 1), data), "w")
        names = [s["name"] for s in tree]
        assert names[0] == "write.fetch" and "write.store" in names
        assert {c["name"] for c in tree[0]["children"]} == {"store.fetch", "decode"}
        tree = _traced_tree(ttrace, lambda: compact_store(store), "c")
        assert [s["name"] for s in tree] == ["compact.segment"]
        assert treg.REGISTRY.histogram("repro_compaction_seconds").count == before + 1
        assert "repro_compaction_seconds_count" in treg.REGISTRY.prometheus_text()
    finally:
        store.close()


# --------------------------------------------------------------- witness --


def _abba(mod):
    w = mod.Witness()
    a = mod.OrderedLock("node.a", 40, witness=w)
    b = mod.OrderedLock("node.b", 40, witness=w)

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join(timeout=10)
    return w


def _inversion(mod):
    w = mod.Witness()
    with mod.OrderedLock("cache", 60, witness=w):
        with mod.OrderedLock("store", 40, witness=w):
            pass
    return w


def _submit(mod):
    w = mod.Witness()
    with mod.OrderedLock("store", 40, witness=w):
        w.before_submit()
    return w


def _clean(mod):
    w = mod.Witness()
    admin = mod.OrderedRLock("admin", 10, witness=w)
    move = mod.OrderedLock("move", 20, witness=w)
    b = mod.OrderedLock("store", 40, witness=w)
    for _ in range(3):
        with admin:
            with admin, b:
                pass
    with move:
        w.before_submit(allow=(move,))
    assert w.held_snapshot() == {}
    return w


CASES = {"abba": (_abba, ["cycle"]), "inversion": (_inversion, ["order"]),
         "submit": (_submit, ["submit"]), "clean": (_clean, [])}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("which", list(WITNESSES))
def test_witness_flags_as_the_reference(which, case):
    make, kinds = CASES[case]
    vs = make(WITNESSES[which]).take_violations()
    assert [v.kind for v in vs] == kinds
    ref = make(jwitness).take_violations()
    assert [v.message for v in vs] == [v.message for v in ref]
    if case == "abba":
        assert vs[0].stack and vs[0].other_stack


def test_witness_is_off_until_enabled():
    """Locks made while the witness is off are plain; `enable` (the
    `port_witness` fixture) turns ranked locks on."""
    assert isinstance(twitness.ordered_lock("x", 1), twitness.OrderedLock)
    twitness.enable(False)
    try:
        lock = twitness.ordered_lock("x", 1)
        assert not isinstance(lock, twitness.OrderedLock)
        assert not isinstance(twitness.ordered_rlock("y", 2), twitness.OrderedLock)
        twitness.before_submit()  # a no-op while off
    finally:
        twitness.enable()


def test_device_store_locks_are_ranked_and_loads_submit_unlocked():
    """Under the witness a backed device store's locks are ranked, and a
    cold read over a four-worker decode pool submits with no ranked lock
    held (any violation fails this test through `port_witness`)."""
    store = CuboidStore(DatasetSpec("wl", SHAPE, base_cuboid=CUBOID),
                        decode_policy=DecodePolicy(workers=4, chunk=1))
    dev = DeviceCuboidStore(store.spec, device="cpu", backing=store)
    assert isinstance(dev.write_guard, twitness.OrderedLock)
    assert dev.write_guard.rank < store._order_lock.rank
    tcut.write_cutout(dev, 0, (0, 0, 0), np.ones(SHAPE, np.uint8))
    fresh = DeviceCuboidStore(store.spec, device="cpu", backing=store)
    assert int(tcut.cutout(fresh, 0, (0, 0, 0), SHAPE).sum()) == int(np.prod(SHAPE))


def test_cluster_watch_advises_from_gauges():
    """`ClusterWatch` samples the cluster's gauges (occupancy, the
    write-behind depth, health) and advises ``rebalance`` on skew and
    ``flush`` on queue pressure, no longer once flushed; the reference's
    watch over the same ingest gives the same snapshots and advice."""
    from repro.cluster import ClusterStore as JClusterStore
    from repro.ft import ClusterWatch as JClusterWatch
    from repro_torch.cluster import ClusterStore
    from repro_torch.ft import ClusterWatch

    vol = np.random.default_rng(5).integers(1, 255, size=SHAPE, dtype=np.uint8)
    seen = {}
    for pkg in ("reference", "port"):
        if pkg == "reference":
            store = JClusterStore(JSpec(name="watch", volume_shape=SHAPE, dtype="uint8",
                                        base_cuboid=CUBOID), n_nodes=2, write_behind=True,
                                  cache_bytes=0, replication=1)
            jcut.ingest(store, 0, vol)
            watch = JClusterWatch(store, skew=1.01, max_queue_depth=0)
        else:
            spec = DatasetSpec(name="watch", volume_shape=SHAPE, dtype="uint8",
                               base_cuboid=CUBOID)
            store = ClusterStore(spec, n_nodes=2, write_behind=True)
            tcut.ingest(DeviceCuboidStore(spec, device="cpu", backing=store), 0, vol)
            watch = ClusterWatch(store, skew=1.01, max_queue_depth=0)
        try:
            actions = watch.step()
            snap = dict(watch.history[-1])
            assert snap["n_nodes"] == 2 and sum(snap["keys_per_node"]) > 0
            if snap["queue_depth"] > 0:  # the ingest rode the write-behind queue
                assert any(a["action"] == "flush" for a in actions)
            store.flush()
            after = watch.step()
            assert all(a["action"] != "flush" for a in after)
            keep = ("n_nodes", "keys_per_node", "replication", "replication_target",
                    "health", "repair", "dead_streaks", "sealed_segments")
            seen[pkg] = ({k: snap[k] for k in keep}, sorted(a["action"] for a in after))
        finally:
            store.close()
    assert seen["port"] == seen["reference"]
