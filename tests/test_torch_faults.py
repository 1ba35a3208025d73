"""Port parity: fault injection, the node-health machine, degraded data
paths and automatic failover (`repro_torch.ft.faults`, the storage half of
`repro_torch.ft.supervisor`), case by case against tests/test_faults.py.

Each case drives the reference (`repro.ft` over a reference cluster, its
numpy cutout engine) and the port (`repro_torch.ft` over a port cluster,
read through a fresh `DeviceCuboidStore` on the CPU) with the same seeds,
plans and data, and holds the port to what the reference shows: the same
injected-fault sequences and counters, the same health states and repair
counts, reads equal to the reference's and to a single-store oracle, no
acknowledged write lost.  The reference cluster is given every knob and a
node factory, so no ``REPRO_*`` variable reaches it.  The port's witness
is on for every test (`torch_witness`).
"""
import threading
import time

import numpy as np
import pytest
from torch_cluster_pair import fresh, read
from torch_witness import port_witness  # noqa: F401

from repro import ft as jft
from repro.cluster import ClusterStore as JClusterStore
from repro.cluster import deadline as jdeadline
from repro.cluster.store import NoLiveReplica as JNoLiveReplica
from repro.core import cutout as jcut
from repro.core import store as jstore
from repro.core.cuboid import DatasetSpec as JSpec
from repro_torch import ft
from repro_torch.cluster import ClusterStore, deadline
from repro_torch.cluster.store import NoLiveReplica, RebalanceInFlight
from repro_torch.core import cutout as tcut
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import (CuboidStore, DeviceCuboidStore, DirectoryBackend,
                                    set_crash_hook)

SHAPE = (32, 32, 16)
CUBOID = (8, 8, 4)
N_CELLS = 64  # 4x4x4 grid
FULL = ((0, 0, 0), SHAPE)
PKGS = ("reference", "port")


def spec():
    return DatasetSpec(name="ft", volume_shape=SHAPE, dtype="uint8", base_cuboid=CUBOID)


def jspec():
    return JSpec(name="ft", volume_shape=SHAPE, dtype="uint8", base_cuboid=CUBOID)


def volume(seed=0):
    return np.random.default_rng(seed).integers(1, 255, size=SHAPE, dtype=np.uint8)


def jmemory_node(i, s):
    """The reference's in-memory node, named so its env knob is not read."""
    return jstore.CuboidStore(s, backend=jstore.MemoryBackend(),
                              write_path_backend=jstore.MemoryBackend())


class Side:
    """One package's harness: its fault module, a cluster over faulty
    nodes, and its cutout engine over that cluster."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.ref = pkg == "reference"
        self.ft = jft if self.ref else ft

    def factory(self, plans=None, n_nodes=3, **kw):
        if self.ref:
            return jft.faulty_factory(jmemory_node, plans=plans, seed=kw.pop("seed", 0),
                                      nodes=range(n_nodes))
        return ft.faulty_factory(plans=plans, **kw)

    def cluster(self, n_nodes=3, replication=2, node_factory=None, **kw):
        knobs = dict(cache_bytes=0, write_behind=False) if self.ref else {}
        cls, sp = (JClusterStore, jspec()) if self.ref else (ClusterStore, spec())
        if node_factory is None and self.ref:
            node_factory = jmemory_node
        return cls(sp, n_nodes=n_nodes, replication=replication, node_factory=node_factory,
                   **knobs, **kw)

    def crash_only(self, n_nodes=3, replication=2, **kw):
        """(cluster, factory): plans that fault only when crashed."""
        plans = {i: self.ft.FaultPlan(seed=i) for i in range(n_nodes)}
        fac = self.factory(plans=plans, n_nodes=n_nodes)
        return self.cluster(n_nodes, replication, fac, **kw), fac

    def ingest(self, cluster, vol):
        if self.ref:
            jcut.ingest(cluster, 0, vol)
        else:
            tcut.ingest(DeviceCuboidStore(spec(), device="cpu", backing=cluster), 0, vol)

    def cutout(self, cluster, lo, hi):
        if self.ref:
            return jcut.cutout(cluster, 0, lo, hi)
        return read(DeviceCuboidStore(spec(), device="cpu", backing=cluster), 0, lo, hi)

    def oracle(self):
        return jstore.CuboidStore(jspec()) if self.ref else CuboidStore(spec())


# ----------------------------------------------------------- the harness --


def plan_hits(mod, seed, ops=200, **kw):
    plan = mod.FaultPlan(seed=seed, error_rate=0.3, **kw)
    hits = []
    for _ in range(ops):
        try:
            plan.before_op("op")
            hits.append(0)
        except mod.FaultInjected:
            hits.append(1)
    return hits, plan.counters()


def test_fault_plan_is_deterministic_under_seed():
    for seed in (7, 8):
        assert plan_hits(ft, seed) == plan_hits(jft, seed)  # the reference's draws
    assert plan_hits(ft, 7) == plan_hits(ft, 7)             # replayable
    assert plan_hits(ft, 7)[0] != plan_hits(ft, 8)[0]       # the seed matters
    assert 0 < sum(plan_hits(ft, 7)[0]) < 200               # the rate injects


@pytest.mark.parametrize("pkg", PKGS)
def test_fault_plan_schedule_and_crash_cycle(pkg):
    side = Side(pkg)
    plan = side.ft.FaultPlan(schedule={1: "error", 3: "crash", 5: "restart"})
    inner = jstore.CuboidStore(jspec()) if side.ref else CuboidStore(spec())
    node = side.ft.FaultyNode(inner, plan)
    block = np.full(CUBOID, 7, np.uint8)
    node.write_cuboid(0, 0, block)                   # op 0: clean
    with pytest.raises(side.ft.FaultInjected):
        node.write_cuboid(0, 1, block)               # op 1: scheduled error
    node.write_cuboid(0, 1, block)                   # op 2: clean
    with pytest.raises(side.ft.NodeCrashed):
        node.read_cuboid(0, 0)                       # op 3: crash fires
    with pytest.raises(side.ft.NodeCrashed):
        node.read_cuboid(0, 0)                       # op 4: still down
    np.testing.assert_array_equal(node.read_cuboid(0, 0), block)  # op 5: back
    assert plan.counters() == {"ops": 6, "crashed": False, "errors": 1, "hangs": 0,
                               "latency_s": 0.0, "crashes": 1, "restarts": 1}
    # data survived the crash (machines fail, disks persist)
    np.testing.assert_array_equal(node.read_cuboid(0, 1), block)


def test_faulty_node_passthrough_and_attribute_delegation():
    inner = CuboidStore(spec())
    node = ft.FaultyNode(inner, ft.FaultPlan())
    node.crash()
    # the migration/repair plumbing is not intercepted: healing must work
    # on a node whose serving path is down
    assert len(node.stored_keys()) == 0
    node.flush()
    node.some_attr = 42
    assert inner.some_attr == 42
    node.restart()
    assert not node.plan.crashed
    assert repr(node) == "FaultyNode('node', crashed=False)"


def test_cache_and_queue_sit_behind_the_fault_point():
    """`ClusterStore` attaches a cache and a write-behind queue to each
    shard through the proxy: both land on the wrapped store, as in the
    reference, and a crashed node's cached cuboid still fails to read."""
    sides = {}
    for pkg in PKGS:
        side = Side(pkg)
        plans = {i: side.ft.FaultPlan(seed=i) for i in range(2)}
        kw = dict(cache_bytes=1 << 20, write_behind=True)
        if side.ref:
            cluster = JClusterStore(jspec(), n_nodes=2, replication=1,
                                    node_factory=side.factory(plans, 2), **kw)
        else:
            cluster = ClusterStore(spec(), n_nodes=2, replication=1,
                                   node_factory=side.factory(plans), **kw)
        fac = cluster._node_factory
        block = np.full(CUBOID, 9, np.uint8)
        cluster.write_cuboid(0, 0, block)
        cluster.flush()
        owner = cluster.router.replica_set(0, 0)[0]
        proxy = fac.built[owner]
        assert type(proxy).__name__ == "FaultyNode"
        assert proxy.inner.cache is not None and proxy.inner.write_behind is not None
        np.testing.assert_array_equal(cluster.read_cuboid(0, 0), block)  # now cached
        proxy.crash()
        with pytest.raises(side.ft.NodeCrashed):
            proxy.read_cuboid(0, 0)
        sides[pkg] = (proxy.plan.counters(), cluster.cache_counters())
        proxy.restart()
        cluster.close()
    assert sides["port"] == sides["reference"]


def test_crash_schedule_hook_composes_with_crashpoints(tmp_path):
    """The harness can tear the durable-put path at a named syscall
    boundary via the storage tier's own crash hooks."""
    store = CuboidStore(spec(), backend=DirectoryBackend(str(tmp_path)))
    set_crash_hook(ft.crash_schedule_hook({"dir.put.written": 2}))
    try:
        block = np.full(CUBOID, 5, np.uint8)
        store.write_cuboid(0, 0, block)              # hit 1: survives
        with pytest.raises(ft.FaultInjected):
            store.write_cuboid(0, 1, block)          # hit 2: torn mid-put
        store.write_cuboid(0, 2, block)              # hit 3: back to normal
    finally:
        set_crash_hook(None)
    np.testing.assert_array_equal(store.read_cuboid(0, 0), block)
    np.testing.assert_array_equal(store.read_cuboid(0, 2), block)
    assert not store.has_cuboid(0, 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_schedule_hook_tears_the_log_tier_of_a_faulty_cluster(pkg):
    """A faulty cluster whose nodes are on the log tier: the hook tears
    the second durable append, and that write is not acknowledged; the one
    before it reads back, the torn one is in no index, as in the
    reference.  (A torn append models a crash: the node is reopened before
    it appends again, which is where the log drops the torn tail.)"""
    side = Side(pkg)
    if side.ref:
        from repro.core.wal import TierPolicy as JTierPolicy
        from repro.core.wal import tiered_store as jtiered
        fac = jft.faulty_factory(
            lambda i, s: jtiered(s, policy=JTierPolicy(write_tier="log")), seed=0,
            nodes=range(2))
        hook_to = jstore.set_crash_hook
    else:
        fac = ft.faulty_factory(write_tier="log")
        hook_to = set_crash_hook
    cluster = side.cluster(2, 1, fac)
    assert {n.tier_stats()["write_tier"] for n in fac.built.values()} == {"LogBackend"}
    hook_to(side.ft.crash_schedule_hook({"wal.append.written": 2}))
    try:
        cluster.write_cuboid(0, 0, np.full(CUBOID, 1, np.uint8))
        with pytest.raises(side.ft.FaultInjected):
            cluster.write_cuboid(0, 1, np.full(CUBOID, 2, np.uint8))
    finally:
        hook_to(None)
    np.testing.assert_array_equal(cluster.read_cuboid(0, 0), np.full(CUBOID, 1))
    assert not cluster.has_cuboid(0, 1)
    assert sum(n.tier_stats()["log"]["appends"] for n in fac.built.values()) == 1
    cluster.close()


# ------------------------------------------------------ health machine --


def test_health_machine_transitions_and_export():
    seen = {}
    for pkg in PKGS:
        side = Side(pkg)
        store, fac = side.crash_only()
        try:
            side.ingest(store, volume(1))
            trail = [store.topology()["health"]]
            fac.built[1].crash()
            for _ in range(6):  # consecutive probe failures: alive -> suspect -> dead
                store.probe_health()
                trail.append(store.topology()["health"])
            health = store.node_health()
            assert health[1]["consecutive_errors"] >= 6 and health[1]["last_error"]
            fac.built[1].restart()
            store.probe_health()  # dead -> recovering, never straight to alive
            trail.append(store.topology()["health"])
            report = store.resync_node(1)
            trail.append(store.topology()["health"])
            seen[pkg] = (trail, [{k: v for k, v in h.items() if k != "last_error"}
                                 for h in health], report["healed"])
        finally:
            store.close()
    assert seen["port"] == seen["reference"]
    trail = seen["port"][0]
    assert trail[0] == ["alive"] * 3 and trail[6][1] == "dead"
    assert trail[7][1] == "recovering" and trail[8] == ["alive"] * 3


@pytest.mark.parametrize("pkg", PKGS)
def test_prober_background_tick_marks_dead(pkg):
    store, fac = Side(pkg).crash_only()
    try:
        fac.built[2].crash()
        store.start_prober(interval=0.01)
        t_end = time.monotonic() + 5.0
        while store.topology()["health"][2] != "dead" and time.monotonic() < t_end:
            time.sleep(0.02)
        assert store.topology()["health"][2] == "dead"
    finally:
        store.close()  # stops the prober


# ------------------------------------------------- degraded data paths --


def test_reads_survive_dead_node_oracle_identical():
    """Cutouts under a dead node return correct data from survivors, both
    before the health machine notices and after it marks it dead."""
    vol = volume(2)
    got = {}
    for pkg in PKGS:
        side = Side(pkg)
        store, fac = side.crash_only()
        try:
            side.ingest(store, vol)
            fac.built[0].crash()
            before = [side.cutout(store, *FULL), side.cutout(store, (3, 5, 1), (29, 31, 15))]
            for _ in range(6):
                store.probe_health()
            assert store.topology()["health"][0] == "dead"
            got[pkg] = before + [side.cutout(store, *FULL)]  # routed around entirely
        finally:
            store.close()
    want = [vol, vol[3:29, 5:31, 1:15], vol]
    for pkg in PKGS:
        for g, w in zip(got[pkg], want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pkg", PKGS)
def test_read_with_no_live_replica_raises(pkg):
    side = Side(pkg)
    store, fac = side.crash_only(n_nodes=2, replication=1)
    errors = ((JNoLiveReplica, jft.NodeCrashed, jft.FaultInjected) if side.ref
              else (NoLiveReplica, ft.NodeCrashed, ft.FaultInjected))
    try:
        store.write_cuboid(0, 0, np.full(CUBOID, 3, np.uint8))
        for node in fac.built.values():
            node.crash()
        with pytest.raises(errors):
            store.read_cuboid(0, 0)
        if not side.ref:
            with pytest.raises(errors):
                read(DeviceCuboidStore(spec(), device="cpu", backing=store), 0, (0, 0, 0),
                     CUBOID)
    finally:
        for node in fac.built.values():
            node.restart()
        store.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_budget_bounds_a_hung_node(pkg):
    """A hung replica may delay a budgeted read, never stall it: the read
    fails over to the surviving member within the deadline budget."""
    side = Side(pkg)
    hang_s = 1.5
    store, fac = side.crash_only()
    try:
        block = np.full(CUBOID, 9, np.uint8)
        store.write_cuboid(0, 0, block)
        owners = store.router.replica_set(0, 0)
        first = store._pick_replica(store._topo, tuple(owners))
        fac.built[first].plan.hang_s = hang_s  # every op on it hangs from now on
        fac.built[first].plan.hang_rate = 1.0
        t0 = time.monotonic()
        with (jdeadline if side.ref else deadline).budget(0.3):
            got = store.read_cuboid(0, 0)
        elapsed = time.monotonic() - t0
        np.testing.assert_array_equal(got, block)
        assert elapsed < hang_s  # failed over, did not wait out the hang
        fac.built[first].plan.hang_rate = 0.0
    finally:
        store.close()


def test_degraded_writes_ack_at_quorum_and_queue_repair():
    seen = {}
    block = np.full(CUBOID, 77, np.uint8)
    for pkg in PKGS:
        side = Side(pkg)
        store, fac = side.crash_only()
        try:
            side.ingest(store, volume(3))
            fac.built[1].crash()
            for _ in range(6):
                store.probe_health()
            assert store.topology()["health"][1] == "dead"
            # writes ack at the quorum of live replicas, misses queue as repair
            for m in range(N_CELLS):
                store.write_cuboid(0, m, block)
            pending = store.topology()["repair_pending"]
            for m in range(N_CELLS):
                np.testing.assert_array_equal(store.read_cuboid(0, m), block)
            fac.built[1].restart()
            store.probe_health()
            report = store.resync_node(1)
            topo = store.topology()
            inner = fac.built[1].inner
            for r, c, m in inner.stored_keys():  # the healed shard holds the writes
                np.testing.assert_array_equal(inner.read_cuboid(r, m, c), block)
            seen[pkg] = (pending, report["healed"], topo["repair_pending"], topo["health"],
                         sorted(inner.stored_keys()))
        finally:
            store.close()
    assert seen["port"] == seen["reference"]
    pending, healed, after, health, keys = seen["port"]
    assert pending > 0 and healed and after == 0 and health == ["alive"] * 3 and keys


# ------------------------------------------------------------- failover --


def test_supervisor_auto_failover_loses_no_acked_write():
    """A dead node triggers replica promotion and re-replication with no
    operator call; every acknowledged write stays readable."""
    vol = volume(4)
    seen = {}
    for pkg in PKGS:
        side = Side(pkg)
        store, fac = side.crash_only()
        sup = side.ft.StorageSupervisor(store, watch=side.ft.ClusterWatch(store, dead_ticks=2))
        try:
            side.ingest(store, vol)       # every one of these writes is acknowledged
            fac.built[1].crash()          # kill a live owner; it never restarts
            t_end = time.monotonic() + 30.0
            while store.topology()["n_nodes"] != 2 and time.monotonic() < t_end:
                sup.step()
                time.sleep(0.02)
            topo = store.topology()
            assert topo["n_nodes"] == 2, "supervisor never failed the node over"
            assert topo["health"] == ["alive", "alive"]
            t_end = time.monotonic() + 30.0
            while time.monotonic() < t_end:
                sup.step()
                topo = store.topology()
                if topo["replication"] == topo["replication_target"] and not topo["rebalancing"]:
                    break
                time.sleep(0.02)
            assert topo["replication"] == topo["replication_target"]
            np.testing.assert_array_equal(side.cutout(store, *FULL), vol)
            seen[pkg] = (sorted(store.stored_keys()),
                         sorted({a["action"] for a in sup.log}))
        finally:
            sup.stop()
            store.close()
    assert seen["port"] == seen["reference"]
    assert "failover" in seen["port"][1]


def test_failover_is_debounced_and_not_double_promoted():
    """Stale failover advice re-verifies against live health: one removal
    happens, a second attempt is a no-op, an operator race loses cleanly."""
    seen = {}
    for pkg in PKGS:
        side = Side(pkg)
        store, fac = side.crash_only()
        sup = side.ft.StorageSupervisor(store)
        try:
            side.ingest(store, volume(5))
            fac.built[2].crash()
            for _ in range(6):
                store.probe_health()
            assert store.node_health()[2]["state"] == "dead"
            action = {"action": "failover", "node": 2}
            first = sup._execute(dict(action))
            store.synchronize(timeout=30)
            while store.topology()["rebalancing"]:
                time.sleep(0.01)
            second = sup._execute(dict(action))  # stale advice: skipped
            with pytest.raises((ValueError, IndexError)):
                store.remove_node(5, wait=False)
            seen[pkg] = (first, second, store.topology()["n_nodes"])
        finally:
            sup.stop()
            store.close()
    assert seen["port"] == seen["reference"] == (True, False, 2)


def test_watch_debounces_death_and_resets_on_membership():
    """`ClusterWatch` advises failover only after ``dead_ticks``
    consecutive dead samples, one node a tick, and its streaks reset when
    the node count changes; the same advice as the reference's, sample by
    sample."""
    seen = {}
    for pkg in PKGS:
        side = Side(pkg)
        store, fac = side.crash_only(n_nodes=4)
        watch = side.ft.ClusterWatch(store, dead_ticks=3)
        try:
            side.ingest(store, volume(9))
            fac.built[1].crash()
            fac.built[3].crash()
            for _ in range(6):
                store.probe_health()
            trail = []
            for _ in range(4):
                acts = watch.step()
                trail.append([(a["action"], a.get("node")) for a in acts])
            fac.built[3].restart()
            store.remove_node(1)  # the operator's removal: the streaks reset
            trail.append([(a["action"], a.get("node")) for a in watch.step()])
            seen[pkg] = (trail, watch.history[-1]["dead_streaks"])
        finally:
            store.close()
    assert seen["port"] == seen["reference"]
    trail = seen["port"][0]
    assert all(("failover", 1) not in t for t in trail[:2])
    assert trail[2].count(("failover", 1)) == 1 and ("failover", 3) not in trail[2]


def test_supervisor_records_verb_errors_and_skips_in_flight_admin():
    """`StorageSupervisor._execute` returns False on `RebalanceInFlight`
    and records any other verb error on the action, never raising."""
    store, fac = Side("port").crash_only()
    sup = ft.StorageSupervisor(store)
    try:
        def busy(*a, **kw):
            raise RebalanceInFlight("held")

        def broken(*a, **kw):
            raise OSError("disk gone")

        store.re_replicate = busy
        action = {"action": "re_replicate"}
        assert not sup._execute(action) and "error" not in action
        store.re_replicate = broken
        assert not sup._execute(action)
        assert action["error"] == repr(OSError("disk gone"))
        assert not sup._execute({"action": "rebalance"})  # opt-in only
        assert not sup._execute({"action": "failover", "node": 0})  # alive: skipped
    finally:
        store.close()


# ----------------------------------------------- satellite: admin races --


@pytest.mark.parametrize("pkg", PKGS)
def test_synchronize_timeout_expires_loudly(pkg):
    store = Side(pkg).cluster(2, 2)
    entered, release = threading.Event(), threading.Event()

    def holder():
        with store._gate.op():
            entered.set()
            release.wait(10)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    try:
        assert entered.wait(5)
        with pytest.raises(TimeoutError):
            store.synchronize(timeout=0.2)
    finally:
        release.set()
        t.join(5)
    store.synchronize(timeout=10)  # clean once the op drains
    store.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_remove_node_races_health_prober(pkg):
    """Topology shrink while the background prober ticks: no deadlock, no
    stale-index failure, data intact (under the lock witness)."""
    side = Side(pkg)
    store = side.cluster(4, 2)
    try:
        vol = volume(6)
        side.ingest(store, vol)
        store.start_prober(interval=0.01)
        store.remove_node(3)
        store.remove_node(0)
        topo = store.topology()
        assert topo["n_nodes"] == 2 and topo["health"] == ["alive", "alive"]
        np.testing.assert_array_equal(side.cutout(store, *FULL), vol)
    finally:
        store.close()


# ------------------------------------------------- chaos coherence walk --


def chaos_walk(side):
    """Seeded faults (injected errors and latency on every node, a live
    owner killed mid-traffic, then restarted) under concurrent replicated
    reads and writes.  Returns (the cluster's final cutout, the oracle's,
    both stored key lists, the final topology)."""
    rng = np.random.default_rng(42)
    plans = {i: side.ft.FaultPlan(seed=100 + i, error_rate=0.04, latency_s=0.0005)
             for i in range(3)}
    fac = side.factory(plans=plans)
    oracle = side.oracle()
    store = side.cluster(3, 2, fac)
    sup = side.ft.StorageSupervisor(store, watch=side.ft.ClusterWatch(store, dead_ticks=3),
                                    allow_failover=False)  # heal in place

    def retrying(fn, attempts=60):
        last = None
        for _ in range(attempts):
            try:
                return fn()
            except Exception as e:  # injected faults and quorum misses
                last = e
                time.sleep(0.002)
        raise last

    stop = threading.Event()
    read_errors = []

    def reader():
        r = np.random.default_rng(7)
        while not stop.is_set():
            m = int(r.integers(0, N_CELLS))
            try:
                retrying(lambda: store.read_cuboid(0, m))
            except KeyError:
                pass  # not written yet
            except Exception as e:
                read_errors.append(repr(e))

    try:
        for m in range(N_CELLS):
            blk = rng.integers(1, 255, size=CUBOID, dtype=np.uint8)
            retrying(lambda b=blk, mm=m: store.write_cuboid(0, mm, b))
            oracle.write_cuboid(0, m, blk)
        t = threading.Thread(target=reader, daemon=True)
        t.start()
        fac.built[1].crash()  # mid-traffic: keep writing through the outage
        for step in range(80):
            m = int(rng.integers(0, N_CELLS))
            blk = rng.integers(1, 255, size=CUBOID, dtype=np.uint8)
            retrying(lambda b=blk, mm=m: store.write_cuboid(0, mm, b))
            oracle.write_cuboid(0, m, blk)  # acknowledged: the oracle gets it
            sup.step()
            if step == 40:
                fac.built[1].restart()
        t_end = time.monotonic() + 30.0
        while time.monotonic() < t_end:
            sup.step()
            topo = store.topology()
            if topo["health"] == ["alive"] * 3 and topo["repair_pending"] == 0:
                break
            time.sleep(0.01)
        stop.set()
        t.join(10)
        assert not read_errors, f"reader saw terminal errors: {read_errors[:3]}"
        for node in fac.built.values():  # no faults during verification
            node.plan.error_rate = 0.0
            node.plan.latency_s = 0.0
        store.flush()
        return (side.cutout(store, *FULL), side.cutout(oracle, *FULL),
                sorted(store.stored_keys()), sorted(oracle.stored_keys()), store.topology())
    finally:
        stop.set()
        sup.stop()
        store.close()
        oracle.close()


def test_chaos_coherence_walk():
    """The bar: no acknowledged write lost, every read equal to the
    single-store oracle, and the cluster healed back to every node alive
    with no operator call; the reference's walk on the same seeds ends in
    the same oracle and the same keys."""
    got = {pkg: chaos_walk(Side(pkg)) for pkg in PKGS}
    for pkg in PKGS:
        cut, want, keys, oracle_keys, topo = got[pkg]
        np.testing.assert_array_equal(cut, want)
        assert keys == oracle_keys
        assert topo["health"] == ["alive"] * 3 and topo["repair_pending"] == 0
    np.testing.assert_array_equal(got["port"][1], got["reference"][1])
    assert got["port"][2] == got["reference"][2]


# ------------------------------------------- the knobs are arguments --


FAULT_KNOBS = {"REPRO_FAULT_SEED": "5", "REPRO_FAULT_ERROR_RATE": "1.0",
               "REPRO_FAULT_LATENCY_MS": "50", "REPRO_FAULT_HANG_MS": "500",
               "REPRO_FAULT_HANG_RATE": "1.0", "REPRO_FAULT_NODES": "0"}


def test_fault_knobs_are_arguments(monkeypatch):
    """With every ``REPRO_FAULT_*`` variable set, the reference's
    knob-built plans fault on every op, and the port's plans stay
    fault-free; the port's arguments give the reference's plan."""
    for name, value in FAULT_KNOBS.items():
        monkeypatch.setenv(name, value)
    jplan = jft.FaultPlan.from_knobs()
    assert jplan.error_rate == 1.0 and jplan.hang_rate == 1.0
    fac = ft.faulty_factory()
    cluster = ClusterStore(spec(), n_nodes=3, replication=2, node_factory=fac)
    try:
        assert sorted(fac.built) == [0, 1, 2]  # REPRO_FAULT_NODES is not read
        t0 = time.monotonic()
        cluster.write_cuboid(0, 0, np.full(CUBOID, 4, np.uint8))
        np.testing.assert_array_equal(cluster.read_cuboid(0, 0), np.full(CUBOID, 4))
        assert time.monotonic() - t0 < 0.5  # no latency, no hang
        for node in fac.built.values():
            c = node.plan.counters()
            assert c["errors"] == c["hangs"] == 0 and c["latency_s"] == 0.0
    finally:
        cluster.close()
    # the explicit arguments build the plan the reference builds from knobs
    port = ft.faulty_factory(seed=5, nodes=[0], error_rate=1.0, latency_s=0.05,
                             hang_s=0.5, hang_rate=1.0)
    port(0, spec())
    ref = jft.faulty_factory(jmemory_node)
    ref(0, jspec())
    pp, jp = port.built[0].plan, ref.built[0].plan
    assert (pp.error_rate, pp.latency_s, pp.hang_s, pp.hang_rate) == \
        (jp.error_rate, jp.latency_s, jp.hang_s, jp.hang_rate)
    assert pp._rng.random() == jp._rng.random()  # the same seed, 5 + 0


# ------------------------------------------- under the device store --


def test_device_store_through_a_crash_and_failover():
    """A `DeviceCuboidStore` (CPU) over a faulty cluster: cold loads go
    through the failover fetch while a member is down, write-throughs ack
    at the degraded quorum and queue repair, the supervisor removes the
    dead node with ``remove_node(wait=False)`` on its own thread while a
    reader keeps reading, and resident rows stay valid throughout; a fresh
    device store over the healed cluster reads what the reference cluster
    holds after the same steps."""
    vol = volume(11)
    patch = np.random.default_rng(12).integers(1, 255, size=(12, 10, 6), dtype=np.uint8)
    ref = JClusterStore(jspec(), n_nodes=4, replication=2, node_factory=jft.faulty_factory(
        jmemory_node, plans={i: jft.FaultPlan(seed=i) for i in range(4)}, seed=0,
        nodes=range(4)), cache_bytes=0, write_behind=False)
    fac = ft.faulty_factory(plans={i: ft.FaultPlan(seed=i) for i in range(4)})
    cluster = ClusterStore(spec(), n_nodes=4, replication=2, node_factory=fac)
    store = DeviceCuboidStore(spec(), device="cpu", backing=cluster)
    sup = ft.StorageSupervisor(cluster, watch=ft.ClusterWatch(cluster, dead_ticks=2),
                               interval=0.02)
    try:
        jcut.ingest(ref, 0, vol)
        tcut.ingest(fresh(store), 0, vol)
        np.testing.assert_array_equal(read(store, 0, (0, 0, 0), (16, 32, 16)),
                                      vol[:16])  # half resident
        for c in (ref, cluster):
            c._node_factory.built[1].crash()
            for _ in range(6):
                c.probe_health()
        # cold loads of the other half go round the dead member
        np.testing.assert_array_equal(read(store, 0, (16, 0, 0), SHAPE), vol[16:])
        # write-through at the degraded quorum; the miss queues as repair
        jcut.write_cutout(ref, 0, (5, 7, 3), patch)
        tcut.write_cutout(store, 0, (5, 7, 3), patch)
        want = vol.copy()
        want[5:17, 7:17, 3:9] = patch
        assert cluster.topology()["repair_pending"] == ref.topology()["repair_pending"] > 0
        bad, stop = [], threading.Event()

        def reader():
            while not stop.is_set():
                got = read(store, 0, (0, 0, 0), SHAPE)
                if not np.array_equal(got, want):
                    bad.append("differs")

        t = threading.Thread(target=reader)
        t.start()
        sup.start()  # removes node 1 from its own thread
        t_end = time.monotonic() + 30.0
        while time.monotonic() < t_end:
            topo = cluster.topology()
            if (topo["n_nodes"] == 3 and not topo["rebalancing"]
                    and topo["replication"] == topo["replication_target"]):
                break
            time.sleep(0.02)
        stop.set()
        t.join(30)
        sup.stop()
        assert not bad
        assert any(a["action"] == "failover" for a in sup.log)
        topo = cluster.topology()
        assert topo["n_nodes"] == 3 and topo["health"] == ["alive"] * 3
        # the same removal on the reference, then the same data on both
        ref.remove_node(1)
        np.testing.assert_array_equal(read(fresh(store), 0, *FULL), want)
        np.testing.assert_array_equal(jcut.cutout(ref, 0, *FULL), want)
        np.testing.assert_array_equal(read(store, 0, *FULL), want)  # resident rows
        assert sorted(cluster.stored_keys()) == sorted(ref.stored_keys())
    finally:
        stop.set()
        sup.stop()
        cluster.close()
        ref.close()
