"""Port parity: the elastic cluster's live rebalance under the device store.

`rebalance`, `add_node` and `remove_node` on a port `ClusterStore` (loaded
through a `DeviceCuboidStore`) must give the reference's migration stats,
`topology()`, `keys_per_node()` and per-node blobs after the same
operations on a reference `ClusterStore`; random walks of reads, writes,
flushes, migrations and topology changes stay bit-identical to the
reference; readers and writers on the device store stay bit-identical
through a live move; a migration that fails mid-copy rolls back clean.
The port's witness is on for every test (`torch_witness`): no migration
path takes the device store's write guard.
"""
import threading

import numpy as np
import pytest
from torch_cluster_pair import (CUBOID, N_CELLS, SHAPE, assert_same_cluster, fresh, port_store,
                                rand_box, read, ref_cluster, spec_kw, volume, write)
from torch_witness import port_witness  # noqa: F401

from repro.cluster import ClusterStore as JClusterStore
from repro.core import cutout as jcut
from repro.core.cuboid import DatasetSpec as JSpec
from repro_torch.cluster import ClusterStore, RebalanceInFlight, VolumeService, dispatch
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import DeviceCuboidStore

_TIMING = ("seconds",)


def stats_of(out):
    return {k: v for k, v in out.items() if k not in _TIMING}


# each scenario: a start size, then a list of (op, args) applied to both
SCENARIOS = {
    "grow_2_to_4": (2, 1, [("rebalance", dict(target=4))]),
    "shrink_4_to_3": (4, 1, [("rebalance", dict(target=3))]),
    "boundaries_only": (3, 1, [("write_corner",), ("rebalance", {})]),
    "add_node": (2, 1, [("add_node", {})]),
    "add_rider_then_rebalance": (2, 1, [("add_node", dict(rebalance=False)),
                                        ("rebalance", {})]),
    "remove_middle": (3, 1, [("remove_node", dict(node=1))]),
    "remove_last": (3, 1, [("remove_node", {})]),
    "grow_then_shrink_r2": (2, 2, [("rebalance", dict(target=4)), ("remove_node", dict(node=0)),
                                   ("rebalance", dict(target=2))]),
    "remove_member_r2": (4, 2, [("remove_node", dict(node=2))]),
    "rider_re_replicate_r3": (3, 3, [("remove_node", dict(node=0)),
                                     ("remove_node", dict(node=0)),
                                     ("add_node", dict(rebalance=False)),
                                     ("re_replicate", {})]),
    "add_remove_r3": (3, 3, [("add_node", {}), ("remove_node", dict(node=1))]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_topology_changes_equal_reference(name):
    n_nodes, replication, ops = SCENARIOS[name]
    vol = volume(seed=len(name))
    ref = ref_cluster(n_nodes, vol=vol, replication=replication)
    store = port_store(n_nodes, vol=vol, replication=replication)
    cluster = store.backing
    corner = volume(seed=6)[:16, :16, :8]
    for op, *args in ops:
        if op == "write_corner":
            jcut.write_cutout(ref, 0, (0, 0, 0), corner)
            write(store, 0, (0, 0, 0), corner)
            continue
        want = getattr(ref, op)(**args[0])
        got = getattr(cluster, op)(**args[0])
        if isinstance(want, dict):
            assert stats_of(got) == stats_of(want), op
        else:
            assert got == want, op
        assert cluster.topology() == ref.topology()
        assert cluster.keys_per_node() == ref.keys_per_node()
    assert_same_cluster(ref, cluster)
    full = jcut.cutout(ref, 0, (0, 0, 0), SHAPE)
    np.testing.assert_array_equal(read(store, 0, (0, 0, 0), SHAPE), full)
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), full)
    for r, c, m in cluster.stored_keys():
        members = cluster.router.replica_set(r, m)
        for i, node in enumerate(cluster.nodes):
            assert node.has_cuboid(r, m, c) == (i in members)
    ref.close()
    cluster.close()


def test_remove_node_refusals_equal_reference():
    ref, store = ref_cluster(2, vol=volume()), port_store(2, vol=volume())
    for args in (dict(node=7), dict(node=-3)):
        with pytest.raises(ValueError):
            ref.remove_node(**args)
        with pytest.raises(ValueError):
            store.backing.remove_node(**args)
    ref.remove_node()
    store.backing.remove_node()
    with pytest.raises(ValueError):
        store.backing.remove_node()  # cannot drop the last node
    with pytest.raises(ValueError):
        store.backing.rebalance(target=0)
    assert_same_cluster(ref, store.backing)


def test_rebalance_every_resolution_equals_reference():
    kw = spec_kw(shape=(64, 64, 16), n_resolutions=2)
    ref = JClusterStore(JSpec(**kw), n_nodes=2, cache_bytes=0, write_behind=False,
                        replication=1)
    spec = DatasetSpec(**kw)
    store = DeviceCuboidStore(spec, device="cpu", backing=ClusterStore(spec, n_nodes=2))
    for r in range(2):
        vol = volume(seed=r, shape=tuple(spec.grid(r).volume_shape))
        jcut.ingest(ref, r, vol)
        write(store, r, (0, 0, 0), vol)
    assert stats_of(store.backing.rebalance(target=3)) == stats_of(ref.rebalance(target=3))
    assert store.backing.topology() == ref.topology()
    assert_same_cluster(ref, store.backing)
    for r in range(2):
        shape = tuple(spec.grid(r).volume_shape)
        np.testing.assert_array_equal(read(fresh(store), r, (0, 0, 0), shape),
                                      jcut.cutout(ref, r, (0, 0, 0), shape))


# ------------------------------------------- coherence under interleavings --

def apply_op(ref, port, op):
    """Apply ``op`` to the reference cluster and to the port's device store
    ``port["store"]``; return (reference answer, port answer) for reads.
    A single-cuboid write goes straight to the cluster, under the device
    store's copy, so the walk goes on with a fresh device store."""
    kind, store = op[0], port["store"]
    cluster = store.backing
    if kind == "read_cuboid":
        return ref.read_cuboid(0, op[1]), cluster.read_cuboid(0, op[1])
    if kind == "write_cuboid":
        ref.write_cuboid(0, op[1], op[2])
        cluster.write_cuboid(0, op[1], op[2])
        port["store"] = fresh(store)
        return None
    if kind == "cutout":
        # a fresh device store reads the cluster; the long-lived one its copy
        want = jcut.cutout(ref, 0, op[1], op[2])
        np.testing.assert_array_equal(read(fresh(store), 0, op[1], op[2]), want)
        return want, read(store, 0, op[1], op[2])
    if kind == "write_cutout":
        jcut.write_cutout(ref, 0, op[1], op[2])
        write(store, 0, op[1], op[2])
        return None
    if kind in ("migrate", "flush"):
        getattr(ref, kind)()
        getattr(cluster, kind)()
        return None
    if kind == "rebalance":
        want, got = ref.rebalance(target=op[1]), cluster.rebalance(target=op[1])
        return stats_of(want) == stats_of(got), True
    raise AssertionError(f"unknown op {kind}")


def random_ops(rng, n_ops):
    """Random interleaving including topology changes (1->2->4->3 style)."""
    ops = []
    targets = rng.permutation([1, 2, 3, 4]).tolist()
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.18:
            ops.append(("read_cuboid", int(rng.integers(0, N_CELLS))))
        elif roll < 0.36:
            data = rng.integers(0, 4, size=CUBOID).astype(np.uint8)
            if rng.random() < 0.2:
                data[:] = 0  # lazy-zero delete path
            ops.append(("write_cuboid", int(rng.integers(0, N_CELLS)), data))
        elif roll < 0.54:
            ops.append(("cutout", *rand_box(rng)))
        elif roll < 0.72:
            lo, hi = rand_box(rng)
            shape = [h - l for l, h in zip(lo, hi)]
            ops.append(("write_cutout", lo, rng.integers(0, 255, size=shape).astype(np.uint8)))
        elif roll < 0.80:
            ops.append(("migrate",))
        elif roll < 0.86:
            ops.append(("flush",))
        else:
            ops.append(("rebalance", targets[int(rng.integers(0, len(targets)))]))
    return ops


def run_walk(seed, n_ops, **kw):
    rng = np.random.default_rng(seed * 13 + 1)
    ops = [("write_cutout", [0, 0, 0], volume(seed=seed))] + random_ops(rng, n_ops)
    ops += [("rebalance", 2), ("rebalance", 4), ("rebalance", 3)]
    ref, port = ref_cluster(1, **kw), {"store": port_store(1, **kw)}
    for op in ops:
        out = apply_op(ref, port, op)
        if out is not None:
            np.testing.assert_array_equal(out[1], out[0])
    store = port["store"]
    assert_same_cluster(ref, store.backing)
    assert store.backing.topology() == ref.topology()
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    ref.close()
    store.backing.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rebalancing_walk_equals_reference(seed):
    run_walk(seed, 40)


@pytest.mark.parametrize("seed", [0, 1])
def test_rebalancing_walk_equals_reference_tiered(seed):
    """The same walk with the cache and write-behind tiers on and an
    eviction-heavy budget."""
    run_walk(seed + 10, 30, cache_bytes=6 << 10, write_behind=True, write_behind_items=16)


# ------------------------------------------------- live migration coherence --

@pytest.mark.parametrize("replication", [1, 2])
def test_live_rebalance_under_concurrent_traffic(replication):
    """Readers on a cold device store each pass and writers on the shared
    one, while the cluster grows 2 -> 4, re-cuts and loses a member: every
    read is bit-identical, every acknowledged write is read back by a
    fresh device store, and every key sits on its replica set only."""
    kw = spec_kw(n_channels=4)
    spec = DatasetSpec(**kw)
    base = volume(seed=11)
    cluster = ClusterStore(spec, n_nodes=2, replication=replication, cache_bytes=32 << 10,
                           write_behind=True, write_behind_items=32)
    store = DeviceCuboidStore(spec, device="cpu", backing=cluster)
    write(store, 0, (0, 0, 0), base)  # channel 0: read-only ground truth
    n_writers, n_rounds = 3, 6
    want = {t: np.zeros(SHAPE, np.uint8) for t in range(n_writers)}
    failures = []
    stop = threading.Event()

    def reader(tid):
        rng = np.random.default_rng(500 + tid)
        try:
            while not stop.is_set():
                lo, hi = rand_box(rng)
                cold = DeviceCuboidStore(spec, device="cpu", backing=cluster)
                sl = tuple(slice(l, h) for l, h in zip(lo, hi))
                np.testing.assert_array_equal(read(cold, 0, lo, hi), base[sl])
                np.testing.assert_array_equal(read(store, 0, lo, hi), base[sl])
        except Exception as e:  # surfaced through failures
            failures.append(("reader", tid, e))

    def writer(tid):
        rng = np.random.default_rng(900 + tid)
        try:
            for _ in range(n_rounds):
                lo, hi = rand_box(rng)
                data = rng.integers(1, 255, size=[h - l for l, h in zip(lo, hi)]).astype(
                    np.uint8)
                write(store, 0, lo, data, channel=tid + 1)
                want[tid][tuple(slice(l, h) for l, h in zip(lo, hi))] = data
        except Exception as e:  # surfaced through failures
            failures.append(("writer", tid, e))

    readers = [threading.Thread(target=reader, args=(t,)) for t in range(2)]
    writers = [threading.Thread(target=writer, args=(t,)) for t in range(n_writers)]
    for t in readers + writers:
        t.start()
    try:
        stats = cluster.rebalance(target=4)
        assert stats["n_nodes"] == 4 and stats["moved_keys"] > 0
        for target in (2, 3, 4):
            cluster.rebalance(target=target)
        cluster.remove_node(1)
        for t in writers:
            t.join(timeout=60)
            assert not t.is_alive(), "writer deadlocked"
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=60)
    assert not failures, failures
    cluster.flush()
    after = DeviceCuboidStore(spec, device="cpu", backing=cluster)
    np.testing.assert_array_equal(read(after, 0, (0, 0, 0), SHAPE), base)
    for tid in range(n_writers):
        np.testing.assert_array_equal(read(after, 0, (0, 0, 0), SHAPE, channel=tid + 1),
                                      want[tid])
    assert cluster.n_nodes == 3
    for r, c, m in cluster.stored_keys():
        members = cluster.router.replica_set(r, m)
        for i, node in enumerate(cluster.nodes):
            assert node.has_cuboid(r, m, c) == (i in members)
    rs, ws = cluster.read_stats, cluster.write_stats
    assert rs.reads + ws.reads == rs.cache_hits + rs.cache_misses
    cluster.close()


def test_failed_migration_rolls_back_clean():
    """A migration that dies mid-copy strands nothing: the old ownership
    stays, the device store reads on, and a retry balances (as the
    reference's)."""
    vol = volume(seed=21)
    store = port_store(2, vol=vol)
    cluster = store.backing
    victim = cluster.nodes[0]
    real_fetch = victim.fetch_runs

    def failing_fetch(*a, **kw):
        raise RuntimeError("node lost mid-copy")

    victim.fetch_runs = failing_fetch
    try:
        with pytest.raises(RuntimeError, match="mid-copy"):
            cluster.rebalance(target=4)
    finally:
        victim.fetch_runs = real_fetch
    assert cluster.n_nodes == 2 and not cluster.topology()["rebalancing"]
    for r, c, m in cluster.stored_keys():
        owner = cluster.router.owner(r, m)
        for i, node in enumerate(cluster.nodes):
            assert node.has_cuboid(r, m, c) == (i == owner)
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), vol)
    ref = ref_cluster(2, vol=vol)
    assert stats_of(cluster.rebalance(target=4)) == stats_of(ref.rebalance(target=4))
    assert_same_cluster(ref, cluster)
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), vol)


# ------------------------------------------------------------ service verbs --

def test_topology_and_rebalance_verbs():
    svc = VolumeService()
    store = port_store(2, "d", vol=volume())
    svc.add_dataset("d", store)
    single = DeviceCuboidStore(DatasetSpec(**spec_kw("single")), device="cpu")
    svc.add_dataset("single", single)
    with pytest.warns(DeprecationWarning):
        topo = dispatch(svc, {"verb": "GET /topology", "dataset": "d"})
    assert topo["status"] == 200 and topo["elastic"] and topo["n_nodes"] == 2
    assert sum(topo["keys_per_node"]) == N_CELLS
    with pytest.warns(DeprecationWarning):
        one = dispatch(svc, {"verb": "GET /topology", "dataset": "single"})
    assert one["status"] == 200 and not one["elastic"] and one["keys_per_node"] == [0]
    want = read(store, 0, (3, 5, 1), (31, 29, 15))
    for req, status in (({"target": 4}, 200), ({}, 200), ({"target": 0}, 400),
                        ({"target": "many"}, 400), ({"dataset": "single"}, 400),
                        ({"dataset": "nope"}, 404)):
        with pytest.warns(DeprecationWarning):
            resp = dispatch(svc, {"verb": "POST /rebalance", "dataset": "d", **req})
        assert resp["status"] == status, (req, resp)
    np.testing.assert_array_equal(read(fresh(store), 0, (3, 5, 1), (31, 29, 15)), want)


def test_concurrent_topology_change_is_409():
    """A topology verb while another change holds the admin lock answers
    409 (`RebalanceInFlight`), and the cluster stays usable."""
    svc = VolumeService()
    store = port_store(3, "d", vol=volume(seed=3), replication=2)
    svc.add_dataset("d", store)
    cluster = store.backing
    entered, release = threading.Event(), threading.Event()
    real = cluster._migrate_live

    def slow_migrate(*a, **kw):
        entered.set()
        release.wait(timeout=30)
        return real(*a, **kw)

    cluster._migrate_live = slow_migrate
    t = threading.Thread(target=cluster.rebalance, kwargs=dict(target=4))
    t.start()
    try:
        assert entered.wait(timeout=30)
        for verb, extra in (("POST /rebalance", {}), ("POST /nodes/add", {}),
                            ("POST /nodes/remove", {"node": 0})):
            with pytest.warns(DeprecationWarning):
                resp = dispatch(svc, {"verb": verb, "dataset": "d", **extra})
            assert resp["status"] == 409, resp
        with pytest.raises(RebalanceInFlight):
            cluster.remove_node(0, wait=False)
    finally:
        release.set()
        t.join(timeout=60)
    cluster._migrate_live = real
    assert cluster.n_nodes == 4
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), volume(seed=3))
