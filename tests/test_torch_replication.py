"""Port parity: replication under the device store.

Replica sets at replication 2 and 3 must be the reference's; a write
through the device store must land on every member and nowhere else, with
the reference's blobs; removing a live member loses nothing; acknowledged
writes (with and without the write-behind queue) are read back by a fresh
device store after the flush barrier and again after a member is removed;
a dead member's missed writes are queued, counted and replayed as the
reference's.  The port's witness is on for every test (`torch_witness`).
"""
import numpy as np
import pytest
from torch_cluster_pair import (SHAPE, assert_same_cluster, fresh, port_store, rand_box, read,
                                ref_cluster, volume, write)
from torch_witness import port_witness  # noqa: F401

from repro.core import cutout as jcut


@pytest.mark.parametrize("n_nodes,replication", [(2, 2), (3, 2), (4, 2), (5, 2), (3, 3),
                                                 (4, 3), (2, 3)])
def test_replica_sets_equal_reference(n_nodes, replication):
    vol = volume(seed=n_nodes + replication)
    ref = ref_cluster(n_nodes, vol=vol, replication=replication)
    store = port_store(n_nodes, vol=vol, replication=replication)
    cluster = store.backing
    router, jrouter = cluster.router, ref.router
    assert router.n_replicas == jrouter.n_replicas == min(n_nodes, replication)
    assert [router.replicas_of(i) for i in range(n_nodes)] == \
        [jrouter.replicas_of(i) for i in range(n_nodes)]
    for m in range(router.n_cells(0)):
        assert router.replica_set(0, m) == jrouter.replica_set(0, m)
    assert cluster.topology() == ref.topology()
    assert_same_cluster(ref, cluster)


@pytest.mark.parametrize("replication", [2, 3])
def test_writes_land_on_every_member_and_nowhere_else(replication):
    ref = ref_cluster(4, replication=replication)
    store = port_store(4, replication=replication)
    rng = np.random.default_rng(replication)
    for _ in range(5):
        lo, hi = rand_box(rng)
        data = rng.integers(1, 255, size=[h - l for l, h in zip(lo, hi)]).astype(np.uint8)
        jcut.write_cutout(ref, 0, lo, data)
        write(store, 0, lo, data)
    cluster = store.backing
    for r, c, m in cluster.stored_keys():
        members = cluster.router.replica_set(r, m)
        for i, node in enumerate(cluster.nodes):
            assert node.has_cuboid(r, m, c) == (i in members)
    assert_same_cluster(ref, cluster)


@pytest.mark.parametrize("replication,victim", [(2, 0), (2, 2), (3, 1), (1, 1)])
def test_removing_a_member_loses_nothing(replication, victim):
    vol = volume(seed=17)
    ref = ref_cluster(3, vol=vol, replication=replication)
    store = port_store(3, vol=vol, replication=replication)
    want = ref.remove_node(victim)
    got = store.backing.remove_node(victim)
    assert {k: v for k, v in got.items() if k != "seconds"} == \
        {k: v for k, v in want.items() if k != "seconds"}
    if replication >= 2:
        assert got["moved_keys"] == want["moved_keys"]
    assert_same_cluster(ref, store.backing)
    np.testing.assert_array_equal(read(store, 0, (0, 0, 0), SHAPE), vol)
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), vol)


@pytest.mark.parametrize("write_behind", [False, True])
def test_acknowledged_writes_read_back_from_a_fresh_device_store(write_behind):
    """Every write the device store acknowledged is read back by a fresh
    device store over the cluster after ``flush``, and again after one
    member of an R=2 cluster is removed."""
    vol = volume(seed=23)
    store = port_store(4, vol=vol, replication=2, write_behind=write_behind,
                       write_behind_items=8, cache_bytes=16 << 10)
    want = vol.copy()
    rng = np.random.default_rng(5)
    for _ in range(12):
        lo = [int(rng.integers(0, s - 6)) for s in SHAPE]
        data = rng.integers(1, 255, size=(6, 6, 3)).astype(np.uint8)
        write(store, 0, lo, data)
        want[tuple(slice(l, l + s) for l, s in zip(lo, data.shape))] = data
        np.testing.assert_array_equal(read(fresh(store), 0, lo, [l + s for l, s in
                                                                 zip(lo, data.shape)]), data)
    cluster = store.backing
    cluster.flush()
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), want)
    cluster.remove_node(1)
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE), want)
    np.testing.assert_array_equal(read(store, 0, (0, 0, 0), SHAPE), want)
    cluster.close()


def test_dead_member_writes_are_repaired_as_the_reference():
    """Writes while a member is marked dead skip it and queue repairs;
    `resync_node` replays them; health and repair counts, and the blobs,
    equal the reference's at each step."""
    vol = volume(seed=29)
    ref = ref_cluster(3, vol=vol, replication=2)
    store = port_store(3, vol=vol, replication=2)
    cluster = store.backing
    ref.mark_dead(1)
    cluster.mark_dead(1)
    rng = np.random.default_rng(3)
    for _ in range(4):
        lo, hi = rand_box(rng)
        data = rng.integers(1, 255, size=[h - l for l, h in zip(lo, hi)]).astype(np.uint8)
        jcut.write_cutout(ref, 0, lo, data)
        write(store, 0, lo, data)
    assert cluster.node_health() == ref.node_health()
    assert cluster.repair_enqueued == ref.repair_enqueued
    assert cluster.topology() == ref.topology()
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    assert cluster.probe_health() == ref.probe_health()
    assert cluster.resync_node(1) == ref.resync_node(1)
    assert cluster.node_health() == ref.node_health()
    assert_same_cluster(ref, cluster)
