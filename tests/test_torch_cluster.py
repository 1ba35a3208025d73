"""Port parity: the spatially-partitioned cluster under the device store,
and the service verbs over it.

`Partition` and `Router` must answer as the reference's on the same
inputs.  The same seeded data ingested through the port's device store
over a port `ClusterStore` and through the reference cutout engine over a
reference `ClusterStore` must leave every node with the same keys and
byte-identical blobs (`carry.cluster_items`), cut out the same volumes
with the same `CutoutStats`, and every verb of `dispatch` must return the
reference's status and body.  The port's witness is on for every test
(`torch_witness`).
"""
import dataclasses
import warnings
import zlib

import numpy as np
import pytest
from torch_cluster_pair import (CUBOID, N_CELLS, SHAPE, assert_same_cluster, fresh, port_store,
                                rand_box, read, ref_cluster, spec_kw, volume, write)
from torch_witness import port_witness  # noqa: F401

from repro.cluster import ClusterStore as JClusterStore
from repro.cluster import Partition as JPartition
from repro.cluster import Router as JRouter
from repro.cluster import VolumeService as JService
from repro.cluster import dispatch as jdispatch
from repro.core import cutout as jcut
from repro.core.annotations import AnnotationProject as JProject
from repro.core.cuboid import DatasetSpec as JSpec
from repro.core.store import CuboidStore as JCuboidStore
from repro_torch import carry
from repro_torch.cluster import (ClusterStore, Partition, Router, VolumeService, dispatch)
from repro_torch.core import cutout as tcut
from repro_torch.core.annotations import AnnotationProject
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import DeviceCuboidStore, PathStats, host_view


def call(fn, *args):
    """(result or the exception's type, and whether it raised)."""
    try:
        return fn(*args), False
    except Exception as e:  # compared by type
        return type(e), True


# ---------------------------------------------------------------- Partition --

@pytest.mark.parametrize("seed", range(6))
def test_partition_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n_cells = int(rng.integers(1, 200))
    n_parts = int(rng.integers(1, 12))
    assert Partition.even(n_cells, n_parts).bounds == JPartition.even(n_cells, n_parts).bounds
    occupied = rng.integers(0, n_cells, size=int(rng.integers(0, 3 * n_cells)))
    bal = Partition.balanced(occupied, n_cells, n_parts)
    jbal = JPartition.balanced(occupied, n_cells, n_parts)
    assert bal.bounds == jbal.bounds
    assert bal.segments() == jbal.segments()
    assert (bal.n_parts, bal.n_cells) == (jbal.n_parts, jbal.n_cells)
    idx = np.arange(n_cells)
    np.testing.assert_array_equal(bal.owner(idx), jbal.owner(idx))
    assert bal.owner(n_cells - 1) == jbal.owner(n_cells - 1)
    for _ in range(8):
        a = int(rng.integers(0, n_cells + 1))
        b = int(rng.integers(a, n_cells + 1))
        assert bal.split(a, b) == jbal.split(a, b)
    other = Partition.balanced(rng.integers(0, n_cells, 50), n_cells, max(1, n_parts - 1))
    jother = JPartition(other.bounds)
    assert bal.moves(other) == jbal.moves(jother)
    assert (Partition.from_segments(bal.segments()).bounds
            == JPartition.from_segments(jbal.segments()).bounds)


@pytest.mark.parametrize("make", [
    lambda P: P((0,)),
    lambda P: P((1, 4)),
    lambda P: P((0, 5, 3)),
    lambda P: P.from_segments([(0, 2), (3, 4)]),
    lambda P: P.balanced([0, 1], 4, 0),
    lambda P: P.balanced([9], 4, 2),
    lambda P: P((0, 2, 4)).owner(4),
    lambda P: P((0, 2, 4)).split(1, 5),
    lambda P: P((0, 2, 4)).moves(P((0, 5))),
])
def test_partition_rejects_what_the_reference_rejects(make):
    got, raised = call(make, Partition)
    want, jraised = call(make, JPartition)
    assert raised and jraised and got is want


# ------------------------------------------------------------------- Router --

@pytest.mark.parametrize("n_nodes,replication", [(1, 1), (2, 1), (4, 2), (3, 3), (5, 2),
                                                 (9, 2)])
def test_router_equals_reference(n_nodes, replication):
    kw = spec_kw(n_resolutions=3)
    spec, jspec = DatasetSpec(**kw), JSpec(**kw)
    rng = np.random.default_rng(n_nodes * 10 + replication)
    parts = {1: Partition.balanced(rng.integers(0, spec.grid(1).n_cells, 40),
                                   spec.grid(1).n_cells, n_nodes)}
    router = Router(spec, n_nodes, parts, replication)
    jrouter = JRouter(jspec, n_nodes, {1: JPartition(parts[1].bounds)}, replication)
    assert router.n_replicas == jrouter.n_replicas
    for r in range(3):
        n = router.n_cells(r)
        assert n == jrouter.n_cells(r)
        assert router.segments(r) == jrouter.segments(r)
        cells = np.arange(n)
        np.testing.assert_array_equal(router.owners(r, cells), jrouter.owners(r, cells))
        assert [router.replica_set(r, m) for m in range(n)] == \
            [jrouter.replica_set(r, m) for m in range(n)]
        runs = [(a, int(rng.integers(a + 1, n + 1))) for a in
                sorted(set(int(x) for x in rng.integers(0, n, 4)))]
        assert router.split_runs(r, runs) == jrouter.split_runs(r, runs)
        for a, b in runs:
            assert router.split_run(r, a, b) == jrouter.split_run(r, a, b)
            assert router.split_run_replicas(r, a, b) == jrouter.split_run_replicas(r, a, b)
        got, want = router.group_cells(r, cells), jrouter.group_cells(r, cells)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    moved = router.with_partitions({0: Partition.even(N_CELLS, n_nodes)})
    jmoved = jrouter.with_partitions({0: JPartition.even(N_CELLS, n_nodes)})
    assert moved.segments(0) == jmoved.segments(0)


# --------------------------------------------------- placement and cutouts --

@pytest.mark.parametrize("n_nodes,replication", [(1, 1), (2, 1), (4, 1), (3, 2), (4, 3)])
def test_ingest_places_the_same_blobs(n_nodes, replication):
    vol = volume(seed=n_nodes)
    ref = ref_cluster(n_nodes, vol=vol, replication=replication)
    store = port_store(n_nodes, vol=vol, replication=replication)
    assert_same_cluster(ref, store.backing)
    assert store.backing.stored_keys() == ref.stored_keys()
    assert store.backing.write_stats.writes == ref.write_stats.writes
    ref.close()
    store.backing.close()


@pytest.mark.parametrize("n_nodes", [1, 2, 4])
def test_cutouts_equal_reference(n_nodes):
    vol = volume(seed=7)
    ref = ref_cluster(n_nodes, vol=vol, replication=2)
    store = port_store(n_nodes, vol=vol, replication=2)
    cold = fresh(store)
    rng = np.random.default_rng(n_nodes)
    for _ in range(10):
        lo, hi = rand_box(rng)
        want_stats, got_stats = jcut.CutoutStats(), tcut.CutoutStats()
        want = jcut.cutout(ref, 0, lo, hi, stats=want_stats)
        np.testing.assert_array_equal(read(cold, 0, lo, hi, stats=got_stats), want)
        np.testing.assert_array_equal(read(store, 0, lo, hi), want)
        assert got_stats.__dict__ == want_stats.__dict__
    got = tcut.batch_cutout(cold, 0, [((0, 0, 0), SHAPE), ((3, 5, 1), (20, 9, 13))])
    want = jcut.batch_cutout(ref, 0, [((0, 0, 0), SHAPE), ((3, 5, 1), (20, 9, 13))])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(host_view(g, "uint8"), w)
    ref.close()
    store.backing.close()


@pytest.mark.parametrize("discipline", ["overwrite", "preserve"])
def test_writes_equal_reference(discipline):
    ref = ref_cluster(3, vol=volume(seed=2), replication=2, write_behind=True)
    store = port_store(3, vol=volume(seed=2), replication=2, write_behind=True)
    rng = np.random.default_rng(11)
    for i in range(6):
        lo, hi = rand_box(rng)
        data = rng.integers(0, 3, size=[h - l for l, h in zip(lo, hi)]).astype(np.uint8)
        if i == 2:
            data[:] = 0  # an all-zero write changes nothing
        jcut.write_cutout(ref, 0, lo, data, discipline=discipline)
        write(store, 0, lo, data, discipline=discipline)
        np.testing.assert_array_equal(read(store, 0, lo, hi), jcut.cutout(ref, 0, lo, hi))
    write(store, 0, (8, 8, 4), np.zeros(CUBOID, np.uint8), discipline="overwrite")
    jcut.write_cutout(ref, 0, (8, 8, 4), np.zeros(CUBOID, np.uint8))
    assert_same_cluster(ref, store.backing)
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    ref.close()
    store.backing.close()


def test_cluster_state_carries_both_ways():
    """`carry.cluster_items` of a reference cluster builds a port cluster
    that reads the same, and the port's fills an empty reference cluster."""
    vol = volume(seed=5)
    ref = ref_cluster(3, vol=vol, replication=2)
    ref.rebalance(target=4)
    items = carry.cluster_items(ref)
    spec = DatasetSpec(**spec_kw())
    port = carry.cluster_from_items(spec, items)
    assert port.topology()["segments"] == ref.topology()["segments"]
    assert_same_cluster(ref, port)
    store = DeviceCuboidStore(spec, device="cpu", backing=port)
    np.testing.assert_array_equal(read(store, 0, (0, 0, 0), SHAPE), vol)
    back = carry.cluster_from_items(spec, carry.cluster_items(port), into=JClusterStore(
        JSpec(**spec_kw()), n_nodes=4, cache_bytes=0, write_behind=False, replication=2))
    assert_same_cluster(back, port)
    np.testing.assert_array_equal(jcut.cutout(back, 0, (0, 0, 0), SHAPE), vol)
    with pytest.raises(ValueError):
        carry.cluster_from_items(spec, items, into=ClusterStore(spec, n_nodes=2))
    for c in (ref, port, back):
        c.close()


@pytest.mark.parametrize("n_nodes", [1, 2, 4])
def test_annotation_project_over_cluster(n_nodes):
    """Object queries over a cluster-backed label store equal the
    reference project's over a reference cluster."""
    image = spec_kw("img")
    jproj = JProject(f"c{n_nodes}", JSpec(**image), store_factory=lambda s: JClusterStore(
        s, n_nodes=n_nodes, cache_bytes=0, write_behind=False, replication=1))
    proj = AnnotationProject(f"c{n_nodes}", DatasetSpec(**image), device="cpu",
                             store_factory=lambda s: DeviceCuboidStore(
                                 s, device="cpu", backing=ClusterStore(s, n_nodes=n_nodes)))
    ids = []
    for p in (jproj, proj):
        a = p.meta.create(ann_type="synapse")
        labels = np.zeros((20, 20, 10), np.uint32)
        labels[3:9, 4:12, 2:7] = a.ann_id
        p.write(0, (10, 10, 5), labels)
        ids.append(a.ann_id)
    assert ids[0] == ids[1]
    a = ids[0]
    assert proj.bounding_box(a, 0) == jproj.bounding_box(a, 0)
    np.testing.assert_array_equal(proj.voxel_list(a, 0), jproj.voxel_list(a, 0))
    lo, cut = proj.object_cutout(a, 0)
    jlo, jcut_ = jproj.object_cutout(a, 0)
    assert list(lo) == list(jlo)
    np.testing.assert_array_equal(host_view(cut, np.uint32), jcut_)
    assert_same_cluster(jproj.store, proj.store.backing)


# -------------------------------------------------------------------- verbs --

def services(n_nodes=2, replication=2):
    """A reference and a port service over the same dataset and project:
    dataset "ds" on a cluster, project "anno" with one object."""
    vol = volume(seed=1)
    jsvc, svc = JService(), VolumeService()
    jsvc.add_dataset("ds", ref_cluster(n_nodes, "ds", vol=vol, replication=replication))
    svc.add_dataset("ds", port_store(n_nodes, "ds", vol=vol, replication=replication))
    image = spec_kw("anno")
    jproj = JProject("anno", JSpec(**image), store_factory=lambda s: JClusterStore(
        s, n_nodes=2, cache_bytes=0, write_behind=False, replication=1))
    proj = AnnotationProject("anno", DatasetSpec(**image), device="cpu",
                             store_factory=lambda s: DeviceCuboidStore(
                                 s, device="cpu", backing=ClusterStore(s, n_nodes=2)))
    for p, s in ((jproj, jsvc), (proj, svc)):
        a = p.meta.create(ann_type="synapse", confidence=0.99)
        labels = np.zeros((8, 8, 4), np.uint32)
        labels[1:7, 2:8, 1:4] = a.ann_id
        p.write(0, (16, 16, 8), labels)
        s.add_project("anno", p)
    return jsvc, svc, a.ann_id


# keys whose values are wall times or per-process counters
_VOLATILE = {"seconds", "time_s", "fetch_s", "decode_s", "assemble_s", "queue_s", "slept_s"}


def canon(body):
    """A response body as plain comparable data: arrays as (dtype, shape,
    bytes), tuples as lists, wall times dropped."""
    if isinstance(body, dict):
        return {k: canon(v) for k, v in body.items() if k not in _VOLATILE}
    if isinstance(body, (list, tuple)):
        return [canon(v) for v in body]
    if isinstance(body, np.ndarray):
        return (str(body.dtype), list(body.shape), body.tobytes())
    if isinstance(body, np.generic):
        return body.item()
    return body


def both(jsvc, svc, request):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jdispatch(jsvc, dict(request)), dispatch(svc, dict(request))


VOL = volume(seed=9)[:10, :7, :5]
VERBS = {
    "get_cutout": {"verb": "GET /cutout", "dataset": "ds", "lo": (5, 6, 7), "hi": (25, 20, 15)},
    "get_cutout_aligned": {"verb": "GET /cutout", "dataset": "ds", "lo": (8, 8, 4),
                           "hi": (16, 24, 12)},
    "get_cutout_zlib": {"verb": "GET /cutout", "dataset": "ds", "lo": (0, 0, 0),
                        "hi": (16, 16, 8), "encode": "zlib", "level": 6},
    "get_cutout_clamped": {"verb": "GET /cutout", "dataset": "ds", "lo": (30, 30, 14),
                           "hi": (40, 40, 20)},
    "put_cutout": {"verb": "PUT /cutout", "dataset": "ds", "lo": (3, 4, 5), "data": VOL},
    "put_cutout_sync": {"verb": "PUT /cutout", "dataset": "ds", "lo": (3, 4, 5), "data": VOL,
                        "sync": True, "discipline": "preserve"},
    "put_cutout_zlib": {"verb": "PUT /cutout", "dataset": "ds", "lo": (9, 9, 9),
                        "encode": "zlib", "data": zlib.compress(VOL.tobytes(), 1),
                        "dtype": "uint8", "shape": VOL.shape},
    "projection_slice": {"verb": "GET /projection", "dataset": "ds", "lo": (0, 0, 3),
                         "hi": (20, 30, 9)},
    "projection_max": {"verb": "GET /projection", "dataset": "ds", "lo": (1, 2, 3),
                       "hi": (20, 30, 9), "axis": 0, "reduce": "max"},
    "projection_mean": {"verb": "GET /projection", "dataset": "ds", "lo": (1, 2, 3),
                        "hi": (20, 30, 9), "axis": 1, "reduce": "mean", "encode": "zlib"},
    "batch_cutout": {"verb": "POST /batch/cutout", "dataset": "ds",
                     "boxes": [[(0, 0, 0), (8, 8, 4)], [(5, 5, 5), (30, 20, 16)]]},
    "bbox": {"verb": "GET /objects/boundingbox", "project": "anno", "id": 1},
    "object_cutout": {"verb": "GET /objects/cutout", "project": "anno", "id": 1},
    "object_cutout_box": {"verb": "GET /objects/cutout", "project": "anno", "id": 1,
                          "lo": (16, 16, 8), "hi": (20, 24, 12), "encode": "zlib"},
    "flush": {"verb": "POST /flush"},
    "flush_ds": {"verb": "POST /flush", "dataset": "ds"},
    "compact": {"verb": "POST /compact", "dataset": "ds"},
    "topology": {"verb": "GET /topology", "dataset": "ds"},
    "rebalance": {"verb": "POST /rebalance", "dataset": "ds", "target": 3},
    "rebalance_same": {"verb": "POST /rebalance", "dataset": "ds"},
    "add_node": {"verb": "POST /nodes/add", "dataset": "ds"},
    "add_node_rider": {"verb": "POST /nodes/add", "dataset": "ds", "rebalance": False},
    "remove_node": {"verb": "POST /nodes/remove", "dataset": "ds", "node": 0},
    "trace_unknown": {"verb": "GET /trace", "trace": "nope"},
    "trace_missing": {"verb": "GET /trace"},
    "unknown_dataset": {"verb": "GET /cutout", "dataset": "nope"},
    "unknown_object": {"verb": "GET /objects/boundingbox", "project": "anno", "id": 999},
    "unknown_verb": {"verb": "DELETE /everything"},
    "bad_box": {"verb": "GET /cutout", "dataset": "ds", "lo": (0, 0), "hi": (4, 4, 4)},
    "bad_zlib": {"verb": "PUT /cutout", "dataset": "ds", "lo": (0, 0, 0), "encode": "zlib",
                 "data": b"not zlib", "dtype": "uint8", "shape": (2, 2, 2)},
    "bad_level": {"verb": "GET /cutout", "dataset": "ds", "lo": (0, 0, 0), "hi": (2, 2, 2),
                  "encode": "zlib", "level": 12},
    "bad_target": {"verb": "POST /rebalance", "dataset": "ds", "target": "many"},
    "bad_node": {"verb": "POST /nodes/remove", "dataset": "ds", "node": 7},
    "bad_compact": {"verb": "POST /compact", "max_segments": "all"},
}


@pytest.mark.parametrize("name", sorted(VERBS))
def test_dispatch_verb_equals_reference(name):
    """The verb answers as the reference's, and both clusters hold the
    same afterwards; a read after it answers the same too."""
    jsvc, svc, _ = services()
    want, got = both(jsvc, svc, VERBS[name])
    assert canon(got) == canon(want)
    assert_same_cluster(jsvc.datasets["ds"], svc.datasets["ds"].backing)
    after = {"verb": "GET /cutout", "dataset": "ds", "lo": (0, 0, 0), "hi": SHAPE}
    want, got = both(jsvc, svc, after)
    assert canon(got) == canon(want)


def test_stats_and_metrics_answer_as_reference():
    """``GET /stats`` has the reference's sections, write counters and
    topology; ``GET /metrics`` has the reference's metric families."""
    jsvc, svc, _ = services()
    for req in ({"verb": "PUT /cutout", "dataset": "ds", "lo": (3, 4, 5), "data": VOL},
                {"verb": "POST /flush"}):
        both(jsvc, svc, req)
    want, got = both(jsvc, svc, {"verb": "GET /stats", "dataset": "ds"})
    assert got["status"] == want["status"] == 200
    assert sorted(got) == sorted(want)
    assert sorted(got["read"]) == sorted(want["read"])
    for k in ("writes", "write_bytes"):
        assert got["write"][k] == want["write"][k]
    for k in ("replication", "partitions", "health", "tiers", "decode", "queue"):
        assert canon(got[k]) == canon(want[k]), k
    assert [n["write"]["writes"] for n in got["nodes"]] == \
        [n["write"]["writes"] for n in want["nodes"]]
    assert canon(got["heat"]["write"]) == canon(want["heat"]["write"])
    want, got = both(jsvc, svc, {"verb": "GET /metrics", "dataset": "ds"})
    assert got["status"] == want["status"] == 200

    def families(text):
        return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}

    assert families(got["text"]) == families(want["text"])
    assert got["content_type"] == want["content_type"]
    assert both(jsvc, svc, {"verb": "GET /stats", "dataset": "nope"})[1]["status"] == 404


def test_unbacked_dataset_answers_as_a_single_node():
    """A device store without a backing answers the storage verbs as the
    reference's single `CuboidStore` does."""
    vol = volume(seed=4)
    jsvc, svc = JService(), VolumeService()
    ref = JCuboidStore(JSpec(**spec_kw("one")))
    jcut.ingest(ref, 0, vol)
    jsvc.add_dataset("one", ref)
    store = DeviceCuboidStore(DatasetSpec(**spec_kw("one")), device="cpu")
    tcut.ingest(store, 0, vol)
    svc.add_dataset("one", store)
    for name in ("topology", "rebalance", "add_node", "remove_node", "flush_ds", "compact",
                 "get_cutout"):
        req = dict(VERBS[name], dataset="one")
        want, got = both(jsvc, svc, req)
        assert canon(got) == canon(want), name
    want, got = both(jsvc, svc, {"verb": "GET /stats", "dataset": "one"})
    assert sorted(got) == sorted(set(want) - {"decode"})  # nothing decodes on the host
    assert got["read"] == got["write"] == dataclasses.asdict(PathStats())  # no host I/O
    assert got["tiers"]["compactions"] == want["tiers"]["compactions"]
    with pytest.raises(TypeError):
        svc.add_dataset("host", ClusterStore(DatasetSpec(**spec_kw("one"))))


@pytest.mark.parametrize("write_tier", ["log", "dir"])
def test_on_disk_nodes_equal_reference(write_tier, monkeypatch):
    """``ClusterStore(write_tier=)`` gives each node the on-disk tier pair
    the reference's ``REPRO_WRITE_TIER`` gives it: the same blobs and the
    same tier gauges after the same ingest and writes."""
    monkeypatch.setenv("REPRO_WRITE_TIER", write_tier)  # the reference's knob
    vol = volume(seed=8)
    ref = ref_cluster(2, vol=vol, replication=2)
    store = port_store(2, vol=vol, replication=2, write_tier=write_tier)
    write(store, 0, (3, 4, 5), VOL)
    jcut.write_cutout(ref, 0, (3, 4, 5), VOL)
    assert_same_cluster(ref, store.backing)
    assert store.backing.tier_counters() == ref.tier_counters()
    assert [n.tier_stats()["write_tier"] for n in store.backing.nodes] == \
        [n.tier_stats()["write_tier"] for n in ref.nodes]
    np.testing.assert_array_equal(read(fresh(store), 0, (0, 0, 0), SHAPE),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    ref.close()
    store.backing.close()
    with pytest.raises(ValueError, match="write_tier"):
        ClusterStore(DatasetSpec(**spec_kw()), write_tier="ssd")


def test_heat_and_health_knobs_are_arguments(monkeypatch):
    """``heat_bits``, ``suspect_after`` and ``dead_after`` act as the
    reference's ``REPRO_HEAT_BITS``, ``REPRO_SUSPECT_AFTER`` and
    ``REPRO_DEAD_AFTER``: the same heat buckets, and the same health states
    after each failed probe of a node."""
    for name, value in (("REPRO_HEAT_BITS", "3"), ("REPRO_SUSPECT_AFTER", "2"),
                        ("REPRO_DEAD_AFTER", "4")):
        monkeypatch.setenv(name, value)  # the reference's knobs
    vol = volume(seed=12)
    ref = ref_cluster(3, vol=vol, replication=2)
    store = port_store(3, vol=vol, replication=2, heat_bits=3, suspect_after=2, dead_after=4)
    cluster = store.backing
    heat, jheat = cluster.access_heat(), ref.access_heat()
    assert heat["bits"] == jheat["bits"] == 3
    assert heat["write"] == jheat["write"]  # reads differ: the card keeps its copy

    def down(*a, **kw):
        raise OSError("node unreachable")

    for c in (ref, cluster):
        monkeypatch.setattr(c.nodes[1], "has_cuboid", down)
    for _ in range(5):
        assert cluster.probe_health() == ref.probe_health()
        assert cluster.node_health() == ref.node_health()
    assert [h["state"] for h in cluster.node_health()] == ["alive", "dead", "alive"]
