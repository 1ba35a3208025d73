"""Port parity: the HTTP front door over real sockets.

A port `FrontDoor` (device stores on the CPU over a port cluster) and a
reference `FrontDoor` over the same state, both on loopback, must answer
the same URLs with the same status, headers and bytes, raw and zlib.  The
coalescer dedupes identical concurrent cutouts, the admission limiter
sheds with 503 while the control plane answers, ``DELETE /nodes/<i>``
under readers loses no read, and `RetryingClient` retries the 503s.  The
port's witness is on for every test (`torch_witness`).
"""
import collections
import json
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
from torch_cluster_pair import SHAPE, port_store, read, ref_cluster, spec_kw, volume
from torch_witness import port_witness  # noqa: F401

from repro.cluster import ClusterStore as JClusterStore
from repro.cluster import VolumeService as JService
from repro.core.annotations import AnnotationProject as JProject
from repro.core.cuboid import DatasetSpec as JSpec
from repro.serve.http_front import FrontDoor as JFrontDoor
from repro_torch.cluster import ClusterStore, VolumeService, deadline
from repro_torch.core.annotations import AnnotationProject
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.cutout import ingest
from repro_torch.core.store import DeviceCuboidStore
from repro_torch.serve import FrontDoor, RetryingClient, http_front


def http(method, url, body=None, headers=None):
    """One urllib round trip -> (status, headers, payload bytes)."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def get_volume(url):
    status, headers, payload = http("GET", url)
    assert status == 200, payload
    if headers.get("X-Encode") == "zlib":
        payload = zlib.decompress(payload)
    shape = tuple(int(s) for s in headers["X-Shape"].split(","))
    return np.frombuffer(payload, dtype=headers["X-Dtype"]).reshape(shape)


def box_url(base, lo, hi, verb="cutout"):
    return f"{base}/web/{verb}/0/" + "/".join(f"{a},{b}" for a, b in zip(lo, hi))


@pytest.fixture()
def doors():
    """A reference and a port front door over the same dataset "web" (an
    R=2 cluster of 3 nodes) and project "anno"."""
    vol = volume(seed=1)
    jsvc, svc = JService(), VolumeService()
    jsvc.add_dataset("web", ref_cluster(3, "web", vol=vol, replication=2))
    svc.add_dataset("web", port_store(3, "web", vol=vol, replication=2))
    image = spec_kw("anno")
    jproj = JProject("anno", JSpec(**image), store_factory=lambda s: JClusterStore(
        s, n_nodes=2, cache_bytes=0, write_behind=False, replication=1))
    proj = AnnotationProject("anno", DatasetSpec(**image), device="cpu",
                             store_factory=lambda s: DeviceCuboidStore(
                                 s, device="cpu", backing=ClusterStore(s, n_nodes=2)))
    for p, s in ((jproj, jsvc), (proj, svc)):
        a = p.meta.create(ann_type="synapse")
        labels = np.zeros((8, 8, 4), np.uint32)
        labels[1:7, 2:8, 1:4] = a.ann_id
        p.write(0, (16, 16, 8), labels)
        s.add_project("anno", p)
    with JFrontDoor(jsvc) as jdoor, FrontDoor(svc) as door:
        yield jdoor, door, vol


_HEADERS = ("Content-Type", "X-Shape", "X-Dtype", "X-Encode", "X-Level", "X-Cuboids-Read",
            "X-Runs", "X-Zero-Copy", "X-Id", "X-Lo", "Retry-After")
_PUT = volume(seed=9)[:10, :7, :5]
URLS = {
    "cutout": ("GET", "/web/cutout/0/5,25/6,20/7,15", None),
    "cutout_v1": ("GET", "/v1/web/cutout/0/0,32/0,32/0,16", None),
    "cutout_zlib": ("GET", "/web/cutout/0/3,19/0,16/0,8?encode=zlib", None),
    "cutout_level": ("GET", "/web/cutout/0/3,19/0,16/0,8?encode=zlib&level=9", None),
    "cutout_aligned": ("GET", "/web/cutout/0/8,16/8,24/4,12", None),
    "cutout_channel": ("GET", "/web/cutout/0/0,8/0,8/0,4?channel=0", None),
    "xy": ("GET", "/web/xy/0/0,20/0,30/3,9", None),
    "xz": ("GET", "/web/xz/0/1,20/2,30/3,9?encode=zlib", None),
    "yz": ("GET", "/web/yz/0/1,20/2,30/3,9", None),
    "bbox": ("GET", "/anno/objects/1/boundingbox", None),
    "bbox_r0": ("GET", "/anno/objects/1/boundingbox/0", None),
    "object_cutout": ("GET", "/anno/objects/1/cutout", None),
    "object_cutout_box": ("GET", "/anno/objects/1/cutout/0/16,20/16,24/8,12?encode=zlib",
                          None),
    "put_raw": ("PUT", "/web/cutout/0/3,13/4,11/5,10", _PUT.tobytes()),
    "put_zlib": ("PUT", "/web/cutout/0/9,19/9,16/9,14?encode=zlib",
                 zlib.compress(_PUT.tobytes(), 1)),
    "put_sync": ("PUT", "/web/cutout/0/3,13/4,11/5,10?sync=1", _PUT.tobytes()),
    "put_bad_size": ("PUT", "/web/cutout/0/0,4/0,4/0,4", b"\x01" * 5),
    "batch": ("POST", "/web/batch/cutout", json.dumps(
        {"boxes": [[[0, 0, 0], [8, 8, 4]], [[5, 5, 5], [30, 20, 16]]]}).encode()),
    "flush": ("POST", "/web/flush", None),
    "flush_all": ("POST", "/flush", None),
    "compact": ("POST", "/compact", None),
    "topology": ("GET", "/web/topology", None),
    "rebalance": ("POST", "/web/rebalance", json.dumps({"target": 4}).encode()),
    "add_node": ("POST", "/web/nodes", None),
    "remove_node": ("DELETE", "/web/nodes/0", None),
    "no_route": ("GET", "/web/nothing", None),
    "root": ("GET", "/", None),
    "wrong_method": ("DELETE", "/web/cutout/0/0,4/0,4/0,4", None),
    "bad_box": ("GET", "/web/cutout/0/0,4/4,0/0,4", None),
    "unknown_dataset": ("GET", "/nope/cutout/0/0,4/0,4/0,4", None),
    "bad_json": ("POST", "/web/rebalance", b"{not json"),
    "trace_unknown": ("GET", "/trace/none", None),
}


def canon(payload, headers):
    """A JSON body without its wall times; other bodies as bytes."""
    if headers.get("Content-Type") != "application/json":
        return payload
    body = json.loads(payload)

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k != "seconds"}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    return strip(body)


@pytest.mark.parametrize("name", sorted(URLS))
def test_same_urls_same_answers(doors, name):
    """Status, wire headers and bytes equal the reference front door's;
    a full read afterwards does too."""
    jdoor, door, _ = doors
    method, path, body = URLS[name]
    want = http(method, jdoor.url + path, body)
    got = http(method, door.url + path, body)
    assert got[0] == want[0], (got, want)
    assert {h: got[1].get(h) for h in _HEADERS} == {h: want[1].get(h) for h in _HEADERS}
    assert canon(got[2], got[1]) == canon(want[2], want[1])
    full = "/web/cutout/0/0,32/0,32/0,16"
    assert http("GET", door.url + full)[2] == http("GET", jdoor.url + full)[2]


def test_stats_and_metrics_routes_answer(doors):
    jdoor, door, _ = doors
    for path in ("/web/stats", "/web/metrics", "/metrics"):
        want, got = http("GET", jdoor.url + path), http("GET", door.url + path)
        assert got[0] == want[0] == 200, path
        assert got[1]["Content-Type"] == want[1]["Content-Type"]
    stats = json.loads(http("GET", door.url + "/web/stats")[2])
    assert stats["replication"] == 2 and len(stats["nodes"]) == 3


def test_mixed_concurrent_cutouts_all_correct(doors):
    _, door, base = doors
    failures = []

    def fetch(tid):
        rng = np.random.default_rng(100 + tid)
        try:
            for _ in range(5):
                lo = [int(rng.integers(0, s - 4)) for s in SHAPE]
                hi = [l + 4 for l in lo]
                sl = tuple(slice(a, b) for a, b in zip(lo, hi))
                np.testing.assert_array_equal(get_volume(box_url(door.url, lo, hi)), base[sl])
        except Exception as e:  # surfaced through failures
            failures.append((tid, e))

    threads = [threading.Thread(target=fetch, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not failures, failures


class _SlowDevice(DeviceCuboidStore):
    """A device store whose cutouts take a beat (each makes its cuboids
    resident first), so concurrent requests pile up behind the
    coalescer's leader."""

    def ensure_resident(self, r, channel, cells):
        time.sleep(0.03)
        return super().ensure_resident(r, channel, cells)


def test_identical_concurrent_cutouts_coalesce():
    base = volume(seed=4)
    spec = DatasetSpec(**spec_kw("web"))
    store = _SlowDevice(spec, device="cpu",
                        backing=ClusterStore(spec, n_nodes=2, replication=2))
    ingest(store, 0, base)
    service = VolumeService()
    service.add_dataset("web", store)
    with FrontDoor(service, admit_limit=16) as door:
        url = box_url(door.url, (0, 0, 0), (16, 16, 8))
        barrier = threading.Barrier(8)
        failures = []

        def fetch():
            try:
                barrier.wait(timeout=10)
                for _ in range(4):
                    np.testing.assert_array_equal(get_volume(url), base[:16, :16, :8])
            except Exception as e:  # surfaced through failures
                failures.append(e)

        threads = [threading.Thread(target=fetch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not failures, failures
        counters = door.counters()
        assert counters["batches"] >= 1
        assert counters["coalesced"] + counters["deduped"] > 0, counters
    store.backing.close()


@pytest.mark.parametrize("followers", [1, 2])
def test_coalesced_cutouts_run_under_their_own_deadlines(monkeypatch, followers):
    """A leader that drains past its own deadline serves the requests queued
    behind it under theirs: one alone runs inline on the leader's thread,
    two run on the cluster's batch pool.  With the leader's budget each
    cold read would be cut to a millisecond a node and fail with 500."""
    base = volume(seed=5)
    spec = DatasetSpec(**spec_kw("web"))
    store = DeviceCuboidStore(spec, device="cpu",
                              backing=ClusterStore(spec, n_nodes=2, replication=2))
    ingest(store, 0, base)
    service = VolumeService()
    service.add_dataset("web", DeviceCuboidStore(spec, device="cpu", backing=store.backing))
    boxes = [((0, 0, 0), (8, 8, 4)), ((16, 16, 8), (32, 32, 16)), ((0, 16, 0), (16, 32, 8))]
    entered, release, seen = threading.Event(), threading.Event(), {}
    real = http_front.get_cutout

    def get_cutout(svc, request):
        lo = tuple(request["lo"])
        if lo == boxes[0][0]:  # the leader: done, then held past its deadline
            resp = real(svc, request)
            seen["leader_expires"] = deadline.expiry()
            entered.set()
            release.wait(timeout=30)
            seen[lo] = deadline.remaining()
            return resp
        seen[lo] = deadline.remaining()
        return real(svc, request)

    monkeypatch.setattr(http_front, "get_cutout", get_cutout)
    with FrontDoor(service, deadline_ms=1000) as door:
        results = {}

        def fetch(lo, hi):
            results[lo] = http("GET", box_url(door.url, lo, hi))

        threads = [threading.Thread(target=fetch, args=boxes[0])]
        threads[0].start()
        assert entered.wait(timeout=30)
        expires = seen["leader_expires"]
        time.sleep(max(0.0, expires - 0.5 - time.monotonic()))
        for lo, hi in boxes[1:1 + followers]:
            threads.append(threading.Thread(target=fetch, args=(lo, hi)))
            threads[-1].start()
        t_end = time.monotonic() + 30
        while len(door.coalescer._queues.get("web", ())) < followers:
            assert time.monotonic() < t_end
            time.sleep(0.005)
        time.sleep(max(0.0, expires + 0.02 - time.monotonic()))
        release.set()
        for t in threads:
            t.join(timeout=60)
    assert seen[boxes[0][0]] == 0.0  # the leader's own budget was spent
    for lo, hi in boxes[:1 + followers]:
        status, headers, payload = results[lo]
        assert status == 200, payload
        box = tuple(slice(a, b) for a, b in zip(lo, hi))
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(base[box].shape), base[box])
        if lo != boxes[0][0]:
            assert seen[lo] is not None and 0.0 < seen[lo] <= 1.0, seen
    store.backing.close()


@pytest.mark.parametrize("n", [1, 3])
def test_a_failed_cutout_fails_only_its_own_request(monkeypatch, n):
    """One request of a drained batch that raises answers 500 alone; the
    others of its batch (run on the batch pool) are served."""
    base = volume(seed=6)
    spec = DatasetSpec(**spec_kw("web"))
    store = DeviceCuboidStore(spec, device="cpu",
                              backing=ClusterStore(spec, n_nodes=2, replication=2))
    ingest(store, 0, base)
    service = VolumeService()
    service.add_dataset("web", store)
    real = http_front.get_cutout

    def get_cutout(svc, request):
        if request["lo"] == [0, 0, 0]:
            raise TimeoutError("node 0 op exceeded the deadline budget")
        return real(svc, request)

    monkeypatch.setattr(http_front, "get_cutout", get_cutout)
    boxes = [([0, 0, 0], [8, 8, 4]), ([8, 8, 4], [24, 24, 12]), ([0, 8, 0], [8, 32, 16])][:n]
    items = [http_front._Pending(dict(dataset="web", resolution=0, lo=lo, hi=hi))
             for lo, hi in boxes]
    coalescer = http_front._CutoutCoalescer(service)
    coalescer._queues["web"] = collections.deque(items)
    coalescer._busy.add("web")
    coalescer._drain("web", store.backing)
    assert items[0].response["status"] == 500
    assert "exceeded the deadline budget" in items[0].response["error"]
    for item, (lo, hi) in zip(items[1:], boxes[1:]):
        box = tuple(slice(a, b) for a, b in zip(lo, hi))
        assert item.response.get("status", 200) == 200, item.response
        np.testing.assert_array_equal(
            np.frombuffer(item.response["data"], np.uint8).reshape(base[box].shape), base[box])
    store.backing.close()


class _GatedCluster(ClusterStore):
    """A cluster whose block fetches wait for a gate (a cold read blocks)."""

    gate = None

    def fetch_blocks(self, r, runs, channel=0, sink=None):
        if self.gate is not None:
            self.gate.wait(timeout=30)
        return super().fetch_blocks(r, runs, channel, sink)


def gated_service(seed):
    spec = DatasetSpec(**spec_kw("web"))
    cluster = _GatedCluster(spec, n_nodes=2)
    ingest(DeviceCuboidStore(spec, device="cpu", backing=cluster), 0, volume(seed=seed))
    cluster.gate = threading.Event()
    service = VolumeService()
    service.add_dataset("web", DeviceCuboidStore(spec, device="cpu", backing=cluster))
    return service, cluster


def test_admission_limit_sheds_with_503():
    service, cluster = gated_service(2)
    with FrontDoor(service, admit_limit=2, admit_timeout=0.1, coalesce=False) as door:
        url = box_url(door.url, (0, 0, 0), (8, 8, 4))
        results = []

        def fetch():
            results.append(http("GET", url)[0])

        threads = [threading.Thread(target=fetch) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.5)  # 2 enter, the rest time out of admission
        status, _, _ = http("GET", f"{door.url}/web/topology")
        assert status == 200  # the control plane is never shed
        cluster.gate.set()
        for t in threads:
            t.join(timeout=30)
        assert sorted(results)[:1] == [200]
        assert results.count(503) >= 1, results
        assert door.shed >= 1 and door.counters()["shed"] == results.count(503)
    cluster.close()


def test_retrying_client_retries_shed_requests():
    """A client behind a saturated limiter backs off on 503 (honouring
    ``Retry-After``) and gets its answer once the slot frees."""
    service, cluster = gated_service(3)
    with FrontDoor(service, admit_limit=1, admit_timeout=0.05, coalesce=False,
                   retry_after=1) as door:
        url = box_url(door.url, (0, 0, 0), (8, 8, 4))
        blocker = threading.Thread(target=http, args=("GET", url))
        blocker.start()
        time.sleep(0.2)
        client = RetryingClient(door.url, retries=6, seed=0)
        timer = threading.Timer(0.5, cluster.gate.set)
        timer.start()
        status, headers, payload = client.get_raw("/web/cutout/0/0,8/0,8/0,4")
        blocker.join(timeout=30)
        timer.join()
        assert status == 200
        np.testing.assert_array_equal(np.frombuffer(payload, np.uint8).reshape(8, 8, 4),
                                      volume(seed=3)[:8, :8, :4])
        assert client.counters()["retried"] >= 1 and client.slept_s >= 1.0
        gone = RetryingClient(door.url.replace(str(door.address[1]), "1"), retries=2,
                              backoff=0.01, timeout=2)
        with pytest.raises(urllib.error.URLError):
            gone.get_json("/web/topology")
        assert gone.counters()["attempts"] == 2
        assert client.get_json("/web/topology")["n_nodes"] == 2
    cluster.close()


def test_remove_node_under_readers_over_http():
    """An R=2 cluster serves bit-identical cutouts while ``DELETE
    /v1/web/nodes/1`` removes a live member: zero lost reads, and a fresh
    device store reads the whole volume after."""
    base = volume(seed=11)
    store = port_store(3, "web", vol=base, replication=2)
    store.backing.flush()
    service = VolumeService()
    service.add_dataset("web", store)
    spec = store.spec
    failures, lost_reads = [], []
    stop = threading.Event()
    with FrontDoor(service) as door:

        def reader(tid):
            rng = np.random.default_rng(300 + tid)
            try:
                while not stop.is_set():
                    lo = [int(rng.integers(0, s - 4)) for s in SHAPE]
                    hi = [l + 4 for l in lo]
                    status, headers, payload = http("GET", box_url(door.url, lo, hi))
                    if status != 200:
                        lost_reads.append((tid, status))
                        continue
                    got = np.frombuffer(payload, np.uint8).reshape(4, 4, 4)
                    np.testing.assert_array_equal(
                        got, base[tuple(slice(a, b) for a, b in zip(lo, hi))])
            except Exception as e:  # surfaced through failures
                failures.append((tid, e))

        threads = [threading.Thread(target=reader, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)
            status, _, payload = http("DELETE", f"{door.url}/v1/web/nodes/1")
            env = json.loads(payload)
            assert status == 200, env
            assert env["n_nodes"] == 2 and env["topology"]["n_nodes"] == 2
            time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
    assert not failures, failures
    assert not lost_reads, lost_reads
    after = DeviceCuboidStore(spec, device="cpu", backing=store.backing)
    np.testing.assert_array_equal(read(after, 0, (0, 0, 0), SHAPE), base)
    store.backing.close()


@pytest.mark.parametrize("ms,want", [(None, None), (0, None), (-1, None), (2000, 2.0),
                                     (deadline.DEFAULT_DEADLINE_MS, 2.0), (150, 0.15)])
def test_deadline_budget_is_an_argument(ms, want):
    """``FrontDoor(deadline_ms=)`` sets each data-plane request's budget
    (2,000 ms by default; zero or ``None`` turns it off), and a budget
    opened inside another never extends it."""
    service = VolumeService()
    door = FrontDoor(service) if ms == deadline.DEFAULT_DEADLINE_MS else \
        FrontDoor(service, deadline_ms=ms)
    assert door.deadline_s == want
    assert deadline.remaining() is None
    with deadline.budget(door.deadline_s):
        left = deadline.remaining()
        assert (left is None) == (want is None)
        with deadline.budget(10.0):
            assert deadline.remaining() <= (10.0 if want is None else want)
    assert deadline.remaining() is None
