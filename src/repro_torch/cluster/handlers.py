"""RESTful-style data-service verbs over the cluster (paper §4.2), served
from the card.

The paper's Web services expose cutout / annotation queries as stateless
HTTP verbs; any front-end can serve any request because state lives in the
data cluster.  We reproduce that contract transport-free: every handler is
a pure ``(service, request dict) -> response dict`` function — no sockets,
no framework — so it composes with `repro_torch.serve` (or any HTTP shim) and is
trivially testable.  Verb strings mirror the paper's URL forms
(``GET /cutout``, ``objects/.../boundingbox``, ...).

Requests name a dataset or annotation project by key; volumes travel as
numpy arrays by default or zlib blobs with ``{"encode": "zlib"}`` (the
paper returns compressed volumes on the wire).  Responses always carry an
integer ``status`` using HTTP conventions.

A dataset is a `DeviceCuboidStore`, usually over a host store (its
``backing``: a `ClusterStore` of node stores, or one `CuboidStore`).  The
voxel verbs run the port's cutout engine on the store's device, so every
cutout is assembled by the `cutout_gather` kernel on the card, and the
volume comes to the host once, just before it is encoded.  The storage
verbs and counters (flush, compact, stats, topology, rebalance, nodes,
``/metrics``) read the host store through `_host`; a device store without
a backing answers them as a single node that holds nothing on the host.

Consistency contract (the cache tier + write-behind queue, paper §6):

* ``PUT /cutout`` returning 200 guarantees **read-your-writes**: every
  subsequent ``GET /cutout`` through the service sees the write, even
  while it is still pending in a node's write-behind queue.  Pass
  ``{"sync": true}`` to additionally force durability before the response.
* ``POST /flush`` is the explicit **durability barrier**: when it returns,
  every previously accepted write has been applied to the node backends.
* ``GET /stats`` exposes the path/cache/queue counters (hits, misses,
  queue depth) a deployment monitors to size the tiers.

Elasticity contract (paper §6 "dynamically redistribute data"):

* ``GET /topology`` reports the cluster layout — node count, the explicit
  per-resolution curve partitions, and per-node key occupancy.
* ``POST /rebalance`` re-cuts the partitions by occupancy (optionally
  growing/shrinking to ``target`` nodes) and migrates keys *live*:
  cutout reads and writes issued concurrently through the service remain
  bit-identical before, during, and after the move.
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.annotations import AnnotationProject
from ..core.compact import CompactionStats
from ..core.cutout import CutoutStats, batch_cutout, cutout, project, write_cutout
from ..core.distributed import signed_view
from ..core.store import DeviceCuboidStore, PathStats, host_view
from ..obs import trace
from ..obs.hist import Histogram
from ..obs.registry import REGISTRY, Metric, metric
from .store import ClusterStore, RebalanceInFlight

Request = Dict[str, Any]
Response = Dict[str, Any]

# Malformed client input must come back as a 4xx dict, never an exception:
# missing keys, bad ints/shapes, corrupt zlib payloads, non-iterable boxes.
_BAD_REQUEST = (KeyError, ValueError, IndexError, TypeError, zlib.error)


class VolumeService:
    """Registry of datasets and annotation projects behind the verbs.

    The service itself is stateless routing glue: all durable state lives
    in the registered stores, each a `DeviceCuboidStore` over a
    single-node `CuboidStore` or a sharded `ClusterStore` (the verbs do not
    care which, that is C3).
    """

    def __init__(self):
        self.datasets: Dict[str, DeviceCuboidStore] = {}
        self.projects: Dict[str, AnnotationProject] = {}

    def add_dataset(self, name: str, store: DeviceCuboidStore) -> None:
        if not isinstance(store, DeviceCuboidStore):
            raise TypeError(f"dataset {name!r} must be a DeviceCuboidStore (a host "
                            f"store goes under one as its backing), got "
                            f"{type(store).__name__}")
        self.datasets[name] = store

    def add_project(self, name: str, proj: AnnotationProject) -> None:
        self.projects[name] = proj


class _DeviceOnly:
    """The host side of a device store without a backing: a single node
    that holds nothing on the host (no reads or writes counted, nothing to
    flush or compact); its keys are the device's nonzero cuboids."""

    decode_policy = None

    def __init__(self, store: DeviceCuboidStore):
        self._store = store
        self.read_stats = PathStats()
        self.write_stats = PathStats()

    def flush(self) -> int:
        return 0

    def compact(self, max_segments: Optional[int] = None) -> CompactionStats:
        return CompactionStats()

    def tier_stats(self) -> Dict[str, object]:
        return {"read_tier": None, "write_tier": None,
                "compactions": {"runs": 0, **CompactionStats().asdict()}}

    def key_count(self) -> int:
        store = self._store
        n = 0
        for r in range(store.spec.n_resolutions):
            for c in range(store.spec.n_channels):
                packed = store.peek(r, c)
                if packed is not None:  # a row is stored unless all zero
                    rows = signed_view(packed).flatten(1)
                    n += int(((rows.amax(1) != 0) | (rows.amin(1) != 0)).sum())
        return n


def _host(store: DeviceCuboidStore) -> Tuple[Any, Optional[ClusterStore]]:
    """The host store under a dataset, and the same store again when it is
    a `ClusterStore` (else ``None``): what the storage verbs and counters
    read.  A device store without a backing answers through `_DeviceOnly`."""
    host = store.backing if store.backing is not None else _DeviceOnly(store)
    return host, host if isinstance(host, ClusterStore) else None


def _to_host(vol: torch.Tensor, dtype) -> np.ndarray:
    """A device volume as a numpy array of the dataset's dtype; the copy
    waits for the kernel that made it."""
    return host_view(vol.cpu(), dtype)


def _error(status: int, message: str) -> Response:
    """The uniform error envelope: ``{"status": 4xx/5xx, "error": msg}``.

    Every handler returns ``{"status": 200, ...}`` on success and this
    shape otherwise — 404 unknown dataset/project/object, 400 malformed
    request, 409 topology change in flight, 405 unknown verb (503 is the
    transport layer's: the HTTP front door sheds with it when the
    admission limit is exceeded)."""
    return {"status": status, "error": message}


def _zlib_level(request: Request, store=None) -> int:
    """Negotiated zlib level: explicit request ``level`` wins, else the
    dataset's ``DatasetSpec.compress_level``, else 1 (wire default)."""
    level = request.get("level")
    if level is None:
        spec = getattr(store, "spec", None)
        level = getattr(spec, "compress_level", 1)
    level = int(level)
    if not (0 <= level <= 9):
        raise ValueError(f"zlib level {level} outside [0, 9]")
    return level


def _encode_volume(vol: np.ndarray, request: Request, store=None) -> Response:
    body: Response = {"status": 200, "shape": tuple(vol.shape), "dtype": str(vol.dtype)}
    if request.get("encode") == "zlib":
        level = _zlib_level(request, store)
        body["data"] = zlib.compress(np.ascontiguousarray(vol).tobytes(), level)
        body["encode"] = "zlib"
        body["level"] = level
    else:
        body["data"] = vol
    return body


def _decode_volume(request: Request) -> np.ndarray:
    data = request["data"]
    if request.get("encode") == "zlib":
        raw = zlib.decompress(data)
        vol = np.frombuffer(raw, dtype=np.dtype(request["dtype"])).reshape(request["shape"])
        # frombuffer over bytes yields a read-only view; write paths that
        # normalize/pad the block in place would raise "assignment
        # destination is read-only", so hand over a writable copy.
        return vol.copy()
    vol = np.asarray(data)
    # a raw wire payload is a read-only view of the request body
    return vol if vol.flags.writeable else vol.copy()


def _box(request: Request):
    lo = [int(x) for x in request["lo"]]
    hi = [int(x) for x in request["hi"]]
    return lo, hi


# -- observability ----------------------------------------------------------

# PathStats fields that are occupancy gauges, not monotone counters.
_GAUGE_FIELDS = {"inflight", "queue_depth", "queue_peak"}
# /metrics truncates each heat direction to its N hottest buckets so the
# exposition stays bounded on large volumes (GET /stats has the full map).
_HEAT_TOP = 16


def _request_hist(path: str, dataset: object) -> Histogram:
    """The request-latency series for one ``(path, dataset)``.

    Observed at the handler layer — not the HTTP front door — so the
    benches and the batch pool (which call handlers directly, transport
    free) populate the same p50/p99 the ``/metrics`` scrape exports."""
    return REGISTRY.histogram(
        "repro_request_seconds",
        {"path": path, "dataset": str(dataset)},
        "end-to-end handler latency by request path",
    )


def _collect_store_metrics(service: VolumeService, targets: List[str]) -> List[Metric]:
    """Scrape-time translation of live store counters into metric families.

    Nothing here double-counts: the stores already own their counters
    (`PathStats`, cache/queue aggregates, heat maps, topology), so a
    scrape reads them and renders samples — there is no second counter
    store to drift out of sync."""
    # {name: (mtype, help, [(label dict, value), ...])}
    families: Dict[str, Tuple[str, str, List[Tuple[Dict[str, object], float]]]] = {}

    def add(name: str, mtype: str, help_text: str, labels: Dict[str, object], value) -> None:
        fam = families.setdefault(name, (mtype, help_text, []))
        fam[2].append((labels, float(value)))

    for n in targets:
        store, cluster = _host(service.datasets[n])
        for path, stats in (("read", store.read_stats), ("write", store.write_stats)):
            for field, value in dataclasses.asdict(stats).items():
                labels = {"dataset": n, "path": path}
                if field in _GAUGE_FIELDS:
                    add(f"repro_{field}", "gauge", f"PathStats gauge {field}", labels, value)
                elif field.endswith("_s"):
                    add(
                        f"repro_{field[:-2]}_seconds_total",
                        "counter",
                        f"PathStats accumulated seconds {field}",
                        labels,
                        value,
                    )
                else:
                    add(
                        f"repro_{field}_total",
                        "counter",
                        f"PathStats counter {field}",
                        labels,
                        value,
                    )
        if cluster is not None:
            for k, v in cluster.cache_counters().items():
                add(
                    "repro_cluster_cache_total",
                    "counter",
                    "aggregate hot-cuboid cache counters across node shards",
                    {"dataset": n, "counter": k},
                    v,
                )
            for k, v in cluster.queue_counters().items():
                add(
                    "repro_cluster_queue",
                    "gauge",
                    "aggregate write-behind queue counters across node shards",
                    {"dataset": n, "counter": k},
                    v,
                )
            topo = cluster.topology()
            add("repro_nodes", "gauge", "cluster shard count", {"dataset": n}, topo["n_nodes"])
            add(
                "repro_replication",
                "gauge",
                "effective replication factor",
                {"dataset": n},
                topo["replication"],
            )
            add(
                "repro_rebalancing",
                "gauge",
                "1 while a live migration is in flight",
                {"dataset": n},
                int(bool(topo["rebalancing"])),
            )
            for i, keys in enumerate(topo["keys_per_node"]):
                add(
                    "repro_node_keys",
                    "gauge",
                    "key occupancy per node shard",
                    {"dataset": n, "node": i},
                    keys,
                )
            for h in cluster.node_health():
                add(
                    "repro_node_health",
                    "gauge",
                    "per-node health state (1 = the labelled state is current)",
                    {"dataset": n, "node": h["node"], "state": h["state"]},
                    1,
                )
                add(
                    "repro_node_repair_pending",
                    "gauge",
                    "write repairs queued for the node (anti-entropy backlog)",
                    {"dataset": n, "node": h["node"]},
                    h["repair_pending"],
                )
            heat = cluster.access_heat(top=_HEAT_TOP)
            add(
                "repro_segment_heat_bits",
                "gauge",
                "morton shift aggregating cells into heat buckets",
                {"dataset": n},
                heat["bits"],
            )
            for direction in ("read", "write"):
                for r, bucket, count in heat[direction]:
                    add(
                        "repro_segment_heat_total",
                        "counter",
                        "per-segment access-heat touch counts (hottest buckets)",
                        {"dataset": n, "direction": direction, "resolution": r, "bucket": bucket},
                        count,
                    )
    for k, v in trace.RING.counters().items():
        add("repro_trace_ring", "gauge", "span ring occupancy counters", {"counter": k}, v)
    return [
        metric(name, mtype, help_text, samples)
        for name, (mtype, help_text, samples) in sorted(families.items())
    ]


def get_metrics(service: VolumeService, request: Request) -> Response:
    """``GET /metrics`` (or ``GET /<dataset>/metrics``) — Prometheus text.

    Histogram families (request / migration / flush latency) render from
    the process-global :data:`~repro_torch.obs.registry.REGISTRY`; counters and
    gauges are collected from the live stores at scrape time.  The
    envelope carries ``text`` + ``content_type`` and the HTTP front door
    serves it verbatim (exposition format version 0.0.4)."""
    name = request.get("dataset")
    if name is not None and name not in service.datasets:
        return _error(404, f"unknown dataset {name!r}")
    targets = [name] if name is not None else sorted(service.datasets)
    text = REGISTRY.prometheus_text(extra=_collect_store_metrics(service, targets))
    return {
        "status": 200,
        "text": text,
        "content_type": "text/plain; version=0.0.4; charset=utf-8",
    }


def get_trace(service: VolumeService, request: Request) -> Response:
    """``GET /trace/<id>`` — the span tree of one sampled request.

    404 means the id was never sampled (send ``X-Trace-Id`` to force a
    trace) or its spans have been evicted from the ring."""
    tid = request.get("trace")
    if not tid:
        return _error(400, "missing trace id")
    tid = str(tid)
    spans = trace.trace_spans(tid)
    if not spans:
        return _error(404, f"no spans retained for trace {tid!r}")
    return {"status": 200, "trace": tid, "n_spans": len(spans), "spans": trace.trace_tree(tid)}


def get_cutout(service: VolumeService, request: Request) -> Response:
    """``GET /<dataset>/cutout/<r>/<lo>/<hi>`` — dense sub-volume read."""
    store = service.datasets.get(request.get("dataset"))
    if store is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    with _request_hist("cutout", request.get("dataset")).time():
        try:
            r = int(request.get("resolution", 0))
            lo, hi = _box(request)
            stats = CutoutStats()
            vol = cutout(store, r, lo, hi, channel=int(request.get("channel", 0)), stats=stats)
            body = _encode_volume(_to_host(vol, store.spec.dtype), request, store)
        except _BAD_REQUEST as e:
            return _error(400, f"bad cutout request: {e}")
        body["cuboids_read"] = stats.cuboids_read
        body["runs"] = stats.runs
        body["zero_copy"] = bool(stats.zero_copy)  # aligned: no trim copy made
        return body


def put_cutout(service: VolumeService, request: Request) -> Response:
    """``PUT /<dataset>/cutout/<r>/<lo>`` — dense sub-volume write."""
    store = service.datasets.get(request.get("dataset"))
    if store is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    with _request_hist("put", request.get("dataset")).time():
        try:
            r = int(request.get("resolution", 0))
            lo = [int(x) for x in request["lo"]]
            data = _decode_volume(request)
            write_cutout(
                store,
                r,
                lo,
                data,
                channel=int(request.get("channel", 0)),
                discipline=request.get("discipline", "overwrite"),
            )
        except _BAD_REQUEST as e:
            return _error(400, f"bad write request: {e}")
        body: Response = {"status": 200, "written_shape": tuple(data.shape)}
        if request.get("sync"):
            body["flushed"] = _host(store)[0].flush()  # durability barrier before reply
        return body


def get_projection(service: VolumeService, request: Request) -> Response:
    """``GET /<dataset>/xy/...`` — tile/MIP: a cutout with one axis reduced."""
    store = service.datasets.get(request.get("dataset"))
    if store is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    with _request_hist("projection", request.get("dataset")).time():
        try:
            r = int(request.get("resolution", 0))
            lo, hi = _box(request)
            tile = project(
                store,
                r,
                lo,
                hi,
                axis=int(request.get("axis", 2)),
                reduce=request.get("reduce", "slice"),
                channel=int(request.get("channel", 0)),
            )
            return _encode_volume(_to_host(tile, store.spec.dtype), request, store)
        except _BAD_REQUEST as e:
            return _error(400, f"bad projection request: {e}")


def get_annotation_bbox(service: VolumeService, request: Request) -> Response:
    """``GET /objects/<id>/boundingbox`` — index-only, no voxel I/O."""
    proj = service.projects.get(request.get("project"))
    if proj is None:
        return _error(404, f"unknown project {request.get('project')!r}")
    try:
        ann_id = int(request["id"])
        r = int(request.get("resolution", 0))
    except _BAD_REQUEST as e:
        return _error(400, f"bad boundingbox request: {e}")
    bbox = proj.bounding_box(ann_id, r)
    if bbox is None:
        return _error(404, f"object {ann_id} has no voxels")
    lo, hi = bbox
    return {"status": 200, "id": ann_id, "lo": list(lo), "hi": list(hi)}


def get_object_cutout(service: VolumeService, request: Request) -> Response:
    """``GET /objects/<id>/cutout`` — one object's voxels, others masked."""
    proj = service.projects.get(request.get("project"))
    if proj is None:
        return _error(404, f"unknown project {request.get('project')!r}")
    try:
        ann_id = int(request["id"])
        r = int(request.get("resolution", 0))
        box = None
        if "lo" in request and "hi" in request:
            box = _box(request)
        lo, vol = proj.object_cutout(ann_id, r, box)
        body = _encode_volume(_to_host(vol, np.uint32), request)
    except _BAD_REQUEST as e:
        return _error(400, f"bad object cutout request: {e}")
    body["id"] = ann_id
    body["lo"] = list(lo)
    return body


def post_flush(service: VolumeService, request: Request) -> Response:
    """``POST /flush`` — durability barrier for the write-behind tier.

    Drains the named dataset's pending writes (or every dataset's when no
    ``dataset`` key is given) into the node backends before responding.
    Stores without a write-behind queue flush trivially (0 drained).
    """
    name = request.get("dataset")
    if name is not None and name not in service.datasets:
        return _error(404, f"unknown dataset {name!r}")
    targets = [name] if name is not None else list(service.datasets)
    flushed = {n: int(_host(service.datasets[n])[0].flush()) for n in targets}
    return {"status": 200, "flushed": flushed, "total": sum(flushed.values())}


def post_compact(service: VolumeService, request: Request) -> Response:
    """``POST /compact`` — merge flushed log segments into the read tier.

    Targets the named dataset (or every dataset without a ``dataset``
    key).  Each store compacts every node shard whose write tier is an
    append log; stores without one compact trivially (all-zero stats).
    ``{"max_segments": n}`` bounds the work per node — the trickle shape
    the background compactor uses, versus this verb's default full drain.
    """
    name = request.get("dataset")
    if name is not None and name not in service.datasets:
        return _error(404, f"unknown dataset {name!r}")
    targets = [name] if name is not None else list(service.datasets)
    try:
        max_segments = request.get("max_segments")
        max_segments = None if max_segments is None else int(max_segments)
    except (TypeError, ValueError):
        return _error(400, f"bad max_segments {request.get('max_segments')!r}")
    compacted = {}
    for n in targets:
        stats = _host(service.datasets[n])[0].compact(max_segments)
        compacted[n] = stats if isinstance(stats, dict) else stats.asdict()
    return {
        "status": 200,
        "compacted": compacted,
        "total_keys": sum(int(c["keys"]) for c in compacted.values()),
    }


def get_stats(service: VolumeService, request: Request) -> Response:
    """``GET /stats`` — path/cache/queue counters for one dataset.

    Returns the read/write `PathStats` (including cache hit/miss,
    queue-depth gauges, and the cold-read pipeline's decode/prefetch
    counters) plus, for cluster stores, the aggregate cache and
    write-behind queue counters, the effective `DecodePolicy` knobs, the
    per-node `PathStats` breakdown (``nodes``), the effective replication
    factor, and the per-resolution partition boundaries.
    """
    dataset = service.datasets.get(request.get("dataset"))
    if dataset is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    store, cluster = _host(dataset)
    body: Response = {
        "status": 200,
        "read": dataclasses.asdict(store.read_stats),
        "write": dataclasses.asdict(store.write_stats),
    }
    if cluster is not None:
        body["cache"] = cluster.cache_counters()
        body["queue"] = cluster.queue_counters()
        # The aggregate above hides skew; the per-node breakdown is what a
        # deployment reads to spot a hot shard (then POST /rebalance).
        body["nodes"] = [
            {
                "read": dataclasses.asdict(node.read_stats),
                "write": dataclasses.asdict(node.write_stats),
            }
            for node in cluster.nodes
        ]
        router = cluster.router
        body["replication"] = router.n_replicas
        body["partitions"] = {
            r: [int(b) for b in router.partition(r).bounds]
            for r in range(cluster.spec.n_resolutions)
        }
        body["heat"] = cluster.access_heat(top=_HEAT_TOP)
        # The health machine's live view: per-node state, consecutive
        # error count, and anti-entropy repair backlog.
        body["health"] = cluster.node_health()
    # Storage-tier gauges: cluster aggregate when available, else the
    # single store's own tier report (log segment/index sizes, lifetime
    # compaction totals) — the signal a compaction trigger and a capacity
    # dashboard read.
    body["tiers"] = cluster.tier_counters() if cluster is not None else store.tier_stats()
    pol = store.decode_policy
    if pol is None and cluster is not None:  # cluster on node defaults
        nodes = cluster.nodes
        pol = nodes[0].decode_policy if nodes else None
    if pol is not None:
        body["decode"] = {
            "workers": pol.workers,
            "chunk": pol.chunk,
            "prefetch_segments": pol.prefetch_segments,
        }
    return body


def get_topology(service: VolumeService, request: Request) -> Response:
    """``GET /topology`` — the dataset's cluster layout (paper §6).

    For an elastic `ClusterStore`: node count, per-resolution curve
    segments, per-node key occupancy (the rebalance signal), and whether a
    migration is in flight.  Single-node stores report a degenerate
    one-node topology with ``elastic: false``.
    """
    dataset = service.datasets.get(request.get("dataset"))
    if dataset is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    store, cluster = _host(dataset)
    if cluster is not None:
        return {"status": 200, **cluster.topology()}
    # key_count (not stored_keys) so a monitoring poll never drains the
    # write-behind queue it is observing
    occupancy = store.key_count()
    return {
        "status": 200,
        "n_nodes": 1,
        "elastic": False,
        "rebalancing": False,
        "keys_per_node": [occupancy],
    }


def post_rebalance(service: VolumeService, request: Request) -> Response:
    """``POST /rebalance`` — re-partition by occupancy, migrating live.

    ``{"target": n}`` grows/shrinks the cluster to ``n`` nodes; without a
    target, boundaries move but the node count stays.  Reads and writes
    issued concurrently through the service stay bit-identical during the
    move.  Responds with the migration stats and the resulting topology.
    """
    dataset = service.datasets.get(request.get("dataset"))
    if dataset is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    store = _host(dataset)[1]
    if store is None:
        return _error(400, "dataset is not elastic (single-node store)")
    try:
        target = request.get("target")
        stats = store.rebalance(target=None if target is None else int(target), wait=False)
    except RebalanceInFlight as e:
        return _error(409, str(e))
    except _BAD_REQUEST as e:
        return _error(400, f"bad rebalance request: {e}")
    return {"status": 200, **stats, "topology": store.topology()}


def post_batch_cutout(service: VolumeService, request: Request) -> Response:
    """``POST /batch/cutout`` — many boxes in one request (paper §4.2's
    batch interface on the wire).

    ``{"boxes": [[lo, hi], ...]}`` at one resolution/channel; over a
    cluster the boxes overlap on its request-level pool.  The response carries one
    result envelope per box, in request order, each shaped exactly like a
    ``GET /cutout`` body (``encode``/``level`` negotiate zlib per the
    whole batch)."""
    store = service.datasets.get(request.get("dataset"))
    if store is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    with _request_hist("batch", request.get("dataset")).time():
        try:
            r = int(request.get("resolution", 0))
            channel = int(request.get("channel", 0))
            boxes = []
            for box in request["boxes"]:
                lo, hi = box
                boxes.append(([int(x) for x in lo], [int(x) for x in hi]))
            if not boxes:
                raise ValueError("empty boxes list")
            vols = batch_cutout(store, r, boxes, channel)
            results = [_encode_volume(_to_host(vol, store.spec.dtype), request, store)
                       for vol in vols]
        except _BAD_REQUEST as e:
            return _error(400, f"bad batch cutout request: {e}")
        return {"status": 200, "n": len(results), "results": results}


def post_add_node(service: VolumeService, request: Request) -> Response:
    """``POST /nodes`` — grow the cluster by one shard (keys migrate onto
    it immediately unless ``{"rebalance": false}``)."""
    dataset = service.datasets.get(request.get("dataset"))
    if dataset is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    store = _host(dataset)[1]
    if store is None:
        return _error(400, "dataset is not elastic (single-node store)")
    try:
        index = store.add_node(rebalance=bool(request.get("rebalance", True)), wait=False)
    except RebalanceInFlight as e:
        return _error(409, str(e))
    except _BAD_REQUEST as e:
        return _error(400, f"bad add-node request: {e}")
    return {"status": 200, "node": index, "topology": store.topology()}


def post_remove_node(service: VolumeService, request: Request) -> Response:
    """``DELETE /<dataset>/nodes/<i>`` — decommission a live shard.

    Its ranges are promoted onto surviving replicas (replicated cluster)
    or streamed off first (replication 1); zero keys are lost either
    way."""
    dataset = service.datasets.get(request.get("dataset"))
    if dataset is None:
        return _error(404, f"unknown dataset {request.get('dataset')!r}")
    store = _host(dataset)[1]
    if store is None:
        return _error(400, "dataset is not elastic (single-node store)")
    try:
        stats = store.remove_node(int(request["node"]), wait=False)
    except RebalanceInFlight as e:
        return _error(409, str(e))
    except _BAD_REQUEST as e:
        return _error(400, f"bad remove-node request: {e}")
    return {"status": 200, **stats, "topology": store.topology()}


HANDLERS: Dict[str, Callable[[VolumeService, Request], Response]] = {
    "GET /cutout": get_cutout,
    "PUT /cutout": put_cutout,
    "GET /projection": get_projection,
    "GET /objects/boundingbox": get_annotation_bbox,
    "GET /objects/cutout": get_object_cutout,
    "POST /batch/cutout": post_batch_cutout,
    "POST /flush": post_flush,
    "POST /compact": post_compact,
    "GET /stats": get_stats,
    "GET /metrics": get_metrics,
    "GET /trace": get_trace,
    "GET /topology": get_topology,
    "POST /rebalance": post_rebalance,
    "POST /nodes/add": post_add_node,
    "POST /nodes/remove": post_remove_node,
}


def dispatch(service: VolumeService, request: Request, verb: Optional[str] = None) -> Response:
    """Route one request dict by its ``verb`` key.

    .. deprecated::
        This flat verb-string table predates the URL router; new callers
        should parse paper-style paths with :func:`repro_torch.cluster.api.url_dispatch`
        (which resolves to these same handlers).  Kept as a thin shim so
        existing request-dict callers keep working unchanged.
    """
    warnings.warn(
        "dispatch() is deprecated; route paper-style URL paths with "
        "repro_torch.cluster.api.url_dispatch (same handlers, same envelopes)",
        DeprecationWarning,
        stacklevel=2,
    )
    verb = verb or request.get("verb")
    handler = HANDLERS.get(verb)
    if handler is None:
        return _error(405, f"unknown verb {verb!r}")
    return handler(service, request)
