"""HTTP front door: the paper's stateless Web-service tier on a socket,
serving cutouts assembled on the card.

A stdlib :class:`~http.server.ThreadingHTTPServer` adapter over the
URL-routed v1 API (`repro_torch.cluster.api`): every request thread parses the
paper-style path, merges the query string and body into a request dict,
and dispatches into the same transport-free handlers the verb table
serves — the front door adds only *wire* concerns:

* **Admission control** — data-plane requests (cutouts, projections,
  writes, batches) pass a semaphore sized from the cluster's
  ``request_slots`` (the `run_batch` pool that actually executes them)
  plus a small waiting room; beyond that the request is shed immediately
  with a ``503`` envelope instead of queueing without bound (the paper's
  "millions of users" story needs a front door that degrades by refusing,
  not by collapsing).
* **Micro-batch coalescing** — concurrent small ``GET /cutout`` requests
  against the same dataset coalesce `ContinuousBatcher`-style: the first
  arrival becomes the *leader* and drains whatever queued while the
  previous batch executed through the backing cluster's ``run_batch``
  (so the boxes overlap on the cluster's request pool); identical requests are served
  once and fan the response out.  Serial traffic passes straight through
  with no added latency — a batch of one runs inline.

Wire contract: volume GETs return ``application/octet-stream`` bodies
with ``X-Shape`` / ``X-Dtype`` / ``X-Encode`` (``raw`` or ``zlib``)
headers; everything else is a JSON envelope (``bytes`` and arrays
base64-encoded).  ``PUT .../cutout/...`` takes the voxel payload as the
request body (raw little-endian or ``?encode=zlib``).  See the README
API reference for every route.

Each handler thread (and each thread of the cluster's batch pool) launches
its cutouts on the card's default stream; a response's volume is copied
to the host, which waits for its kernel, before its bytes leave.
"""

from __future__ import annotations

import base64
import collections
import functools
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..analysis.witness import ordered_lock
from ..device import DeviceLike
from ..cluster import deadline
from ..cluster.api import ApiError, parse_url
from ..cluster.handlers import (HANDLERS, Request, Response, VolumeService, _error, _host,
                                get_cutout)
from ..obs import log as obs_log
from ..obs import trace

# Verbs that do voxel I/O — these pass the admission limiter; control
# verbs (topology, stats, flush, rebalance, node add/remove) always get
# through so the cluster stays operable under load.
_DATA_PLANE = {
    "GET /cutout",
    "PUT /cutout",
    "GET /projection",
    "GET /objects/cutout",
    "POST /batch/cutout",
}
# Data-plane GETs whose 200 body is the volume itself (octet-stream).
_VOLUME_VERBS = {"GET /cutout", "GET /projection", "GET /objects/cutout"}
# Response fields surfaced as X- headers alongside an octet-stream body.
_HEADER_FIELDS = {
    "encode": "X-Encode",
    "level": "X-Level",
    "cuboids_read": "X-Cuboids-Read",
    "runs": "X-Runs",
    "zero_copy": "X-Zero-Copy",
    "id": "X-Id",
    "lo": "X-Lo",
}


def _json_default(obj):
    """JSON fallback for envelope payloads: numpy scalars widen, bytes and
    arrays travel base64 (arrays as raw little-endian bytes — the
    surrounding envelope carries their shape/dtype)."""
    if isinstance(obj, (bytes, bytearray)):
        return base64.b64encode(bytes(obj)).decode("ascii")
    if isinstance(obj, np.ndarray):
        return base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode("ascii")
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    raise TypeError(f"not JSON serializable: {type(obj)!r}")


class _Pending:
    """One queued cutout awaiting its (possibly shared) response."""

    __slots__ = ("request", "expires", "response", "done")

    def __init__(self, request: Request):
        self.request = request
        self.expires = deadline.expiry()  # the budget its admission opened
        self.response: Optional[Response] = None
        self.done = threading.Event()


class _CutoutCoalescer:
    """Leader/follower micro-batching for concurrent ``GET /cutout``.

    The continuous-batching idiom from `repro_torch.serve.batcher` applied
    to reads: requests arriving while a batch executes queue up, and the
    leader drains them as the *next* batch through the backing cluster's
    ``run_batch`` —
    batch size adapts to instantaneous load with zero idle-path latency.
    Identical concurrent requests (same box/resolution/encoding) execute
    once and share the response.
    """

    def __init__(self, service: VolumeService, max_batch: int = 16):
        self._service = service
        self.max_batch = max_batch
        self._lock = ordered_lock("frontdoor.coalesce", 65)
        self._queues: Dict[str, collections.deque] = {}
        self._busy: set = set()
        self.batches = 0  # drain rounds executed
        self.coalesced = 0  # requests that rode a batch of >= 2
        self.deduped = 0  # requests served from an identical twin's result

    @staticmethod
    def _key(req: Request) -> Tuple:
        return (
            req.get("resolution"),
            tuple(req.get("lo", ())),
            tuple(req.get("hi", ())),
            req.get("channel"),
            req.get("encode"),
            req.get("level"),
        )

    def submit(self, request: Request) -> Response:
        dataset = request.get("dataset")
        store = self._service.datasets.get(dataset)
        cluster = None if store is None else _host(store)[1]
        if cluster is None:
            return get_cutout(self._service, request)  # nothing to coalesce onto
        item = _Pending(request)
        with self._lock:
            queue = self._queues.setdefault(dataset, collections.deque())
            queue.append(item)
            leader = dataset not in self._busy
            if leader:
                self._busy.add(dataset)
        if leader:
            self._drain(dataset, cluster)
        item.done.wait()
        return item.response

    def _serve(self, item: _Pending) -> Response:
        # Each request runs under the deadline its own admission opened,
        # on whichever thread runs it: the leader's budget is its own
        # request's, and runs out while it drains the others'; a batch
        # pool thread has none.  A failure answers its own request only.
        with deadline.adopt(item.expires):
            try:
                return get_cutout(self._service, item.request)
            except Exception as e:
                return _error(500, f"batch execution failed: {e}")

    def _drain(self, dataset: str, cluster) -> None:
        while True:
            with self._lock:
                queue = self._queues[dataset]
                if not queue:
                    # busy is cleared under the same lock as the emptiness
                    # check, so a request appended now sees no leader and
                    # elects itself.
                    self._busy.discard(dataset)
                    return
                batch = [queue.popleft() for _ in range(min(len(queue), self.max_batch))]
            self.batches += 1
            if len(batch) > 1:
                self.coalesced += len(batch)
            groups: Dict[Tuple, List[_Pending]] = {}
            for item in batch:
                groups.setdefault(self._key(item.request), []).append(item)
            self.deduped += len(batch) - len(groups)
            reps = [items[0] for items in groups.values()]
            try:
                jobs = [functools.partial(self._serve, rep) for rep in reps]
                results = cluster.run_batch(jobs) if len(jobs) > 1 else [jobs[0]()]
            except Exception as e:  # a handler bug must not strand waiters
                results = [_error(500, f"batch execution failed: {e}")] * len(reps)
            for items, resp in zip(groups.values(), results):
                for item in items:
                    item.response = resp
                    item.done.set()


class FrontDoor:
    """The HTTP server: ``with FrontDoor(service) as front: ...``.

    ``admit_limit`` bounds concurrent data-plane requests (default:
    2x the largest registered cluster's ``request_slots`` + 2 — the
    executing set plus a short waiting room); a request that cannot get a
    slot within ``admit_timeout`` seconds is shed with 503.  ``port=0``
    binds an ephemeral port (see ``.address`` after ``start()``).
    ``deadline_ms`` is each data-plane request's deadline budget
    (`repro_torch.cluster.deadline`; zero or ``None`` disables it).
    """

    def __init__(
        self,
        service: VolumeService,
        host: str = "127.0.0.1",
        port: int = 0,
        admit_limit: Optional[int] = None,
        admit_timeout: float = 0.5,
        coalesce: bool = True,
        coalesce_max: int = 16,
        retry_after: int = 1,
        deadline_ms: Optional[float] = deadline.DEFAULT_DEADLINE_MS,
    ):
        self.service = service
        self.deadline_s = deadline.default_budget_s(deadline_ms)
        self._host = host
        self._port = port
        if admit_limit is None:
            clusters = [_host(store)[1] for store in service.datasets.values()]
            slots = [c.request_slots for c in clusters if c is not None]
            admit_limit = 2 * max([s for s in slots if s] or [2]) + 2
        self.admit_limit = int(admit_limit)
        self.admit_timeout = admit_timeout
        # Advertised back-off for shed (503) responses, in whole seconds
        # (the retrying client honours it over its own backoff schedule).
        self.retry_after = max(1, int(retry_after))
        self._sem = threading.BoundedSemaphore(self.admit_limit)
        self.coalescer = _CutoutCoalescer(service, coalesce_max) if coalesce else None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.address: Optional[Tuple[str, int]] = None
        self.requests = 0
        self.shed = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        front = self

        class Handler(_RequestHandler):
            pass

        Handler.front = front
        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="ocp-frontdoor", daemon=True
        )
        self._thread.start()
        self.address = self._server.server_address[:2]
        return self.address

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "FrontDoor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def counters(self) -> Dict[str, int]:
        out = {"requests": self.requests, "shed": self.shed}
        if self.coalescer is not None:
            out.update(
                batches=self.coalescer.batches,
                coalesced=self.coalescer.coalesced,
                deduped=self.coalescer.deduped,
            )
        return out

    # -- request handling ---------------------------------------------------
    def handle(
        self, method: str, path: str, query: Dict[str, str], body: bytes
    ) -> Tuple[str, Response]:
        """(method, path, query, body) -> (verb, response envelope)."""
        self.requests += 1
        try:
            verb, params = parse_url(method, path)
        except ApiError as e:
            return "", _error(e.status, e.message)
        request: Dict[str, Any] = dict(query)
        if verb == "PUT /cutout":
            try:
                self._attach_put_payload(request, params, body)
            except (ValueError, TypeError) as e:
                return verb, _error(400, f"bad write payload: {e}")
        elif body and method in ("POST", "DELETE"):
            try:
                parsed = json.loads(body.decode("utf-8"))
                if not isinstance(parsed, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                return verb, _error(400, f"bad JSON body: {e}")
            request.update(parsed)
        request.update(params)  # the path IS the address: it wins

        if verb not in _DATA_PLANE:
            return verb, HANDLERS[verb](self.service, request)
        # The wait for an admission slot is the first stage of a sampled
        # request's span tree (queue wait → plan → fetch → decode →
        # assemble); shedding shows up as an errored queue.wait span.
        with trace.span("queue.wait", limit=self.admit_limit) as tmeta:
            admitted = self._sem.acquire(timeout=self.admit_timeout)
            if tmeta is not None:
                tmeta["admitted"] = admitted
        if not admitted:
            self.shed += 1
            return verb, _error(
                503, f"admission limit ({self.admit_limit} in flight) reached; retry"
            )
        try:
            # The deadline budget opened here propagates (thread-locally)
            # into the cluster's replicated read paths: no single hung
            # node may stall this request past ``deadline_ms``.
            with deadline.budget(self.deadline_s):
                if verb == "GET /cutout" and self.coalescer is not None:
                    return verb, self.coalescer.submit(request)
                return verb, HANDLERS[verb](self.service, request)
        finally:
            self._sem.release()

    def _attach_put_payload(
        self, request: Dict[str, Any], params: Request, body: bytes
    ) -> None:
        """Turn a PUT body into the handler's ``data`` field.

        ``?encode=zlib`` hands the compressed blob straight to the handler
        (its shape is the URL box); otherwise the body is raw
        little-endian voxels of the dataset's dtype (or ``?dtype=``)."""
        store = self.service.datasets.get(params.get("dataset"))
        if store is None:
            return  # the handler 404s before touching data
        shape = [b - a for a, b in zip(params["lo"], params["hi"])]
        dtype = request.get("dtype") or str(store.spec.dtype)
        if request.get("encode") == "zlib":
            request["data"] = body
            request["shape"] = shape
            request["dtype"] = dtype
        else:
            arr = np.frombuffer(body, dtype=np.dtype(dtype))
            expected = int(np.prod(shape)) if shape else 0
            if arr.size != expected:
                raise ValueError(
                    f"payload holds {arr.size} voxels, box {shape} needs {expected}"
                )
            request.pop("encode", None)
            request["data"] = arr.reshape(shape)

    def wire(
        self,
        method: str,
        path: str,
        query: Dict[str, str],
        body: bytes,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """Full wire turn: returns (http status, headers, payload).

        ``headers`` are the request headers; an ``X-Trace-Id`` there
        always traces the request (whatever the sampling rate says),
        and a traced response carries the id back in ``X-Trace-Id`` so
        the caller can fetch the span tree via ``GET /trace/<id>``.
        """
        t0 = time.perf_counter()
        ctx = trace.maybe_start((headers or {}).get("X-Trace-Id"))
        if ctx is None:
            verb, resp = self.handle(method, path, query, body)
        else:
            with trace.activate(ctx):
                with trace.span("request", method=method, path=path):
                    verb, resp = self.handle(method, path, query, body)
        status, out_headers, payload = self._encode_response(verb, resp)
        trace_id = ctx.trace_id if ctx is not None else None
        if trace_id is not None:
            out_headers["X-Trace-Id"] = trace_id
        dur = time.perf_counter() - t0
        threshold = obs_log.slow_threshold_s()
        if threshold is not None and dur >= threshold:
            tree = trace.trace_tree(trace_id) if trace_id is not None else []
            obs_log.slow_request(method, path, dur, trace_id, tree)
        obs_log.access_log(method, path, status, dur, trace_id)
        return status, out_headers, payload

    def _encode_response(
        self, verb: str, resp: Response
    ) -> Tuple[int, Dict[str, str], bytes]:
        status = int(resp.get("status", 500))
        if status == 200 and verb in _VOLUME_VERBS and "data" in resp:
            resp = dict(resp)  # coalesced twins share the dict — don't mutate
            data = resp.pop("data")
            if isinstance(data, np.ndarray):
                payload = np.ascontiguousarray(data).tobytes()
                resp.setdefault("encode", "raw")
            else:
                payload = bytes(data)
            headers = {
                "Content-Type": "application/octet-stream",
                "X-Shape": ",".join(str(s) for s in resp["shape"]),
                "X-Dtype": str(resp["dtype"]),
            }
            for field, header in _HEADER_FIELDS.items():
                if field in resp:
                    value = resp[field]
                    if isinstance(value, (list, tuple)):
                        value = ",".join(str(v) for v in value)
                    headers[header] = str(value)
            return status, headers, payload
        if status == 200 and "text" in resp:
            # Plain-text envelope (the Prometheus /metrics exposition).
            payload = str(resp["text"]).encode("utf-8")
            content_type = str(resp.get("content_type", "text/plain; charset=utf-8"))
            return status, {"Content-Type": content_type}, payload
        payload = json.dumps(resp, default=_json_default).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if status == 503:
            # Shed responses tell the client when to come back; the
            # retrying client (serve.client) honours this over its own
            # backoff schedule.
            headers["Retry-After"] = str(self.retry_after)
        return status, headers, payload


class _RequestHandler(BaseHTTPRequestHandler):
    front: FrontDoor  # injected per-server by FrontDoor.start()
    protocol_version = "HTTP/1.1"

    def log_request(self, code="-", size="-"):  # noqa: D102
        # The per-request stderr line BaseHTTPRequestHandler would print
        # here is replaced by the structured access log `wire()` emits
        # (method, path, status, duration, trace id) — same gate, one
        # JSON line per request instead of interleaved raw stderr.
        pass

    def log_message(self, fmt, *args):  # noqa: D102
        # Everything else the stdlib handler logs (log_error: malformed
        # requests, broken pipes) routes through the structured logger —
        # silent by default, ``obs.log.configure(access_log=True)`` turns
        # it on.
        if obs_log.access_enabled():
            obs_log.emit("httpd", message=fmt % args)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length > 0 else b""

    def _turn(self, method: str) -> None:
        try:
            split = urllib.parse.urlsplit(self.path)
            query = dict(urllib.parse.parse_qsl(split.query))
            body = self._read_body()
            status, headers, payload = self.front.wire(
                method, urllib.parse.unquote(split.path), query, body,
                headers=dict(self.headers.items()),
            )
        except Exception as e:  # a handler bug must answer, not hang the socket
            payload = json.dumps({"status": 500, "error": f"internal error: {e}"}).encode()
            status, headers = 500, {"Content-Type": "application/json"}
        self.send_response(status)
        for key, value in headers.items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._turn("GET")

    def do_PUT(self):
        self._turn("PUT")

    def do_POST(self):
        self._turn("POST")

    def do_DELETE(self):
        self._turn("DELETE")


def demo_service(n_nodes: int = 3, replication: int = 2, size: int = 64,
                 device: DeviceLike = "cuda") -> VolumeService:
    """A small self-contained service for smoke tests and manual poking:
    one dataset ("demo") of seeded noise on ``device``, over a replicated
    cluster."""
    from ..cluster import ClusterStore, VolumeService
    from ..core.cuboid import DatasetSpec
    from ..core.cutout import ingest
    from ..core.store import DeviceCuboidStore

    spec = DatasetSpec(
        name="demo",
        volume_shape=(size, size, size // 2),
        dtype="uint8",
        base_cuboid=(16, 16, 8),
        n_resolutions=2,
    )
    store = DeviceCuboidStore(spec, device=device, backing=ClusterStore(
        spec, n_nodes=n_nodes, replication=replication))
    rng = np.random.default_rng(7)
    ingest(store, 0, rng.integers(1, 255, size=spec.volume_shape, dtype=np.uint8))
    service = VolumeService()
    service.add_dataset("demo", store)
    return service


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="OCP data-cluster HTTP front door (demo)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the volume lives and cutouts run (default: the card)")
    ap.add_argument("--deadline-ms", type=float, default=deadline.DEFAULT_DEADLINE_MS,
                    help="per-request deadline budget; 0 disables it")
    args = ap.parse_args(argv)
    service = demo_service(args.nodes, args.replication, device=args.device)
    front = FrontDoor(service, args.host, args.port, deadline_ms=args.deadline_ms)
    host, port = front.start()
    print(f"front door on http://{host}:{port}  (dataset 'demo' on {args.device}; "
          f"Ctrl-C stops)")
    try:
        _block_until_interrupted()
    except KeyboardInterrupt:
        front.close()


def _block_until_interrupted() -> None:
    threading.Event().wait()  # Ctrl-C raises KeyboardInterrupt here


if __name__ == "__main__":
    main()
