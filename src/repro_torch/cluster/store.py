"""Spatially-partitioned *elastic* cluster store (paper §4.1 + §6).

A :class:`ClusterStore` owns N node shards — each a full `CuboidStore` with
its own read/write backends and `PathStats` (the paper's database node with
a disk-array read path and an SSD write path) — and routes every cuboid and
run to its owning node with a stateless :class:`Router`.  It implements the
same storage interface the cutout engine drives (`fetch_runs`,
`store_cuboids`, `read_cuboid`, ...), so `cutout()` / `write_cutout()` work
unchanged over a cluster, and batch I/O fans out across nodes in parallel
(one thread per touched node: the paper's parallel-requests doctrine C8
applied *inside* one request).

Replication (paper §4.2 "no single point of failure" applied to the data
tier): ``replication=N`` keeps every curve segment on a *replica set* — a
successor ring of N nodes starting at the segment's partition owner.
Writes fan out to every member (each through its own write-behind queue),
reads go to the least-loaded member (the per-node ``PathStats.inflight``
gauge is the load signal), and removing a live member promotes the
surviving replicas with zero data loss because every key already lives on
all of them.

Elasticity (paper §6 "dynamically redistribute data"): the cluster is not
pinned to its initial shard count.  ``rebalance(target=...)`` re-cuts the
per-resolution curve partitions by occupancy and migrates the keys whose
*replica set* changes *live* — concurrent reads and writes stay
bit-identical throughout.  ``add_node()`` / ``remove_node()`` grow and
shrink the node set through the same protocol.  The migration protocol,
per moved curve range:

1. **register** — the move set (ranges whose membership changes) is
   published and a grace period waits for in-flight ops, so every
   subsequent write to a moving key *double-writes* to the old members
   and every member being added (through each node's write-behind queue
   when attached — the queue is the natural double-write buffer).
2. **copy** — existing keys in the moving range are streamed from a
   surviving old member to each added member as compressed blobs, in
   small batches under the move lock, so a racing double-write can never
   be clobbered by a stale copy.  Reads keep routing to the old members,
   which stay complete.
3. **swap** — the *final* topology (node tuple + Router) is published in
   one atomic swap, so replica sets are never evaluated against a
   half-migrated intermediate; a grace period drains readers still on the
   old boundaries.
4. **cleanup** — after a final writer grace period, keys leave the
   members dropped from each range's set (backends and `CuboidCache`;
   the added members' caches absorbed them during the copy).

Topology (the node tuple + the Router) is an immutable snapshot swapped
atomically, so every op sees one consistent (nodes, boundaries) pair even
while a rebalance is in flight; `GET /topology` exposes it.  During a
grow, freshly appended shards ride in the node tuple *without* entering
the Router until the final swap — they own nothing and serve nothing
while the copy phase fills them.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.witness import before_submit, ordered_lock, ordered_rlock
from ..core import morton
from ..core.cuboid import DatasetSpec
from ..core.store import BlockSink, CuboidStore, DecodePolicy, Key, MemoryBackend, PathStats
from ..core.wal import TierPolicy, tiered_store
from ..obs import trace
from ..obs.registry import REGISTRY
from . import deadline
from .cache import attach_cache, enable_write_behind
from .router import Partition, Router

NodeFactory = Callable[[int, DatasetSpec], CuboidStore]

# (start, stop, old_members, new_members) — one curve range whose replica
# set changes.  Node indices are *pre-migration* (physical) positions in
# the topology the move set was computed against.
Move = Tuple[int, int, Tuple[int, ...], Tuple[int, ...]]


# Granularity of the per-segment access-heat map: morton indices are
# bucketed by ``m >> heat_bits`` (default 6 → 64-cuboid buckets), keeping
# the map small on petascale curves while still localizing hot regions to a
# partition-sized neighborhood.
HEAT_BITS = 6


class RebalanceInFlight(RuntimeError):
    """A topology change (rebalance / add_node / remove_node) is already
    in progress.  Raised by ``rebalance(wait=False)`` and friends instead
    of queueing behind the admin lock; the HTTP layer maps it to 409."""


class NoLiveReplica(RuntimeError):
    """Every member of a replica set is excluded (failed this request or
    declared dead) — the read cannot be served from any surviving copy."""


class WriteQuorumError(RuntimeError):
    """A replicated write reached fewer live members than its quorum.

    The write is NOT acknowledged: retry it.  Any copies that did land
    are queued for anti-entropy repair on the members that missed them,
    so reads keep routing to members holding the freshest value."""


# Health states a node moves through (consecutive data-path errors and the
# probe tick drive the transitions; see `ClusterStore._record_error`):
#
#     alive --errors--> suspect --more errors--> dead --probe ok-->
#     recovering --resync_node()--> alive   (suspect heals straight back
#     to alive on any success)
#
# dead/recovering members serve no reads; suspect members are deprioritized
# in the least-loaded choice but still serve.
HEALTH_STATES = ("alive", "suspect", "dead", "recovering")
_NOT_SERVING = ("dead", "recovering")
_HEALTH_RANK = {"alive": 0, "suspect": 1, "recovering": 2, "dead": 3}


class _NodeHealth:
    """Mutable per-node health record (guarded by the cluster.health lock;
    `state` is additionally read unlocked as a monotonic-enough snapshot
    on the hot read path)."""

    __slots__ = ("state", "errors", "last_error", "since", "transitions")

    def __init__(self):
        self.state = "alive"
        self.errors = 0
        self.last_error: Optional[str] = None
        self.since = time.monotonic()
        self.transitions = 0

    def set(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.since = time.monotonic()
            self.transitions += 1


def _default_node_factory(node: int, spec: DatasetSpec,
                          write_tier: Optional[str] = None) -> CuboidStore:
    """In-memory node with a separated write path (SSD-node analogue).

    With ``write_tier="log"`` or ``"dir"`` the node gets the on-disk
    `TierPolicy` pair instead (append-log or directory write tier over a
    compacted read tier, in a scratch root the store owns).
    """
    if write_tier in ("log", "dir"):
        return tiered_store(spec, policy=TierPolicy(write_tier=write_tier))
    if write_tier is not None:
        raise ValueError(f"write_tier must be None, 'log' or 'dir', got {write_tier!r}")
    return CuboidStore(spec, backend=MemoryBackend(), write_path_backend=MemoryBackend())


# Gauges describe *current* per-node occupancy, not accumulated work:
# summing them over-reports (a 2-node cluster would claim twice the real
# queue peak), so the cluster aggregate takes the max instead.
_GAUGE_FIELDS = frozenset({"queue_depth", "queue_peak", "inflight"})


def _sum_stats(parts: Sequence[PathStats]) -> PathStats:
    out = PathStats()
    for p in parts:
        for f in dataclasses.fields(PathStats):
            if f.name in _GAUGE_FIELDS:
                setattr(out, f.name, max(getattr(out, f.name), getattr(p, f.name)))
            else:
                setattr(out, f.name, getattr(out, f.name) + getattr(p, f.name))
    return out


@dataclasses.dataclass(frozen=True)
class _Topology:
    """One atomic (nodes, router) snapshot — ops resolve both together."""

    nodes: Tuple[CuboidStore, ...]
    router: Router


class _OpGate:
    """RCU-style grace periods for topology changes.

    Data ops enter/exit; `synchronize()` opens a new epoch and blocks until
    every op that started under an older epoch has drained.  Rebalance uses
    it so a published move set / router swap is *seen* by all traffic
    before the next phase relies on it.  Ops never block each other.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._epoch = 0
        self._active: Dict[int, int] = {}

    @contextlib.contextmanager
    def op(self):
        with self._cond:
            epoch = self._epoch
            self._active[epoch] = self._active.get(epoch, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._active[epoch] -= 1
                if self._active[epoch] == 0:
                    del self._active[epoch]
                    self._cond.notify_all()

    def synchronize(self, timeout: float = 60.0) -> None:
        with self._cond:
            self._epoch += 1
            fence = self._epoch
            deadline = time.monotonic() + timeout
            while any(e < fence and n > 0 for e, n in self._active.items()):
                self._cond.wait(0.05)
                # measured against the clock, not wakeup counts: notify_all
                # fires on every op completion and would exhaust a counter
                # in seconds under sustained traffic
                if time.monotonic() >= deadline:
                    raise TimeoutError("op gate synchronize timed out")


def _move_extras(entries: Tuple[Move, ...], m: int, members: Tuple[int, ...]) -> Tuple[int, ...]:
    """Extra write targets while ``m``'s range is migrating: the members
    being *added* that the writer's (pre-swap) replica set doesn't list.
    Empty once the final topology is in the writer's snapshot — its
    replica set already names every authoritative member."""
    for start, stop, _old, new in entries:
        if start <= m < stop:
            return tuple(d for d in new if d not in members)
    return ()


class ClusterStore:
    """N `CuboidStore` shards behind one storage interface.

    ``node_factory(i, spec)`` builds shard ``i`` — supply it to give nodes
    directory backends, distinct write paths, etc.  ``max_workers`` bounds
    per-request node parallelism (default: one worker per node; ``0``/``1``
    forces serial fan-out, useful for deterministic profiling).

    Without a ``node_factory`` each node is in memory, or on disk with
    ``write_tier="log"`` / ``"dir"`` (`core.wal.tiered_store`).

    ``cache_bytes`` attaches a hot-cuboid cache to every node (the budget
    is split evenly across the initial shards; nodes added later get the
    same per-node budget); ``write_behind`` attaches a per-node
    write-behind ingest queue (``flush()`` is the durability barrier, see
    ``repro_torch.cluster.cache``).  Both are off by default, and neither
    overrides a tier the node factory already attached.

    ``replication`` keeps every curve segment on that many nodes (a
    successor ring from the segment's owner, capped at the node count;
    default 1).  Writes fan out to every member; reads pick the member
    with the fewest in-flight jobs; losing any single member loses no data
    while ``replication >= 2``.

    ``heat_bits`` sets the access-heat buckets (`access_heat`); a node
    turns suspect after ``suspect_after`` consecutive data-path errors and
    dead after ``dead_after``.

    Elasticity: ``rebalance(target=n)`` / ``add_node()`` /
    ``remove_node()`` re-partition by occupancy (``keys_per_node()`` is
    the signal) and migrate keys live; see the module docstring for the
    coherence protocol.  ``topology()`` is the introspection snapshot the
    ``GET /topology`` verb serves.  Pass ``wait=False`` to fail fast with
    :class:`RebalanceInFlight` instead of queueing behind a concurrent
    topology change.
    """

    def __init__(
        self,
        spec: DatasetSpec,
        n_nodes: int = 2,
        node_factory: Optional[NodeFactory] = None,
        max_workers: Optional[int] = None,
        cache_bytes: Optional[int] = None,
        write_behind: bool = False,
        write_behind_items: int = 512,
        decode_policy: Optional[DecodePolicy] = None,
        replication: int = 1,
        heat_bits: int = HEAT_BITS,
        write_tier: Optional[str] = None,
        suspect_after: int = 3,
        dead_after: int = 6,
    ):
        self.spec = spec
        self._node_factory = node_factory or functools.partial(
            _default_node_factory, write_tier=write_tier)
        self.replication = max(1, int(replication))
        self._node_cache_bytes = max(1, int(cache_bytes) // n_nodes) if cache_bytes else 0
        self._write_behind = bool(write_behind)
        self._write_behind_items = write_behind_items
        # One DecodePolicy for every shard: the per-node fan-out workers
        # decode into a pool shared across the whole process, so the
        # cluster's cold-read parallelism is nodes x decode chunks without
        # per-node thread oversubscription.  None leaves factory-built
        # nodes on their own (env-derived) policy.
        self.decode_policy = decode_policy
        nodes = tuple(self._build_node(i) for i in range(n_nodes))
        self._topo = _Topology(nodes, Router(spec, n_nodes, replication=self.replication))
        self._gate = _OpGate()
        # Serializes whole rebalances; RLock so add/remove can nest into
        # rebalance().
        self._admin_lock = ordered_rlock("cluster.admin", 10)
        # Serializes the copy phase with double-writes to *moving* keys so
        # a stale copy can never clobber a fresher concurrent write.
        self._move_lock = ordered_lock("cluster.move", 20)
        # Held locks the node fan-out may submit under: the move lock (node
        # jobs never take it) and the write guards `allow_submit_under`
        # registers.
        self._submit_allow: Tuple = (self._move_lock,)
        # {resolution: ((start, stop, old_members, new_members), ...)} —
        # published atomically; empty outside an active migration.  Member
        # indices are positions in `_moves_topo` (the pre-migration
        # snapshot): a writer consults the move set only while its own
        # topology snapshot IS that one, so the indices always line up.
        self._moves: Dict[int, Tuple[Move, ...]] = {}
        self._moves_topo: Optional[_Topology] = None
        self._cfg_max_workers = max_workers
        self._retired_pools: List[cf.ThreadPoolExecutor] = []
        workers = n_nodes if max_workers is None else max_workers
        if workers > 1:
            self._pool = cf.ThreadPoolExecutor(max_workers=workers, thread_name_prefix="ocp-node")
        else:
            self._pool = None
        # Per-segment access heat (ROADMAP item 5's signal): morton buckets
        # (m >> heat_bits) → touch counts, split by direction.  Updated
        # with one dict bump per routed run piece / written block — cheap
        # enough to stay always-on — and read by `access_heat()` (the
        # /metrics top-N exposition and the supervisor's ClusterWatch).
        self.heat_bits = int(heat_bits)
        self._heat_lock = ordered_lock("cluster.heat", 75)
        self._read_heat: Dict[Tuple[int, int], int] = {}
        self._write_heat: Dict[Tuple[int, int], int] = {}
        # Request-level pool for batch_cutout's multi-box overlap — lazily
        # created, and deliberately DISTINCT from the node fan-out pool: a
        # batch job itself fans out to nodes and blocks on their futures,
        # and nesting both levels in one bounded pool deadlocks the moment
        # every worker holds a waiting outer job.
        self._batch_pool: Optional[cf.ThreadPoolExecutor] = None
        self._batch_lock = ordered_lock("cluster.batch", 76)
        # repr of the newest secondary error swallowed while rolling back a
        # failed grow (`_unwiden`); the primary error re-raises past it.
        self.last_unwiden_error: Optional[str] = None
        # -- fault tolerance: health machine + anti-entropy repair queue --
        # Health records are keyed by node identity (id(node)) so they
        # survive index shifts across topology swaps; `_swap_topo` prunes
        # entries whose node left the cluster.  Rank 22 sits between the
        # move lock (20) and the repair lock (24): write paths record
        # health while holding the move lock, and repair bookkeeping may
        # follow a health check — never the other way around.
        self._suspect_after = max(1, int(suspect_after))
        self._dead_after = max(self._suspect_after, int(dead_after))
        self._health_lock = ordered_lock("cluster.health", 22)
        self._health: Dict[int, _NodeHealth] = {}
        # {id(node): {(r, channel, m), ...}} — keys a node missed (write
        # failures, writes skipped while it was dead).  Reads route around
        # a member that is dirty for the requested span; `resync_node`
        # replays the set from replica peers under the move lock.
        self._repair_lock = ordered_lock("cluster.repair", 24)
        self._dirty: Dict[int, set] = {}
        self.repair_enqueued = 0
        self.last_probe_error: Optional[str] = None
        self._prober: Optional[threading.Thread] = None
        self._prober_stop = threading.Event()

    def _build_node(self, i: int, factory: Optional[NodeFactory] = None) -> CuboidStore:
        node = (factory or self._node_factory)(i, self.spec)
        if self._node_cache_bytes and node.cache is None:
            attach_cache(node, self._node_cache_bytes)
        if self._write_behind and node.write_behind is None:
            enable_write_behind(node, max_items=self._write_behind_items)
        if self.decode_policy is not None:
            node.decode_policy = self.decode_policy
        return node

    def allow_submit_under(self, lock) -> None:
        """Tell the lock witness that ``lock`` may be held across this
        cluster's node fan-out.  A `DeviceCuboidStore` over the cluster
        registers its write guard: it writes through while holding it, and
        no node job ever takes it."""
        self._submit_allow = self._submit_allow + (lock,)

    # -- cluster admin -----------------------------------------------------
    @property
    def nodes(self) -> List[CuboidStore]:
        """The current node shards (a snapshot copy — topology may move)."""
        return list(self._topo.nodes)

    @property
    def router(self) -> Router:
        return self._topo.router

    @property
    def n_nodes(self) -> int:
        return len(self._topo.nodes)

    @property
    def has_cache(self) -> bool:
        return any(node.cache is not None for node in self._topo.nodes)

    def flush(self) -> int:
        """Durability barrier: drain every node's write-behind queue.

        Returns the total number of pending writes applied.  When it
        returns, everything previously written through the cluster is in
        the node backends (the contract ``POST /flush`` exposes)."""
        with self._gate.op():
            nodes = self._topo.nodes
            jobs = {i: nodes[i].flush for i in range(len(nodes))}
            return sum(self._fan_out(jobs).values())

    def compact(self, max_segments: Optional[int] = None) -> Dict[str, object]:
        """Fan ``CuboidStore.compact()`` out to every node: merge each
        shard's flushed log segments into its read tier (no-op per node
        without a log write tier).  The aggregate is what
        ``POST /compact`` returns."""
        with self._gate.op():
            nodes = self._topo.nodes
            jobs = {
                i: functools.partial(nodes[i].compact, max_segments)
                for i in range(len(nodes))
            }
            results = self._fan_out(jobs)
        agg = {"segments": 0, "keys": 0, "tombstones": 0, "bytes": 0, "seconds": 0.0}
        for stats in results.values():
            d = stats.asdict()
            for k in agg:
                agg[k] += d[k]
        agg["nodes"] = len(results)
        return agg

    def tier_counters(self) -> Dict[str, object]:
        """Cluster-wide tier gauges: per-node ``tier_stats`` summed (the
        ``tiers`` section of ``GET /stats`` and the supervisor's
        log-pressure signal)."""
        with self._gate.op():
            nodes = self._topo.nodes
        agg: Dict[str, object] = {
            "nodes": len(nodes),
            "log_nodes": 0,
            "sealed": 0,
            "log_bytes": 0,
            "live_keys": 0,
            "tombstones": 0,
            "torn_truncated": 0,
            "compactions": {
                "runs": 0,
                "segments": 0,
                "keys": 0,
                "tombstones": 0,
                "bytes": 0,
                "seconds": 0.0,
            },
        }
        for node in nodes:
            ts = node.tier_stats()
            for k, v in ts["compactions"].items():
                agg["compactions"][k] += v
            log = ts.get("log")
            if log:
                agg["log_nodes"] += 1
                for k in ("sealed", "log_bytes", "live_keys", "tombstones", "torn_truncated"):
                    agg[k] += log[k]
        return agg

    def synchronize(self, timeout: float = 60.0) -> None:
        """Grace-period barrier: block until every data op that was in
        flight when this was called has drained (new ops are unaffected).
        Raises ``TimeoutError`` when an op outlives ``timeout`` seconds —
        the signal a hung node is wedging topology changes."""
        self._gate.synchronize(timeout)

    def close(self) -> None:
        self.stop_prober()
        for node in self._topo.nodes:
            node.close()  # flushes + stops per-node write-behind flushers
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        with self._batch_lock:  # serialize with run_batch's lazy creation
            batch_pool, self._batch_pool = self._batch_pool, None
        if batch_pool is not None:
            batch_pool.shutdown(wait=True)
        for pool in self._retired_pools:
            pool.shutdown(wait=True)
        self._retired_pools = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _fan_out(self, jobs: Dict[int, Callable[[], object]]) -> Dict[int, object]:
        """Run one job per touched node, in parallel when a pool exists.

        Jobs cross the pool boundary through ``trace.bind`` so a sampled
        request's per-node spans nest under the stage that fanned out
        (bind is the identity function when nothing is traced)."""
        pool = self._pool
        if pool is None or len(jobs) <= 1:
            return {n: job() for n, job in jobs.items()}
        # The copy phase fans out *while holding* the move lock by design
        # (a stale copy must never clobber a racing double-write); node
        # jobs never take the move lock, so tell the witness it is safe.
        before_submit(allow=self._submit_allow)
        futures = {n: pool.submit(trace.bind(job)) for n, job in jobs.items()}
        return {n: f.result() for n, f in futures.items()}

    def _fan_out_checked(
        self, jobs: Dict[int, Callable[[], object]], budget: Optional[float] = None
    ) -> Dict[int, Tuple[bool, object]]:
        """Failure-isolating fan-out: ``{node: (ok, value_or_error)}``.

        Unlike `_fan_out`, one node's exception never aborts the batch —
        the degraded paths need to know exactly which members failed so
        their pieces can be re-routed.  With a ``budget`` (seconds), each
        future is waited at most the budget remaining when its turn
        comes; an expired node reports a ``TimeoutError`` and its job is
        abandoned to finish in the background — a hung node is never
        waited on past the caller's deadline."""
        pool = self._pool
        out: Dict[int, Tuple[bool, object]] = {}
        if pool is None:
            for n, job in jobs.items():
                try:
                    out[n] = (True, job())
                except Exception as e:
                    out[n] = (False, e)
            return out
        before_submit(allow=self._submit_allow)
        futures = {n: pool.submit(trace.bind(job)) for n, job in jobs.items()}
        t_end = None if budget is None else time.monotonic() + budget
        for n, f in futures.items():
            try:
                t = None if t_end is None else max(0.001, t_end - time.monotonic())
                out[n] = (True, f.result(timeout=t))
            except cf.TimeoutError:
                f.cancel()
                out[n] = (False, TimeoutError(
                    f"node {n} op exceeded the deadline budget"))
            except Exception as e:
                out[n] = (False, e)
        return out

    # -- node health (alive / suspect / dead / recovering) -------------------
    def _health_state(self, node: CuboidStore) -> str:
        # unlocked dict read: a benign snapshot — health transitions are
        # inherently racy against in-flight ops, and the paths consulting
        # this tolerate either side of the transition
        h = self._health.get(id(node))
        return h.state if h is not None else "alive"

    def _record_error(self, node: CuboidStore, exc: BaseException) -> None:
        """Data-path failure on a node: count it, degrade health on the
        consecutive-error thresholds (alive→suspect→dead)."""
        with self._health_lock:
            h = self._health.get(id(node))
            if h is None:
                h = self._health[id(node)] = _NodeHealth()
            h.errors += 1
            h.last_error = repr(exc)
            if h.state in ("alive", "recovering") and h.errors >= self._suspect_after:
                h.set("suspect")
            if h.state == "suspect" and h.errors >= self._dead_after:
                h.set("dead")

    def _record_ok(self, node: CuboidStore) -> None:
        """Data-path success: clear the consecutive-error count; a suspect
        member heals straight back to alive.  Dead/recovering members do
        NOT resurrect here — one lucky success must not short-circuit the
        probe + anti-entropy resync re-admission path."""
        h = self._health.get(id(node))  # unlocked fast path: nothing to clear
        if h is None or (h.errors == 0 and h.state != "suspect"):
            return
        with self._health_lock:
            h = self._health.get(id(node))
            if h is None:
                return
            h.errors = 0
            if h.state == "suspect":
                h.set("alive")

    def _probe_ok(self, node: CuboidStore) -> None:
        with self._health_lock:
            h = self._health.get(id(node))
            if h is None:
                return
            h.errors = 0
            if h.state == "suspect":
                h.set("alive")
            elif h.state == "dead":
                # back from the dead: it must resync (anti-entropy) before
                # serving reads again — `resync_node` flips it to alive
                h.set("recovering")

    def probe_health(self) -> Dict[str, object]:
        """One cheap health-probe tick over every node (a single-key
        existence check per node — no data transfer).

        Failed probes count toward the consecutive-error thresholds, so a
        dead node is detected even on an idle cluster; a successful probe
        heals suspect→alive and advances dead→recovering.  Runs inside
        the op gate so topology changes drain it like any data op.
        ``ClusterWatch.sample()`` calls this every supervisor tick;
        `start_prober` runs it from a dedicated thread instead."""
        summary: Dict[str, object] = {"probed": 0, "ok": 0, "failed": 0}
        with self._gate.op():
            topo = self._topo
            for node in topo.nodes:
                summary["probed"] += 1
                try:
                    node.has_cuboid(0, 0, 0)
                except Exception as e:
                    summary["failed"] += 1
                    self._record_error(node, e)
                else:
                    summary["ok"] += 1
                    self._probe_ok(node)
            summary["health"] = [self._health_state(n) for n in topo.nodes]
        return summary

    def start_prober(self, interval: float = 0.25) -> None:
        """Run `probe_health` on a background tick (idempotent).  Only
        needed when no `StorageSupervisor` is watching the cluster — its
        sample() already ticks the probe."""
        if self._prober is not None and self._prober.is_alive():
            return
        self._prober_stop.clear()

        def loop():
            while not self._prober_stop.wait(interval):
                try:
                    self.probe_health()
                except Exception as e:
                    # mid-close or mid-swap; record it and keep ticking
                    self.last_probe_error = repr(e)

        self._prober = threading.Thread(
            target=loop, name="ocp-health-prober", daemon=True)
        self._prober.start()

    def stop_prober(self) -> None:
        self._prober_stop.set()
        prober, self._prober = self._prober, None
        if prober is not None:
            prober.join(timeout=10.0)

    def mark_dead(self, node: int) -> None:
        """Operator override: declare a node dead right now (reads stop
        routing to it; writes skip it and queue repairs)."""
        topo = self._topo
        with self._health_lock:
            key = id(topo.nodes[node])
            h = self._health.get(key)
            if h is None:
                h = self._health[key] = _NodeHealth()
            h.set("dead")

    def node_health(self) -> List[Dict[str, object]]:
        """Per-node health snapshot — the ``/stats`` section and the
        ``repro_node_health`` metric family."""
        with self._gate.op():
            topo = self._topo
        repair = self._repair_counts(topo)
        out: List[Dict[str, object]] = []
        with self._health_lock:
            for i, node in enumerate(topo.nodes):
                h = self._health.get(id(node))
                out.append({
                    "node": i,
                    "state": h.state if h else "alive",
                    "consecutive_errors": h.errors if h else 0,
                    "transitions": h.transitions if h else 0,
                    "last_error": h.last_error if h else None,
                    "repair_pending": repair[i],
                })
        return out

    # -- anti-entropy repair queue -------------------------------------------
    def _mark_dirty(self, node: CuboidStore, key: Key) -> None:
        with self._repair_lock:
            self._dirty.setdefault(id(node), set()).add(key)
            self.repair_enqueued += 1

    def _clear_dirty(self, node: CuboidStore, keys: Iterable[Key]) -> None:
        """A successful write to ``node`` settles its pending repairs for
        those keys: the node now holds the freshest value, and replaying
        an older mark from a peer could roll an acked write back."""
        with self._repair_lock:
            dirty = self._dirty.get(id(node))
            if not dirty:
                return
            dirty.difference_update(keys)
            if not dirty:
                del self._dirty[id(node)]

    def _repair_counts(self, topo: _Topology) -> List[int]:
        with self._repair_lock:
            return [len(self._dirty.get(id(n), ())) for n in topo.nodes]

    def _dirty_overlap(self, node: CuboidStore, r: int, channel: int,
                       a: int, b: int) -> bool:
        """Does ``node`` hold a pending repair inside [a, b) at (r,
        channel)?  Such a member missed a write there — reads must prefer
        a member holding the freshest value."""
        with self._repair_lock:
            dirty = self._dirty.get(id(node))
            if not dirty:
                return False
            if b - a == 1:
                return (r, channel, a) in dirty
            return any(k[0] == r and k[1] == channel and a <= k[2] < b
                       for k in dirty)

    def _degraded_cluster(self, topo: _Topology) -> bool:
        """True when any current node is not alive or repairs are queued —
        the signal that flips writes onto the quorum slow path (under the
        move lock, serialized with the repair/migration copiers).
        Unlocked reads: a transition mid-write at worst sends one write
        down the fast path, which then fails exactly as it would have
        before health tracking existed."""
        if self._dirty:
            return True
        if self._health:
            for node in topo.nodes:
                h = self._health.get(id(node))
                if h is not None and h.state != "alive":
                    return True
        return False

    # -- access heat ---------------------------------------------------------
    def _touch_heat(self, heat: Dict[Tuple[int, int], int], r: int, m: int, n: int = 1) -> None:
        key = (r, m >> self.heat_bits)
        with self._heat_lock:
            heat[key] = heat.get(key, 0) + n

    def access_heat(self, top: Optional[int] = None) -> Dict[str, object]:
        """Per-segment access-heat counters: morton-bucket touch counts by
        direction, hottest first.  ``top`` truncates each direction to its
        N hottest buckets (the ``/metrics`` exposition asks for a top-N;
        the supervisor's ClusterWatch reads the full map)."""
        with self._heat_lock:
            read = dict(self._read_heat)
            write = dict(self._write_heat)

        def rank(heat: Dict[Tuple[int, int], int]) -> List[Tuple[int, int, int]]:
            rows = sorted(
                ((r, b, n) for (r, b), n in heat.items()), key=lambda t: (-t[2], t[0], t[1])
            )
            return rows[:top] if top is not None else rows

        return {"bits": self.heat_bits, "read": rank(read), "write": rank(write)}

    # -- replica selection --------------------------------------------------
    def _pick_replica(
        self,
        topo: _Topology,
        members: Tuple[int, ...],
        assigned: Optional[Dict[int, int]] = None,
    ) -> int:
        """Least-loaded member of a replica set (reads balance here).

        Load is the node's health rank (suspect members are deprioritized
        — they serve only when every alive member is busier), then the
        ``PathStats.inflight`` gauge (cluster read jobs it is serving
        *right now*) plus any pieces this caller already assigned it,
        tie-broken by lifetime reads so an idle cluster still round-robins
        instead of pinning the primary."""
        if len(members) == 1:
            return members[0]
        best = members[0]
        best_load = None
        for i in members:
            stats = topo.nodes[i].read_stats
            load = (
                _HEALTH_RANK.get(self._health_state(topo.nodes[i]), 0),
                stats.inflight + (assigned.get(i, 0) if assigned else 0),
                stats.reads,
                i,
            )
            if best_load is None or load < best_load:
                best, best_load = i, load
        return best

    def _filter_members(
        self,
        topo: _Topology,
        members: Tuple[int, ...],
        exclude,
        r: int,
        channel: int,
        a: int,
        b: int,
    ) -> Optional[Tuple[int, ...]]:
        """Members eligible to serve reads of [a, b) at (r, channel).

        Prefers members that are serving (not dead/recovering) and hold
        no pending repair inside the span, falling back one tier at a
        time so a fully degraded set still yields *something* to try
        rather than failing outright.  Returns ``()`` when every member
        is excluded (all failed this request), and ``None`` when only
        per-key routing can find clean members (a multi-key span with
        repairs scattered across every serving member)."""
        cands = [i for i in members if i not in exclude]
        if not cands:
            return ()
        serving = [i for i in cands
                   if self._health_state(topo.nodes[i]) not in _NOT_SERVING]
        pool = serving or cands
        if self._dirty:
            clean = [i for i in pool
                     if not self._dirty_overlap(topo.nodes[i], r, channel, a, b)]
            if clean:
                return tuple(clean)
            if b - a > 1:
                return None
        return tuple(pool)

    def _read_split(
        self,
        topo: _Topology,
        r: int,
        runs,
        channel: int = 0,
        exclude=frozenset(),
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Split runs at partition boundaries and route each piece to the
        least-loaded *eligible* member of its replica set (dead and
        repair-pending members routed around; see `_filter_members`).
        Every routed piece bumps the read-heat bucket of its start index
        (piece-granular, not per-cuboid — heat is a ranking signal, not
        an exact count).  Raises :class:`NoLiveReplica` when a piece has
        no member left to try."""
        router = topo.router
        if router.n_replicas == 1 and not exclude:
            # sole-owner routing: health filtering has no alternative to
            # offer, so the fast path stands
            by_node = router.split_runs(r, runs)
            for pieces in by_node.values():
                for a, b in pieces:
                    self._touch_heat(self._read_heat, r, a, b - a)
            return by_node
        assigned: Dict[int, int] = {}
        by_node: Dict[int, List[Tuple[int, int]]] = {}
        for start, stop in runs:
            for members, a, b in router.split_run_replicas(r, start, stop):
                self._route_piece(topo, r, channel, members, a, b,
                                  exclude, assigned, by_node)
        return by_node

    def _route_piece(self, topo, r, channel, members, a, b, exclude,
                     assigned, by_node) -> None:
        cands = self._filter_members(topo, members, exclude, r, channel, a, b)
        if cands is None:
            # repairs scattered across every serving member: route per key
            # so each lands on a member holding its freshest value
            for m in range(a, b):
                self._route_piece(topo, r, channel, members, m, m + 1,
                                  exclude, assigned, by_node)
            return
        if not cands:
            raise NoLiveReplica(
                f"no serving replica for r={r} range [{a},{b}) "
                f"(members {members}, excluded {sorted(exclude)})")
        node = self._pick_replica(topo, cands, assigned)
        assigned[node] = assigned.get(node, 0) + 1
        by_node.setdefault(node, []).append((a, b))
        self._touch_heat(self._read_heat, r, a, b - a)

    @staticmethod
    def _serving_job(node: CuboidStore, fn: Callable[[], object], idx: int) -> Callable[[], object]:
        """Wrap a per-node read job so the node's inflight gauge tracks it
        (the signal `_pick_replica` balances on) and a sampled request
        gets one ``node.fetch`` span per fanned-out node."""

        def run():
            with trace.span("node.fetch", node=idx):
                with node.serving():
                    return fn()

        return run

    def _write_targets(self, topo: _Topology, r: int, m: int) -> Tuple[int, ...]:
        """Every node a write to (r, m) must reach: the snapshot router's
        replica set, plus members being added by an in-flight migration
        (only meaningful against the pre-migration snapshot)."""
        members = topo.router.replica_set(r, m)
        if self._moves and topo is self._moves_topo:
            extras = _move_extras(self._moves.get(r, ()), m, members)
            if extras:
                return members + extras
        return members

    def _call_node(self, node: CuboidStore, idx: int,
                   fn: Callable[[], object], budget: Optional[float]) -> object:
        """Run one node op, bounded by the caller's remaining deadline
        budget.  Without a budget (or without a pool) the call runs
        inline; with one it runs on the fan-out pool and is abandoned on
        expiry — the worker finishes (or keeps hanging) in the background
        while the caller fails over to the next replica."""
        job = self._serving_job(node, fn, idx)
        pool = self._pool
        if budget is None or pool is None:
            return job()
        before_submit(allow=self._submit_allow)
        fut = pool.submit(trace.bind(job))
        try:
            return fut.result(timeout=max(0.001, budget))
        except cf.TimeoutError:
            fut.cancel()
            raise TimeoutError(
                f"node {idx} op exceeded the deadline budget") from None

    # -- single-cuboid ops (routed) ----------------------------------------
    def read_cuboid(self, r: int, m: int, channel: int = 0) -> np.ndarray:
        with self._gate.op():
            topo = self._topo
            members = topo.router.replica_set(r, m)
            self._touch_heat(self._read_heat, r, m)
            t_left = deadline.remaining()
            t_end = None if t_left is None else time.monotonic() + t_left
            tried: List[int] = []
            last: Optional[BaseException] = None
            while True:
                cands = self._filter_members(topo, members, tried,
                                             r, channel, m, m + 1)
                if not cands:
                    break
                budget = None if t_end is None else t_end - time.monotonic()
                if budget is not None and budget <= 0 and last is not None:
                    break  # budget spent; surface the last failure
                if budget is not None and len(cands) > 1:
                    # Split the remainder across untried members: a hung
                    # first replica must leave failover headroom.
                    budget = budget / len(cands)
                idx = self._pick_replica(topo, cands)
                tried.append(idx)
                node = topo.nodes[idx]
                try:
                    out = self._call_node(
                        node, idx,
                        functools.partial(node.read_cuboid, r, m, channel),
                        budget)
                except Exception as e:
                    self._record_error(node, e)
                    last = e
                    continue  # retry onto the next surviving replica
                self._record_ok(node)
                return out
            if last is not None:
                raise last
            raise NoLiveReplica(f"no serving replica for r={r} m={m}")

    def write_cuboid(self, r: int, m: int, data: np.ndarray, channel: int = 0) -> None:
        with self._gate.op():
            topo = self._topo
            members = topo.router.replica_set(r, m)
            self._touch_heat(self._write_heat, r, m)
            targets = self._write_targets(topo, r, m)
            migrating = len(targets) != len(members)
            if not migrating and not self._degraded_cluster(topo):
                for node in targets:
                    topo.nodes[node].write_cuboid(r, m, data, channel)
                return
            # Migrating double-writes and degraded-cluster writes both
            # serialize with the copiers through the move lock: a stale
            # copy (migration or repair) must never clobber this write.
            # Migrating keys are strict (every reachable target must ack —
            # a member added by the move becomes authoritative at swap and
            # its old members get range-dropped, so a quorum miss there
            # could strand the only fresh copy); others ack at a quorum of
            # live members and queue misses for repair.
            with self._move_lock:
                self._write_degraded(
                    topo, r, {m: data}, channel,
                    targets_of=lambda _m: targets,
                    strict_of=lambda _m: migrating)

    def has_cuboid(self, r: int, m: int, channel: int = 0) -> bool:
        with self._gate.op():
            topo = self._topo
            members = topo.router.replica_set(r, m)
            tried: List[int] = []
            last: Optional[BaseException] = None
            while True:
                cands = self._filter_members(topo, members, tried,
                                             r, channel, m, m + 1)
                if not cands:
                    break
                idx = self._pick_replica(topo, cands)
                tried.append(idx)
                node = topo.nodes[idx]
                try:
                    out = node.has_cuboid(r, m, channel)
                except Exception as e:
                    self._record_error(node, e)
                    last = e
                    continue
                self._record_ok(node)
                return out
            if last is not None:
                raise last
            raise NoLiveReplica(f"no serving replica for r={r} m={m}")

    # -- batch ops (routed + parallel) -------------------------------------
    def read_run(self, r: int, start: int, stop: int, channel: int = 0) -> List[np.ndarray]:
        """Run read in curve order, split at partition boundaries; each
        piece is served by the least-loaded eligible member of its
        replica set, failing over to the next member on error."""
        with self._gate.op():
            topo = self._topo
            out: List[np.ndarray] = []
            assigned: Dict[int, int] = {}
            for members, a, b in topo.router.split_run_replicas(r, start, stop):
                self._touch_heat(self._read_heat, r, a, b - a)
                out.extend(self._read_piece(topo, r, channel, members, a, b, assigned))
            return out

    def _read_piece(self, topo, r, channel, members, a, b, assigned) -> List[np.ndarray]:
        tried: List[int] = []
        last: Optional[BaseException] = None
        while True:
            cands = self._filter_members(topo, members, tried, r, channel, a, b)
            if cands is None:
                blocks: List[np.ndarray] = []
                for m in range(a, b):
                    blocks.extend(self._read_piece(
                        topo, r, channel, members, m, m + 1, assigned))
                return blocks
            if not cands:
                break
            idx = self._pick_replica(topo, cands, assigned)
            tried.append(idx)
            assigned[idx] = assigned.get(idx, 0) + 1
            node = topo.nodes[idx]
            try:
                with node.serving():
                    out = node.read_run(r, a, b, channel)
            except Exception as e:
                self._record_error(node, e)
                last = e
                continue
            self._record_ok(node)
            return out
        if last is not None:
            raise last
        raise NoLiveReplica(f"no serving replica for r={r} range [{a},{b})")

    def _fan_out_fetch(self, topo, r, runs, channel, node_call, merge) -> None:
        """Shared failover engine for the batch fetch paths.

        Splits ``runs`` across eligible replica members, fans out, and
        re-routes the pieces of every failed (or deadline-expired) node
        onto surviving members — round by round, excluding each member
        that already failed this request — until every piece lands or no
        member remains.  ``node_call(idx, node_runs)`` performs one
        node's fetch; ``merge(result)`` folds a successful one in (a
        retried sink write re-lands identical bytes in the same disjoint
        slices, so double-merges are benign)."""
        t_left = deadline.remaining()
        t_end = None if t_left is None else time.monotonic() + t_left
        failed: set = set()
        pending = list(runs)
        last: Optional[BaseException] = None
        rounds = 0
        while pending:
            try:
                by_node = self._read_split(topo, r, pending,
                                           channel=channel, exclude=failed)
            except NoLiveReplica:
                if last is not None:
                    raise last from None
                raise
            jobs = {
                idx: self._serving_job(
                    topo.nodes[idx],
                    functools.partial(node_call, idx, node_runs),
                    idx,
                )
                for idx, node_runs in by_node.items()
            }
            budget = None if t_end is None else t_end - time.monotonic()
            if budget is not None:
                # Leave failover headroom: early rounds get a slice of the
                # remainder so a hung node can't starve the retry rounds.
                rounds_left = max(1, topo.router.n_replicas - rounds)
                if rounds_left > 1:
                    budget = budget / rounds_left
            rounds += 1
            results = self._fan_out_checked(jobs, budget)
            pending = []
            for idx, (ok, value) in results.items():
                node = topo.nodes[idx]
                if ok:
                    self._record_ok(node)
                    merge(value)
                else:
                    self._record_error(node, value)
                    last = value
                    failed.add(idx)
                    pending.extend(by_node[idx])

    def fetch_runs(
        self,
        r: int,
        runs: Sequence[Tuple[int, int]],
        channel: int = 0,
        decode: bool = False,
    ):
        """Batch blob fetch: split runs by owner, fetch nodes in parallel.

        ``decode=True`` is the pipelined cold-read mode: each node worker
        decompresses its own runs' blobs (chunked over the shared decode
        pool) and the merged result maps morton index to decoded block —
        decode work rides the per-node fan-out instead of serializing in
        the caller thread.
        """
        with self._gate.op():
            topo = self._topo
            merged: Dict[int, object] = {}

            def node_call(idx, node_runs):
                return topo.nodes[idx].fetch_runs(r, node_runs, channel, decode=decode)

            self._fan_out_fetch(topo, r, list(runs), channel, node_call, merged.update)
            return merged

    def fetch_blocks(
        self,
        r: int,
        runs: Sequence[Tuple[int, int]],
        channel: int = 0,
        sink: Optional[BlockSink] = None,
    ) -> Dict[int, Optional[np.ndarray]]:
        """Decoded-cuboid batch fetch, fanned out per node.

        Every node worker runs the full pipelined cold path on its own
        runs — cache lookups, parallel decompress, plan-driven segment
        prefetch — and with ``sink`` it assembles straight into the
        caller's shared output buffer (the cutout engine passes a sink
        writing disjoint ``buf_slices``, so concurrent node workers never
        race).  Without a sink, returns the merged block dict.
        """
        with self._gate.op():
            topo = self._topo
            merged: Dict[int, Optional[np.ndarray]] = {}

            def node_call(idx, node_runs):
                return topo.nodes[idx].fetch_blocks(r, node_runs, channel, sink=sink)

            def merge(part):
                if part:
                    merged.update(part)

            self._fan_out_fetch(topo, r, list(runs), channel, node_call, merge)
            return merged

    def run_batch(self, jobs: Sequence[Callable[[], object]]) -> List[object]:
        """Overlap independent request-level jobs (the §4.2 batch
        interface): each job typically drives a whole cutout, whose node
        fan-out and decode chunks then pipeline with the other boxes'.
        Serial when request parallelism is disabled (``max_workers<=1``).
        """
        jobs = list(jobs)
        # Request overlap is its own axis: a single-node cluster still
        # pipelines one box's I/O against another's decode.  Only an
        # explicit max_workers<=1 (the deterministic-profiling knob)
        # forces serial execution.
        serial = self._cfg_max_workers is not None and self._cfg_max_workers <= 1
        if serial or len(jobs) <= 1:
            return [job() for job in jobs]
        with self._batch_lock:
            if self._batch_pool is None:
                self._batch_pool = cf.ThreadPoolExecutor(
                    max_workers=self.request_slots,
                    thread_name_prefix="ocp-batch",
                )
            pool = self._batch_pool
        before_submit()
        futures = [pool.submit(trace.bind(job)) for job in jobs]
        return [f.result() for f in futures]

    @property
    def request_slots(self) -> int:
        """Concurrency of the request-level batch pool (`run_batch`) — the
        admission signal an HTTP front door sizes its limiter from."""
        if self._cfg_max_workers is not None and self._cfg_max_workers <= 1:
            return 1
        return min(8, max(2, len(self._topo.nodes)))

    def store_cuboids(self, r: int, blocks: Dict[int, np.ndarray], channel: int = 0) -> None:
        """Batch write: group blocks by replica set, write nodes in
        parallel (every member gets every block it holds).

        Blocks inside a migrating range are *also* written to the members
        being added (under the move lock), keeping them complete before
        the topology swap makes them authoritative.
        """
        with self._gate.op():
            topo = self._topo
            moves = self._moves.get(r, ()) if (self._moves and topo is self._moves_topo) else ()
            if self._degraded_cluster(topo):
                # Degraded: some member is unhealthy or holds queued
                # repairs — every block takes the quorum path under the
                # move lock, serialized with the repair/migration copiers.
                for m in blocks:
                    self._touch_heat(self._write_heat, r, m)

                def targets_of(m):
                    members = topo.router.replica_set(r, m)
                    extras = _move_extras(moves, m, members) if moves else ()
                    return members + extras

                def strict_of(m):
                    members = topo.router.replica_set(r, m)
                    return bool(moves) and bool(_move_extras(moves, m, members))

                with self._move_lock:
                    self._write_degraded(topo, r, dict(blocks), channel,
                                         targets_of, strict_of)
                return
            by_node: Dict[int, Dict[int, np.ndarray]] = {}
            doubling: Dict[int, Dict[int, np.ndarray]] = {}
            for m, data in blocks.items():
                members = topo.router.replica_set(r, m)
                self._touch_heat(self._write_heat, r, m)
                extras = _move_extras(moves, m, members) if moves else ()
                if extras:
                    # migrating: double-write members + added members under
                    # the move lock (serialized with the copier)
                    for node in members + extras:
                        doubling.setdefault(node, {})[m] = data
                else:
                    for node in members:
                        by_node.setdefault(node, {})[m] = data
            if by_node:  # non-moving blocks never wait on the move lock
                jobs = {
                    node: functools.partial(
                        topo.nodes[node].store_cuboids, r, node_blocks, channel
                    )
                    for node, node_blocks in by_node.items()
                }
                self._fan_out(jobs)
            if doubling:
                jobs = {
                    node: functools.partial(
                        topo.nodes[node].store_cuboids, r, node_blocks, channel
                    )
                    for node, node_blocks in doubling.items()
                }
                with self._move_lock:
                    self._fan_out(jobs)

    def _write_degraded(
        self,
        topo: _Topology,
        r: int,
        blocks: Dict[int, np.ndarray],
        channel: int,
        targets_of: Callable[[int], Tuple[int, ...]],
        strict_of: Callable[[int], bool],
    ) -> None:
        """Replicated write with per-key quorum accounting (the degraded /
        migrating slow path; callers hold the move lock).

        ``targets_of(m)`` lists every node key ``m`` must reach.  Dead
        members are skipped outright — their miss goes straight to the
        repair queue (a write must never wait on a dead node).  Every
        other member is attempted serially; a failure degrades its health
        and queues the miss.  Each key must then ack on a quorum —
        majority of its non-dead targets, or ALL of them when
        ``strict_of(m)`` (migrating keys) — or :class:`WriteQuorumError`
        raises and the write is unacknowledged.  Either way each miss is
        marked dirty on the member that missed it, so reads keep routing
        to members holding the freshest value until repair replays it."""
        per_node: Dict[int, Dict[int, np.ndarray]] = {}
        attempted: Dict[int, List[int]] = {}  # m -> non-dead targets
        for m, data in blocks.items():
            attempted[m] = []
            for t in targets_of(m):
                if self._health_state(topo.nodes[t]) == "dead":
                    self._mark_dirty(topo.nodes[t], (r, channel, m))
                else:
                    attempted[m].append(t)
                    per_node.setdefault(t, {})[m] = data
        failed: Dict[int, BaseException] = {}
        for idx in sorted(per_node):
            node = topo.nodes[idx]
            try:
                node.store_cuboids(r, per_node[idx], channel)
            except Exception as e:
                self._record_error(node, e)
                failed[idx] = e
                for m in per_node[idx]:
                    self._mark_dirty(node, (r, channel, m))
            else:
                self._record_ok(node)
                # This node now holds the freshest value for these keys:
                # drop any stale repair marks so a later resync can never
                # replay an older peer copy over an acked write.
                self._clear_dirty(node,
                                  [(r, channel, m) for m in per_node[idx]])
        under: List[str] = []
        for m in blocks:
            live = attempted[m]
            acks = sum(1 for t in live if t not in failed)
            quorum = len(live) if strict_of(m) else (len(live) // 2 + 1)
            quorum = max(1, quorum)
            if acks < quorum:
                under.append(f"m={m}: {acks}/{quorum} acks "
                             f"(targets {tuple(targets_of(m))})")
        if under:
            last = next(iter(failed.values())) if failed else None
            raise WriteQuorumError(
                f"write quorum not reached at r={r}: " + "; ".join(under[:4])
            ) from last

    # -- elasticity (paper §6: dynamically redistribute data) ---------------
    def topology(self) -> Dict[str, object]:
        """Introspection snapshot served by ``GET /topology``."""
        with self._gate.op():
            topo = self._topo
            # Shards appended by a grow-in-progress (or add_node without a
            # rebalance) ride outside the router: pad their segments empty
            # so "node i owns segments[i]" holds for the whole node tuple.
            n_pad = len(topo.nodes) - topo.router.n_nodes
            segments = {}
            for r in range(self.spec.n_resolutions):
                segs = topo.router.segments(r)
                if n_pad > 0:
                    n_cells = topo.router.n_cells(r)
                    segs = segs + [(n_cells, n_cells)] * n_pad
                segments[r] = segs
            return {
                "n_nodes": len(topo.nodes),
                "elastic": True,
                "rebalancing": bool(self._moves),
                "replication": topo.router.n_replicas,
                # effective vs achievable target: a gap means segments are
                # under-replicated (ring shrank below N, or riders joined
                # outside the router) and re_replicate() can heal it
                "replication_target": min(self.replication, len(topo.nodes)),
                "segments": segments,
                "keys_per_node": self._key_counts(topo),
                "cache_nodes": sum(1 for n in topo.nodes if n.cache is not None),
                "write_behind_nodes": sum(
                    1 for n in topo.nodes if n.write_behind is not None
                ),
                "health": [self._health_state(n) for n in topo.nodes],
                "repair_pending": sum(self._repair_counts(topo)),
            }

    def add_node(
        self,
        node_factory: Optional[NodeFactory] = None,
        rebalance: bool = True,
        wait: bool = True,
    ) -> int:
        """Grow the cluster by one shard; returns the new node's index.

        With ``rebalance=True`` (default) keys migrate onto it immediately
        (occupancy-balanced); otherwise it joins owning nothing until the
        next ``rebalance()``.
        """
        if not self._admin_lock.acquire(blocking=wait):
            raise RebalanceInFlight("a topology change is already in flight")
        try:
            index = self.n_nodes
            if rebalance:
                self.rebalance(target=index + 1, node_factory=node_factory)
            else:
                self._widen(index + 1, node_factory)
            return index
        finally:
            self._admin_lock.release()

    def remove_node(self, node: int = -1, wait: bool = True) -> Dict[str, object]:
        """Shrink the cluster: drop ``node`` with zero data loss.

        With ``replication >= 2`` every range the victim holds survives on
        its other members, which are promoted in place; ranges where the
        victim is the *only* member (replication 1) are streamed off it
        first.  Either way the migration protocol keeps concurrent reads
        and writes bit-identical throughout.
        """
        if not self._admin_lock.acquire(blocking=wait):
            raise RebalanceInFlight("a topology change is already in flight")
        try:
            topo = self._topo
            n = len(topo.nodes)
            if n <= 1:
                raise ValueError("cannot remove the last node")
            idx = node if node >= 0 else n + node
            if not (0 <= idx < n):
                raise ValueError(f"node {node} out of range for {n} nodes")
            t0 = time.perf_counter()
            # The survivors re-cut by occupancy; the victim appears in no
            # final replica set.  Final-router indices j map to physical
            # node j (below the victim) or j+1 (above it).
            occupancy = self._occupancy(topo)
            final_parts = {
                r: Partition.balanced(occupancy.get(r, ()), topo.router.n_cells(r), n - 1)
                for r in range(self.spec.n_resolutions)
            }
            final_router = Router(
                self.spec, n - 1, final_parts, topo.router.replication
            )
            phys_of_final = [j if j < idx else j + 1 for j in range(n - 1)]
            final_nodes = topo.nodes[:idx] + topo.nodes[idx + 1 :]
            moved_keys, moved_bytes = self._migrate_live(
                topo,
                final_router,
                phys_of_final,
                final_nodes,
                avoid_sources=frozenset({idx}),
            )
            # _migrate_live drained every op that could still hold the old
            # snapshot; nothing references the victim now.
            topo.nodes[idx].close()
            seconds = time.perf_counter() - t0
            REGISTRY.histogram(
                "repro_migration_seconds",
                {"op": "remove_node"},
                "live topology-change duration by admin op",
            ).observe(seconds)
            return {
                "n_nodes": n - 1,
                "removed": idx,
                "moved_keys": moved_keys,
                "moved_bytes": moved_bytes,
                "seconds": seconds,
            }
        finally:
            self._admin_lock.release()

    def rebalance(
        self,
        target: Optional[int] = None,
        node_factory: Optional[NodeFactory] = None,
        batch_keys: int = 64,
        wait: bool = True,
    ) -> Dict[str, object]:
        """Re-partition by occupancy and migrate keys live.

        ``target`` is the desired node count (default: keep the current
        one and only move boundaries).  Growth appends fresh shards first
        (outside the router, owning nothing), shrink drops the trailing
        shards after their keys migrate off.  ``wait=False`` raises
        :class:`RebalanceInFlight` if another topology change holds the
        admin lock.  Returns migration stats; see the module docstring
        for the coherence protocol.
        """
        if not self._admin_lock.acquire(blocking=wait):
            raise RebalanceInFlight("a topology change is already in flight")
        try:
            t0 = time.perf_counter()
            n_old = self.n_nodes
            n_new = n_old if target is None else int(target)
            if n_new <= 0:
                raise ValueError("rebalance target must be positive")
            if n_new > n_old:
                self._widen(n_new, node_factory)
            topo = self._topo
            occupancy = self._occupancy(topo)
            final_parts = {
                r: Partition.balanced(occupancy.get(r, ()), topo.router.n_cells(r), n_new)
                for r in range(self.spec.n_resolutions)
            }
            final_router = Router(
                self.spec, n_new, final_parts, topo.router.replication
            )
            final_nodes = topo.nodes[:n_new]
            dropped = topo.nodes[n_new:]
            try:
                moved_keys, moved_bytes = self._migrate_live(
                    topo,
                    final_router,
                    list(range(n_new)),
                    final_nodes,
                    batch_keys=batch_keys,
                )
            except BaseException:
                if n_new > n_old:
                    self._unwiden(n_old)
                raise
            for node in dropped:  # shrink: every op on the old snapshot drained
                node.close()
            seconds = time.perf_counter() - t0
            REGISTRY.histogram(
                "repro_migration_seconds",
                {"op": "rebalance"},
                "live topology-change duration by admin op",
            ).observe(seconds)
            return {
                "n_nodes": n_new,
                "moved_keys": moved_keys,
                "moved_bytes": moved_bytes,
                "seconds": seconds,
            }
        finally:
            self._admin_lock.release()

    def re_replicate(self, wait: bool = True) -> Dict[str, object]:
        """Heal under-replication: bring every curve segment back up to
        ``min(replication, n_nodes)`` copies through the live-migration
        copy path.

        The gap this closes: after the ring shrinks below ``replication``
        (``remove_node`` down to fewer nodes than N) and a node later
        joins with ``add_node(rebalance=False)``, the rider sits *outside*
        the router — no successor ring includes it, so every segment stays
        under-replicated forever unless a full rebalance happens to run.
        This verb widens the router over the riders **without moving any
        partition boundary** (they own empty segments) and lets the
        replica-set diff copy each range to its new ring members — cheaper
        and less disruptive than a rebalance, and safe under the same
        coherence protocol.  Idempotent: a fully-replicated cluster
        returns ``healed=False`` with zero copies.
        """
        if not self._admin_lock.acquire(blocking=wait):
            raise RebalanceInFlight("a topology change is already in flight")
        try:
            t0 = time.perf_counter()
            topo = self._topo
            n = len(topo.nodes)
            target = min(self.replication, n)
            if topo.router.n_nodes == n and topo.router.n_replicas >= target:
                return {
                    "n_nodes": n,
                    "replication": topo.router.n_replicas,
                    "healed": False,
                    "moved_keys": 0,
                    "moved_bytes": 0,
                    "seconds": time.perf_counter() - t0,
                }
            final_parts = {}
            for r in range(self.spec.n_resolutions):
                part = topo.router.partition(r)
                extra = n - topo.router.n_nodes
                if extra > 0:
                    # widen with trailing empty segments: riders enter the
                    # successor rings but own no primary range
                    part = Partition(part.bounds + (part.n_cells,) * extra)
                final_parts[r] = part
            final_router = Router(self.spec, n, final_parts, self.replication)
            moved_keys, moved_bytes = self._migrate_live(
                topo, final_router, list(range(n)), topo.nodes
            )
            seconds = time.perf_counter() - t0
            REGISTRY.histogram(
                "repro_migration_seconds",
                {"op": "re_replicate"},
                "live topology-change duration by admin op",
            ).observe(seconds)
            return {
                "n_nodes": n,
                "replication": self._topo.router.n_replicas,
                "healed": True,
                "moved_keys": moved_keys,
                "moved_bytes": moved_bytes,
                "seconds": seconds,
            }
        finally:
            self._admin_lock.release()

    def resync_node(self, node: int, wait: bool = True) -> Dict[str, object]:
        """Anti-entropy resync: replay a node's queued repair keys from
        its replica peers, then re-admit it (recovering → alive).

        Every key the node missed (failed writes, writes skipped while it
        was dead) sits in its repair set.  Each batch is copied under the
        move lock from a serving member of the key's *current* replica
        set — writes overlapping a repair also serialize on that lock, so
        a copy can never clobber a fresher concurrent write.  Deletes
        replay too (a missing source blob ingests as ``None``).  Keys
        whose replica set no longer lists the node are discarded: the
        range moved off it, and resurrecting data it no longer owns would
        leak stale reads after a later reassignment.

        The supervisor calls this for every recovering node (and any
        alive node with a repair backlog); ``healed=False`` means dirt
        kept accumulating faster than eight replay rounds drained it —
        the node is still failing writes and stays un-readmitted."""
        if not self._admin_lock.acquire(blocking=wait):
            raise RebalanceInFlight("a topology change is already in flight")
        try:
            topo = self._topo
            n = len(topo.nodes)
            idx = node if node >= 0 else n + node
            if not (0 <= idx < n):
                raise ValueError(f"node {node} out of range for {n} nodes")
            target = topo.nodes[idx]
            copied = discarded = rounds = 0
            while rounds < 8:
                with self._repair_lock:
                    dirty = self._dirty.pop(id(target), None)
                if not dirty:
                    break
                rounds += 1
                try:
                    c, d = self._replay_dirty(topo, idx, sorted(dirty))
                except BaseException:
                    # a source failed mid-replay: the popped keys are not
                    # repaired — put them back so nothing is forgotten
                    with self._repair_lock:
                        self._dirty.setdefault(id(target), set()).update(dirty)
                    raise
                copied += c
                discarded += d
            with self._repair_lock:
                healed = not self._dirty.get(id(target))
            if healed:
                with self._health_lock:
                    h = self._health.get(id(target))
                    if h is not None:
                        h.errors = 0
                        if h.state != "alive":
                            h.set("alive")
            return {"node": idx, "resynced": copied, "discarded": discarded,
                    "rounds": rounds, "healed": healed}
        finally:
            self._admin_lock.release()

    def _replay_dirty(self, topo: _Topology, idx: int,
                      keys: List[Key]) -> Tuple[int, int]:
        """Copy the freshest value of each dirty key onto node ``idx``
        from the healthiest other member of its replica set, in run
        batches under the move lock.  Returns (copied, discarded)."""
        target = topo.nodes[idx]
        router = topo.router
        copied = discarded = 0
        by_rc: Dict[Tuple[int, int], List[int]] = {}
        for r, c, m in keys:
            if idx not in router.replica_set(r, m):
                discarded += 1  # range moved off this node; nothing to repair
                continue
            by_rc.setdefault((r, c), []).append(m)
        for (r, c), ms in sorted(by_rc.items()):
            ms.sort()
            for i in range(0, len(ms), 64):
                chunk = ms[i:i + 64]
                by_src: Dict[int, List[int]] = {}
                for m in chunk:
                    peers = [s for s in router.replica_set(r, m) if s != idx]
                    if not peers:
                        # replication=1: the node is the sole owner — the
                        # missed value exists nowhere else, and the write
                        # that missed was never acknowledged
                        discarded += 1
                        continue
                    # A peer that is itself dirty for this key missed the
                    # acked write too — replaying from it would roll the
                    # key back.  Every acked write leaves at least one
                    # clean acker, so clean-first is also freshest-first.
                    src = min(peers, key=lambda s: (
                        self._dirty_overlap(topo.nodes[s], r, c, m, m + 1),
                        _HEALTH_RANK.get(self._health_state(topo.nodes[s]), 0),
                        s))
                    by_src.setdefault(src, []).append(m)
                for src, sms in sorted(by_src.items()):
                    with self._move_lock:
                        blobs = topo.nodes[src].fetch_runs(
                            r, morton.indices_to_runs(sms), c)
                        items = [((r, c, m), blobs.get(m)) for m in sms]
                        target.ingest_blobs(items)
                    copied += len(items)
        return copied, discarded

    def _swap_topo(self, topo: _Topology) -> None:
        self._topo = topo  # atomic reference swap; ops snapshot it once
        ids = {id(n) for n in topo.nodes}
        with self._health_lock:
            for key in [k for k in self._health if k not in ids]:
                del self._health[key]
        with self._repair_lock:
            for key in [k for k in self._dirty if k not in ids]:
                del self._dirty[key]
        if self._cfg_max_workers is not None:
            return  # caller pinned the worker count; keep it
        pool = self._pool
        workers = getattr(pool, "_max_workers", 0) if pool is not None else 0
        if len(topo.nodes) > max(workers, 1):
            # Grow fan-out parallelism with the cluster.  The old pool is
            # retired, not shut down: in-flight ops hold a reference and
            # may still submit to it; close() reaps every generation.
            if pool is not None:
                self._retired_pools.append(pool)
            self._pool = cf.ThreadPoolExecutor(
                max_workers=len(topo.nodes), thread_name_prefix="ocp-node"
            )

    def _widen(self, n_new: int, node_factory: Optional[NodeFactory]) -> None:
        """Append fresh shards to the node tuple *without* touching the
        Router: they own nothing and sit in no replica set until a
        migration's final swap assigns them, so no intermediate router
        (whose successor rings would differ from the final one) is ever
        published."""
        topo = self._topo
        nodes = list(topo.nodes)
        for i in range(len(nodes), n_new):
            nodes.append(self._build_node(i, node_factory))
        self._swap_topo(_Topology(tuple(nodes), topo.router))
        self._gate.synchronize()  # all traffic now sees the widened topology

    def _unwiden(self, n_old: int) -> None:
        """Undo `_widen` after a failed grow-migration: drop the appended
        shards again — but only while the router never swapped (the failed
        migration left ownership untouched; its rollback already wiped any
        blobs landed on the new shards).  Without this, every failed
        ``POST /rebalance`` would leak a set of phantom nodes (threads,
        queues, caches) and misreport the cluster size."""
        topo = self._topo
        if topo.router.n_nodes > n_old:
            return  # the final swap happened; the widened nodes must stay
        dropped = topo.nodes[n_old:]
        if not dropped:
            return
        self._swap_topo(_Topology(topo.nodes[:n_old], topo.router))
        self._gate.synchronize()
        for node in dropped:
            try:
                node.close()
            except Exception as e:
                # the original migration failure is re-raising through the
                # caller; record this secondary one instead of losing it
                self.last_unwiden_error = repr(e)

    def _occupancy(self, topo: _Topology) -> Dict[int, List[int]]:
        """{resolution: multiset of occupied cells} — the rebalance signal
        (`keys_per_node()` is its per-node projection)."""
        occupancy: Dict[int, List[int]] = {}
        for node in topo.nodes:
            for r, _c, m in node.stored_keys():
                occupancy.setdefault(r, []).append(m)
        return occupancy

    def _replica_moves(
        self,
        topo: _Topology,
        final_router: Router,
        phys_of_final: Sequence[int],
    ) -> Dict[int, Tuple[Move, ...]]:
        """Diff replica-set membership between the current router and the
        final one: {r: ((start, stop, old_members, new_members), ...)} for
        every curve range whose set changes.  All indices are physical
        positions in ``topo`` (final-router indices mapped through
        ``phys_of_final``)."""
        moves: Dict[int, Tuple[Move, ...]] = {}
        for r in range(self.spec.n_resolutions):
            old_part = topo.router.partition(r)
            new_part = final_router.partition(r)
            cuts = sorted(set(old_part.bounds) | set(new_part.bounds))
            entries: List[Move] = []
            for a, b in zip(cuts, cuts[1:]):
                if a >= b:
                    continue
                old_m = topo.router.replicas_of(int(old_part.owner(a)))
                new_m = tuple(
                    phys_of_final[j] for j in final_router.replicas_of(int(new_part.owner(a)))
                )
                if set(old_m) == set(new_m):
                    continue
                prev = entries[-1] if entries else None
                if prev is not None and prev[1] == a and prev[2:] == (old_m, new_m):
                    entries[-1] = (prev[0], b, old_m, new_m)
                else:
                    entries.append((a, b, old_m, new_m))
            if entries:
                moves[r] = tuple(entries)
        return moves

    def _migrate_live(
        self,
        topo: _Topology,
        final_router: Router,
        phys_of_final: Sequence[int],
        final_nodes: Tuple[CuboidStore, ...],
        batch_keys: int = 64,
        avoid_sources: frozenset = frozenset(),
    ) -> Tuple[int, int]:
        """Migrate from ``topo`` to the final (nodes, router) pair with
        zero lost or stale reads (the module-docstring protocol).

        ``phys_of_final[j]`` is final-router node ``j``'s position in
        ``topo.nodes`` — the two differ when a mid-tuple node is being
        removed.  ``avoid_sources`` are nodes the copy phase should not
        stream from when any other old member holds the range (the
        decommissioning victim).  Returns (moved_keys, moved_bytes),
        counting one move per (key, added member) copy."""
        moves = self._replica_moves(topo, final_router, phys_of_final)
        final_topo = _Topology(tuple(final_nodes), final_router)
        if not moves:  # membership unchanged (or only empty ranges moved)
            self._swap_topo(final_topo)
            self._gate.synchronize()
            return 0, 0

        # 1. register: publish the move set; once every in-flight op has
        # drained, all writes to moving keys double-write to the members
        # being added.
        self._moves = moves
        self._moves_topo = topo
        moved_keys = moved_bytes = 0
        swapped = False
        try:
            self._gate.synchronize()
            keys_by_src: Dict[int, List[Key]] = {}
            # 2. copy: stream existing keys from a surviving old member to
            # each added member, in small batches under the move lock
            # (serialized with double-writes so a stale copy can never
            # overwrite a fresher concurrent write).
            for r, entries in sorted(moves.items()):
                for start, stop, old_m, new_m in entries:
                    added = [d for d in new_m if d not in old_m]
                    if not added:
                        continue
                    srcs = [s for s in old_m if s not in avoid_sources] or list(old_m)
                    src = srcs[0]
                    if src not in keys_by_src:
                        keys_by_src[src] = topo.nodes[src].stored_keys()
                    by_channel: Dict[int, List[int]] = {}
                    for kr, kc, km in keys_by_src[src]:
                        if kr == r and start <= km < stop:
                            by_channel.setdefault(kc, []).append(km)
                    for c, ms in sorted(by_channel.items()):
                        ms.sort()
                        for i in range(0, len(ms), batch_keys):
                            chunk = ms[i : i + batch_keys]
                            with self._move_lock:
                                blobs = topo.nodes[src].fetch_runs(
                                    r, morton.indices_to_runs(chunk), c
                                )
                                items = [((r, c, m), blobs.get(m)) for m in chunk]
                                for dst in added:
                                    topo.nodes[dst].ingest_blobs(items)
                            moved_keys += len(items) * len(added)
                            moved_bytes += sum(len(b) for _, b in items if b) * len(added)
            # 3. swap: the final topology becomes authoritative in ONE
            # publication — replica rings are never evaluated against an
            # intermediate node count.  The move set must stay published
            # until every op that resolved membership under the OLD router
            # has drained — such a writer still routes to the old members
            # and relies on the move entry to also hit the added ones;
            # retiring the set first would let its write miss a now-
            # authoritative member.
            self._swap_topo(final_topo)
            swapped = True
            self._gate.synchronize()
        finally:
            # 4. retire the move set, then drain writers that may still
            # be double-writing before any key is deleted.
            self._moves = {}
            self._moves_topo = None
            self._gate.synchronize()
            if not swapped:
                # A failed migration must not strand blobs on the added
                # members: the old membership stays authoritative, and
                # anything landed there (copies *and* double-writes)
                # would resurrect as stale data when a later rebalance
                # re-assigns the range.  Under the old router those nodes
                # hold nothing inside a moved range and reads never
                # routed there, so wiping the range is invisible.
                self._rollback_destinations(topo, moves)
        # cleanup: every key in a moved range (including ones double-
        # written during the move) leaves the backends and cache of each
        # member dropped from the range's set — the surviving/added
        # members absorbed them already.
        ranges_by_node: Dict[int, List[Tuple[int, int, int]]] = {}
        for r, entries in moves.items():
            for start, stop, old_m, new_m in entries:
                for node in old_m:
                    if node not in new_m:
                        ranges_by_node.setdefault(node, []).append((r, start, stop))
        self._drop_ranges(topo, ranges_by_node, best_effort=False)
        return moved_keys, moved_bytes

    @classmethod
    def _rollback_destinations(
        cls, topo: _Topology, moves: Dict[int, Tuple[Move, ...]]
    ) -> None:
        """Best-effort: delete everything a failed migration landed on the
        added members (called after the move set is retired)."""
        ranges_by_node: Dict[int, List[Tuple[int, int, int]]] = {}
        for r, entries in moves.items():
            for start, stop, old_m, new_m in entries:
                for node in new_m:
                    if node not in old_m:
                        ranges_by_node.setdefault(node, []).append((r, start, stop))
        cls._drop_ranges(topo, ranges_by_node, best_effort=True)

    @staticmethod
    def _drop_ranges(
        topo: _Topology,
        ranges_by_node: Dict[int, List[Tuple[int, int, int]]],
        best_effort: bool,
    ) -> None:
        """Delete every stored key inside (r, start, stop) ranges from the
        given nodes' backends, and drop the whole range from their caches
        (blobs *and* cached absences — after a membership change a node's
        stale cache entries for the range must not outlive its data)."""
        for idx, ranges in ranges_by_node.items():
            node = topo.nodes[idx]
            try:
                stale = [
                    k
                    for k in node.stored_keys()
                    if any(k[0] == r and a <= k[2] < b for r, a, b in ranges)
                ]
                if stale:
                    node.ingest_blobs([(k, None) for k in stale])
                if node.cache is not None:
                    for r, a, b in ranges:
                        node.cache.invalidate_range(r, a, b)
            except Exception:
                if not best_effort:
                    raise
                continue  # the original migration failure is re-raising

    # -- maintenance / introspection ---------------------------------------
    def migrate(self) -> int:
        """Flush every node's write path into its read path (SSD→DB)."""
        with self._gate.op():
            nodes = self._topo.nodes
            jobs = {i: nodes[i].migrate for i in range(len(nodes))}
            return sum(self._fan_out(jobs).values())

    def stored_keys(self) -> List[Key]:
        """Every distinct key in the cluster (replica copies dedupe)."""
        with self._gate.op():
            keys: set = set()
            for node in self._topo.nodes:
                keys.update(node.stored_keys())
            return sorted(keys)

    def storage_bytes(self) -> int:
        with self._gate.op():
            return sum(node.storage_bytes() for node in self._topo.nodes)

    def keys_per_node(self) -> List[int]:
        """Shard occupancy — the rebalancing signal.

        Counted without the flush barrier (pending write-behind writes
        are folded in from a queue snapshot): a monitoring loop polling
        occupancy must not keep draining the queues it is observing."""
        with self._gate.op():
            return self._key_counts(self._topo)

    def _key_counts(self, topo: _Topology) -> List[int]:
        nodes = topo.nodes
        jobs = {i: nodes[i].key_count for i in range(len(nodes))}
        counts = self._fan_out(jobs)
        return [counts[i] for i in range(len(nodes))]

    @property
    def read_stats(self) -> PathStats:
        """Cluster-aggregate read-path stats (per-node stats on `nodes`)."""
        return _sum_stats([n.read_stats for n in self._topo.nodes])

    @property
    def write_stats(self) -> PathStats:
        return _sum_stats([n.write_stats for n in self._topo.nodes])

    def cache_counters(self) -> Dict[str, int]:
        """Aggregate hot-cuboid cache counters across node shards."""
        total: Dict[str, int] = {}
        for node in self._topo.nodes:
            if node.cache is None:
                continue
            for k, v in node.cache.counters().items():
                total[k] = total.get(k, 0) + v
        return total

    def queue_counters(self) -> Dict[str, int]:
        """Aggregate write-behind queue counters across node shards."""
        total: Dict[str, int] = {}
        for node in self._topo.nodes:
            if node.write_behind is None:
                continue
            for k, v in node.write_behind.counters().items():
                total[k] = total.get(k, 0) + v
        return total
