"""Cuboid storage: the host tiers and the device store above them.

The host half is the reference's (paper §4.1, C4): a `CuboidStore` is
backed by a *read path* (bulk, sequential-friendly, the "database node")
and an optional *write path* (an absorbing write-back store, the "SSD
node"), both instrumented (`PathStats`).  Storage is a dict or directory of
zlib-compressed cuboids keyed by (resolution, channel, morton_index); a
missing cuboid reads as zeros and occupies no storage (paper §3.2).  The
*cold read path* is a pipeline (paper §5: cutout throughput is bound by
assembly — decompress + placement — not disk): ``fetch_blocks`` decodes
blobs in parallel chunks on a shared decode pool and hands each block to
the caller's sink from the worker that decoded it; with a cache attached
it prefetches the next curve segments of a planned run schedule.
`DecodePolicy` holds its settings, as explicit arguments.  The segment
log (`core.wal`) and compaction (`core.compact`) are the write tier.

`DeviceCuboidStore` holds, for each resolution level ``r`` and channel
``c``, a tensor of shape ``(n_cells, *cuboid_shape)`` on its device whose
row ``m`` is the cuboid with Morton index ``m`` (the layout of
`core.distributed`): reads are gathers by the `cutout_gather` kernel,
writes are row scatters.  Channels are not in the Morton index: each
channel has a packed tensor of its own, as the reference keeps separate
cuboids per channel.  A (level, channel) is allocated (zero-filled) when
it is first used; without a backing, reading one that was never written
returns zeros, like the reference's lazy cuboids.  Over a backing host
store — a `CuboidStore`, or a `cluster.ClusterStore` of node stores — the
device store loads cuboids on first touch and writes every merged cuboid
through (`DeviceCuboidStore`).

Label data (``dtype="uint32"``) is held as int32 on the device with the
same bits: PyTorch's uint32 lacks ``index_select`` and ``max``.  Data
movement copies bytes, so the values are unchanged; the host tiers and the
numpy boundary (`carry`) see uint32.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import os
import threading
import time
import zlib
from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from ..analysis.witness import before_submit, ordered_lock, ordered_rlock
from ..device import DeviceLike, resolve_device
from ..obs import trace
from . import morton
from .cuboid import DatasetSpec
from .distributed import signed_view

if TYPE_CHECKING:
    from ..cluster.store import ClusterStore

Key = Tuple[int, int, int]  # (resolution, channel, morton index)

# sink(morton, block) — a decoded-cuboid consumer; blocks may arrive from
# decode worker threads, so sinks must be race-free (the cutout engine's
# sink writes disjoint output-buffer slices).
BlockSink = Callable[[int, Optional[np.ndarray]], None]

_MISS = object()  # sentinel: "not in the prefetch handoff" (None = absent)


# -- crash injection (tests only) -----------------------------------------
# The durability contract ("no torn cuboids, acked writes survive") is only
# testable if a crash can be simulated at the exact syscall boundaries the
# contract is about.  Tests install a hook that raises at a named point;
# production never sets one, so crashpoint() is a no-op attribute load.
_CRASH_HOOK: Optional[Callable[[str], None]] = None


def set_crash_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with ``None``) the process-wide crash hook."""
    global _CRASH_HOOK
    _CRASH_HOOK = hook


def crashpoint(name: str) -> None:
    """Named crash-injection point; calls the installed hook, if any.

    Points on the durable-put path: ``dir.put.written`` (tmp file written,
    not yet synced), ``dir.put.synced`` (tmp durable, not yet published),
    ``dir.put.renamed`` (published, directory entry not yet synced);
    ``wal.append.written`` / ``wal.append.synced`` on the log tier;
    ``compact.copied`` / ``compact.segment-removed`` during compaction.
    """
    hook = _CRASH_HOOK
    if hook is not None:
        hook(name)


@dataclasses.dataclass(frozen=True)
class DecodePolicy:
    """Cold-read pipeline knobs (paper §5: cutouts are assembly-bound).

    ``workers`` sizes the decode thread pool (0/1 = serial decode;
    zlib releases the GIL, so threads buy real decompress parallelism);
    ``chunk`` is the number of cuboids per decode task (amortizes submit
    overhead); ``prefetch_segments`` is how many *future* runs of a
    planned schedule are pulled into the hot-cuboid cache while the
    current one decodes (0 = off; needs a cache as the landing zone).

    ``default()`` is what a store gets when it is given no policy: as
    many workers as cores and one segment of lookahead.
    """

    workers: int = 0
    chunk: int = 16
    prefetch_segments: int = 0

    @classmethod
    def default(cls) -> "DecodePolicy":
        return cls(workers=os.cpu_count() or 1, prefetch_segments=1)


# Decode pools are shared per worker count across every store in the
# process (like numpy's global thread pool): per-store pools would leak
# idle threads for each short-lived store the tests and the cluster
# create, and a ClusterStore's node shards *should* decode into one pool —
# that is exactly the node-parallel pipeline saturating the cores.
_DECODE_POOLS: Dict[int, cf.ThreadPoolExecutor] = {}
_DECODE_POOLS_LOCK = ordered_lock("store.decode_pools", 80)


def _decode_pool(workers: int) -> cf.ThreadPoolExecutor:
    with _DECODE_POOLS_LOCK:
        pool = _DECODE_POOLS.get(workers)
        if pool is None:
            pool = _DECODE_POOLS[workers] = cf.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ocp-decode")
        return pool


@dataclasses.dataclass
class PathStats:
    """Per-path I/O counters.

    ``reads`` counts every cuboid lookup served by the path; with a cache
    attached every lookup also increments exactly one of ``cache_hits`` /
    ``cache_misses`` (on the read path), so for a cache-enabled store
    ``read_stats.reads + write_stats.reads ==
    read_stats.cache_hits + read_stats.cache_misses`` — the coherence
    invariant the stress suite asserts.  ``queue_depth`` / ``queue_peak``
    mirror the write-behind queue occupancy (gauges, updated on enqueue
    and flush); ``queue_retries`` / ``queue_poisoned`` mirror the queue's
    flush-retry and poison-quarantine counters.

    ``decoded_blocks`` / ``decode_s`` measure decompress work on the read
    path (the paper's assembly bound).  ``prefetch_issued`` /
    ``prefetch_cuboids`` count the plan-driven cache prefetcher's
    background work; prefetches are not client reads, so they stay out of
    the reads == hits + misses invariant.
    """

    reads: int = 0
    read_bytes: int = 0
    writes: int = 0
    write_bytes: int = 0
    seeks: int = 0          # discontiguous accesses (run boundaries)
    time_s: float = 0.0
    inflight: int = 0       # cluster read jobs currently on this node (gauge)
    cache_hits: int = 0     # lookups served by the hot-cuboid cache
    cache_misses: int = 0   # lookups that had to go below the cache
    queue_depth: int = 0    # write-behind pending writes (gauge)
    queue_peak: int = 0     # max pending writes observed (gauge)
    queue_retries: int = 0   # write-behind entries applied on a retry pass
    queue_poisoned: int = 0  # write-behind keys quarantined as poison
    decoded_blocks: int = 0  # blobs decompressed on the read path
    decode_s: float = 0.0    # wall time inside decompress (incl. workers)
    prefetch_issued: int = 0    # schedule-lookahead prefetch tasks launched
    prefetch_cuboids: int = 0   # blobs the prefetcher admitted to the cache
    prefetch_errors: int = 0    # lookahead tasks that failed (never fatal)
    tmp_swept: int = 0          # orphaned .tmp files removed on backend open

    def snapshot(self) -> "PathStats":
        return dataclasses.replace(self)


class Backend:
    """Minimal KV backend for compressed cuboids."""

    # Backends that record deletes as durable tombstones (the append-log
    # write tier) set this; a tombstone must *shadow* older data below it
    # in the tier stack until compaction applies the delete for real.
    supports_tombstones = False

    def get(self, key: Key) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: Key, blob: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: Key) -> None:
        raise NotImplementedError

    def keys(self) -> Iterable[Key]:
        raise NotImplementedError

    def __contains__(self, key: Key) -> bool:
        return self.get(key) is not None

    # -- batch ops (paper C7: a cutout is few sequential I/Os, not many
    # random ones).  Backends override when they can do better than a loop.
    def get_many(self, keys: Sequence[Key]) -> List[Optional[bytes]]:
        """Fetch many blobs in one backend call (order preserved)."""
        return [self.get(k) for k in keys]

    def put_many(self, items: Sequence[Tuple[Key, bytes]]) -> None:
        """Store many blobs in one backend call."""
        for k, blob in items:
            self.put(k, blob)

    # -- tombstone-aware lookup: (found, blob) ------------------------------
    # ``(True, None)`` means "definitively deleted here" — the merged read
    # view must stop and not fall through to a stale copy below.  For plain
    # backends found == (blob is not None), so these defaults change nothing.
    def probe(self, key: Key) -> Tuple[bool, Optional[bytes]]:
        blob = self.get(key)
        return blob is not None, blob

    def probe_many(
        self, keys: Sequence[Key]
    ) -> List[Tuple[bool, Optional[bytes]]]:
        return [(b is not None, b) for b in self.get_many(keys)]


class MemoryBackend(Backend):
    # Every accessor takes the lock: ``keys()`` snapshotting the dict while
    # the write-behind flusher lands a ``put_many`` raised ``RuntimeError:
    # dictionary changed size during iteration`` mid-rebalance, and the
    # single-op reads ride along for a coherent view (the lock is
    # uncontended in the common case and dict ops are short).

    def __init__(self):
        self._d: Dict[Key, bytes] = {}
        self._lock = ordered_lock("backend.memory", 50)

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def put(self, key, blob):
        with self._lock:
            self._d[key] = blob

    def delete(self, key):
        with self._lock:
            self._d.pop(key, None)

    def keys(self):
        with self._lock:
            return list(self._d.keys())

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def get_many(self, keys):
        with self._lock:
            d = self._d
            return [d.get(k) for k in keys]

    def put_many(self, items):
        with self._lock:
            self._d.update(items)


class DirectoryBackend(Backend):
    """One file per cuboid, laid out r/channel/morton.bin.

    Mirrors the paper's CATMAID re-layout (§3.3): grouping by resolution
    first keeps each directory a single access plane and bounds dirsize.

    Durability: ``put`` writes a ``.tmp`` sibling and publishes it with an
    atomic rename.  With ``fsync`` on (off by default for this bulk read
    tier) the tmp file is synced *before* the
    rename — so the published name can never point at torn or zero-length
    data — and the directory is synced *after*, so an acked write survives
    a crash.  Orphaned ``.tmp`` files from interrupted puts are swept on
    open and counted in ``swept_tmp`` (surfaced as ``PathStats.tmp_swept``).
    """

    def __init__(self, root: str, fsync: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.fsync = bool(fsync)
        self._synced_dirs: set = set()
        self.swept_tmp = self._sweep_tmp()

    def _sweep_tmp(self) -> int:
        swept = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(dirpath, fn))
                        swept += 1
        return swept

    @staticmethod
    def _sync_dir(path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _ensure_dir(self, d: str) -> None:
        if d in self._synced_dirs:
            return
        fresh = not os.path.isdir(d)
        os.makedirs(d, exist_ok=True)
        if fresh and self.fsync:
            # first creation: sync the new directory entries up to the root
            # so the r/channel tree itself survives a crash
            step = d
            while True:
                self._sync_dir(step)
                if os.path.samefile(step, self.root):
                    break
                step = os.path.dirname(step)
        self._synced_dirs.add(d)

    def _path(self, key: Key) -> str:
        r, c, m = key
        return os.path.join(self.root, str(r), str(c), f"{m:016x}.bin")

    def get(self, key):
        # EAFP: open directly instead of stat-then-open — the exists()
        # probe was a full extra syscall per cuboid on the cold path
        # (~25% of a cacheless cutout's wall time under profiling).
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None

    def put(self, key, blob):
        p = self._path(key)
        self._ensure_dir(os.path.dirname(p))
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            crashpoint("dir.put.written")
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())  # data durable BEFORE the name flips
        crashpoint("dir.put.synced")
        os.replace(tmp, p)  # atomic publish
        crashpoint("dir.put.renamed")
        if self.fsync:
            self._sync_dir(os.path.dirname(p))  # make the rename durable

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self):
        # Tolerate foreign entries anywhere in the tree (editor droppings,
        # .tmp files from interrupted puts, stray data dirs): only
        # <digits>/<digits>/<hex>.bin regular files are cuboids.
        for r in os.listdir(self.root):
            rd = os.path.join(self.root, r)
            if not r.isdigit() or not os.path.isdir(rd):
                continue
            for c in os.listdir(rd):
                cd = os.path.join(rd, c)
                if not c.isdigit() or not os.path.isdir(cd):
                    continue
                for fn in os.listdir(cd):
                    if not fn.endswith(".bin"):
                        continue
                    try:
                        m = int(fn[:-4], 16)
                    except ValueError:
                        continue
                    if not os.path.isfile(os.path.join(cd, fn)):
                        continue
                    yield (int(r), int(c), m)

    def __contains__(self, key):
        return os.path.exists(self._path(key))


def compress(arr: np.ndarray, level: int = 1) -> bytes:
    """gzip/zlib cuboid compression (paper §3.2: labels compress well).

    The codec level is a dataset property (`DatasetSpec.compress_level`,
    overridable by `CuboidStore`'s ``compression_level``); the store
    resolves it once and passes it here on every write.
    """
    return zlib.compress(np.ascontiguousarray(arr).tobytes(), level)


def decompress(blob: bytes, shape, dtype) -> np.ndarray:
    return np.frombuffer(zlib.decompress(blob), dtype=dtype).reshape(shape)


class CuboidStore:
    """Cuboid store for one dataset: lazy, compressed, path-separated.

    ``write_path_backend`` (the "SSD node") absorbs writes when attached;
    reads consult it first (freshest), then the read path. ``migrate()``
    flushes write-path contents into the read path — the paper's
    dump-and-restore migration performed when a project cools down.

    Two optional memory tiers sit in front of the paths (paper §6 vision,
    see ``repro_torch.cluster.cache``):

    * ``cache`` — a `CuboidCache` fronting the *merged* read view.  Every
      lookup is a hit or a miss; writes absorb into it, so it is never
      stale (read-your-writes).  Attach via the constructor or
      ``repro_torch.cluster.cache.attach_cache``.
    * ``write_behind`` — a `WriteBehindQueue` absorbing writes and
      applying them to the backends from a background flusher.  Reads
      consult its pending map below the cache, so data is readable the
      moment a write returns; ``flush()`` is the durability barrier.
      Attach via ``repro_torch.cluster.cache.enable_write_behind``.

    ``compression_level`` defaults to the spec's ``compress_level`` and
    ``decode_policy`` to `DecodePolicy.default`.
    """

    def __init__(self, spec: DatasetSpec,
                 backend: Optional[Backend] = None,
                 write_path_backend: Optional[Backend] = None,
                 compression_level: Optional[int] = None,
                 cache=None,
                 decode_policy: Optional[DecodePolicy] = None):
        self.spec = spec
        self.read_backend = backend or MemoryBackend()
        self.write_backend = write_path_backend
        if compression_level is None:
            compression_level = spec.compress_level
        self.compression_level = compression_level
        self.decode_policy = decode_policy or DecodePolicy.default()
        self.read_stats = PathStats()
        self.write_stats = PathStats()
        self._np_dtype = np.dtype(spec.dtype)
        self._lock = ordered_lock("store.data", 40)
        self.read_stats.tmp_swept = getattr(self.read_backend, "swept_tmp", 0)
        if self.write_backend is not None:
            self.write_stats.tmp_swept = getattr(
                self.write_backend, "swept_tmp", 0)
        # Lifetime compaction totals (log tier → read tier merges); updated
        # by core.compact, surfaced through tier_stats().
        self.compactions: Dict[str, float] = {
            "runs": 0, "segments": 0, "keys": 0, "tombstones": 0,
            "bytes": 0, "seconds": 0.0}
        self.tier_policy = None           # set by wal.tiered_store
        self._tier_tmpdir = None          # owned scratch root (tiered_store)
        self.cache = cache                # duck-typed CuboidCache | None
        self.write_behind = None          # duck-typed WriteBehindQueue | None
        self.last_prefetch_error: Optional[str] = None  # repr of newest one
        # Serializes same-key write *order* across tiers (queue/backends vs
        # cache) and guards read-absorption against concurrent writes.
        self._order_lock = ordered_lock("store.order", 30)
        self._write_gen = 0
        # Counter updates are batched per call and applied under this lock
        # so the reads == cache_hits + cache_misses invariant survives
        # concurrent clients (bare += would lose updates).
        self._stats_lock = ordered_lock("store.stats", 70)

    @property
    def has_cache(self) -> bool:
        return self.cache is not None

    @contextlib.contextmanager
    def serving(self):
        """Mark one in-flight read job against this node.

        ``read_stats.inflight`` is the instantaneous load gauge a cluster
        uses to pick the least-loaded replica for a read; the cluster wraps
        each per-node fan-out job in this so the signal tracks real
        concurrency, not accumulated history."""
        with self._stats_lock:
            self.read_stats.inflight += 1
        try:
            yield
        finally:
            with self._stats_lock:
                self.read_stats.inflight -= 1

    def flush(self) -> int:
        """Durability barrier: block until pending write-behind writes are
        applied to the backends.  Returns the number drained (0 if no
        queue is attached)."""
        if self.write_behind is None:
            return 0
        n = self.write_behind.flush()
        self.write_stats.queue_depth = self.write_behind.depth
        self.write_stats.queue_retries = self.write_behind.retried
        self.write_stats.queue_poisoned = self.write_behind.poisoned
        return n

    def close(self) -> None:
        """Flush and detach the write-behind queue (stops its flusher);
        release backend file handles (log-tier backends reopen lazily, so
        a closed store's data stays readable) and clean up a scratch root
        owned via ``wal.tiered_store``."""
        if self.write_behind is not None:
            self.write_behind.close()  # flushes; pending stays readable until drained
            self.write_behind = None
        for backend in (self.write_backend, self.read_backend):
            closer = getattr(backend, "close", None)
            if callable(closer):
                closer()
        tmpdir = self._tier_tmpdir
        if tmpdir is not None:
            self._tier_tmpdir = None
            with contextlib.suppress(OSError):
                tmpdir.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- helpers ----------------------------------------------------------
    def _cuboid_shape(self, r: int) -> Tuple[int, ...]:
        return self.spec.grid(r).cuboid_shape

    def _zeros(self, r: int) -> np.ndarray:
        return np.zeros(self._cuboid_shape(r), dtype=self._np_dtype)

    # -- the merged view below the cache -----------------------------------
    def _fetch_misses(self, keys: Sequence[Key],
                      record: bool = True) -> List[Optional[bytes]]:
        """Resolve keys below the cache: pending write-behind values first
        (freshest), then the write path, then the read path.  Maintains the
        per-path read counters (pending hits count on the read path);
        ``record=False`` skips them — background prefetches are not client
        reads and must not disturb the reads == hits + misses invariant."""
        blobs: List[Optional[bytes]] = [None] * len(keys)
        resolved = [False] * len(keys)
        pending_hits = 0
        if self.write_behind is not None:
            for i, (found, blob) in enumerate(
                    self.write_behind.peek_many(keys)):
                if found:
                    blobs[i] = blob
                    resolved[i] = True
                    pending_hits += 1
        idx = [i for i in range(len(keys)) if not resolved[i]]
        wp_reads = wp_bytes = rp_reads = rp_bytes = 0
        if idx:
            sub = [keys[i] for i in idx]
            fetched: List[Optional[bytes]] = [None] * len(sub)
            settled = [False] * len(sub)
            if self.write_backend is not None:
                # probe, not get: a log-tier tombstone is (found, None) —
                # a definitive absence that must NOT fall through to a
                # stale copy still sitting on the read tier
                for j, (found, blob) in enumerate(
                        self.write_backend.probe_many(sub)):
                    if found:
                        fetched[j] = blob
                        settled[j] = True
                        wp_reads += 1
                        wp_bytes += len(blob) if blob is not None else 0
            still = [j for j in range(len(sub)) if not settled[j]]
            if still:
                got = self.read_backend.get_many([sub[j] for j in still])
                for j, blob in zip(still, got):
                    fetched[j] = blob
                rp_reads = len(still)
                rp_bytes = sum(len(b) for b in got if b is not None)
            for i, blob in zip(idx, fetched):
                blobs[i] = blob
        if record:
            with self._stats_lock:
                self.read_stats.reads += pending_hits + rp_reads
                self.read_stats.read_bytes += rp_bytes
                self.write_stats.reads += wp_reads
                self.write_stats.read_bytes += wp_bytes
        return blobs

    def _read_gen(self) -> int:
        """Snapshot the write generation for a read-absorb guard.

        Taken under ``_order_lock`` so the snapshot can never land in the
        middle of a writer's critical section: a fetch that starts after
        this either sees the landed write or a generation bump.
        """
        with self._order_lock:
            return self._write_gen

    def _absorb_reads(self, items, gen0: int, blocks=None) -> None:
        """Populate the cache with read results — only if no write raced
        the fetch (``_write_gen`` unchanged since the ``_read_gen``
        snapshot), so a stale blob can never overwrite a fresher absorbed
        write."""
        if self.cache is None:
            return
        with self._order_lock:
            if self._write_gen != gen0:
                return
            for i, (key, blob) in enumerate(items):
                block = blocks[i] if blocks is not None else None
                if blob is not None and block is not None:
                    self.cache.put_block(key, blob, block)
                else:
                    self.cache.put(key, blob)

    def _apply_writes(self, items: Sequence[Tuple[Key, Optional[bytes]]]) -> None:
        """Land compressed writes (``None`` = lazy-zero delete) on every
        tier, in a single serialized order: write-behind queue (or the
        backends directly, under the store lock so ``migrate()`` is
        per-key atomic against us), then the cache — so after this call
        returns the write is readable (read-your-writes)."""
        with self._order_lock:
            self._write_gen += 1
            if self.write_behind is not None:
                self.write_behind.enqueue_many(items)
                self.write_stats.queue_depth = self.write_behind.depth
                self.write_stats.queue_peak = self.write_behind.depth_peak
                self.write_stats.queue_retries = self.write_behind.retried
                self.write_stats.queue_poisoned = self.write_behind.poisoned
            else:
                target = self.write_backend or self.read_backend
                # A tombstone-capable write tier shadows the read path
                # until compaction applies the delete; other targets need
                # the read-path copy cleared immediately.
                shadow = target.supports_tombstones
                puts = [(k, b) for k, b in items if b is not None]
                with self._lock:
                    for k, b in items:
                        if b is None:
                            # lazy allocation: all-zero cuboids occupy no
                            # storage on either path
                            target.delete(k)
                            if not shadow:
                                self.read_backend.delete(k)
                    if puts:
                        target.put_many(puts)
            if self.cache is not None:
                self.cache.put_many(items)

    # -- single-cuboid ops -------------------------------------------------
    def read_cuboid(self, r: int, m: int, channel: int = 0) -> np.ndarray:
        key = (r, channel, m)
        t0 = time.perf_counter()
        hit = False
        blob = None
        if self.cache is not None:
            hit, blob = self.cache.get_blob(key)
            with self._stats_lock:
                if hit:
                    self.read_stats.reads += 1
                    self.read_stats.cache_hits += 1
                else:
                    self.read_stats.cache_misses += 1
        if not hit:
            gen0 = self._read_gen()
            blob = self._fetch_misses([key])[0]
            self._absorb_reads([(key, blob)], gen0)
        if blob is None:
            out = self._zeros(r)  # lazy: absent cuboid reads as zeros
        else:
            out = decompress(blob, self._cuboid_shape(r), self._np_dtype)
        with self._stats_lock:
            self.read_stats.time_s += time.perf_counter() - t0
        return out

    def write_cuboid(self, r: int, m: int, data: np.ndarray,
                     channel: int = 0) -> None:
        if tuple(data.shape) != self._cuboid_shape(r):
            raise ValueError(
                f"cuboid shape {data.shape} != {self._cuboid_shape(r)}")
        key = (r, channel, m)
        t0 = time.perf_counter()
        if not data.any():
            blob = None  # lazy allocation: all-zero cuboids occupy no storage
        else:
            blob = compress(data.astype(self._np_dtype),
                            self.compression_level)
        self._apply_writes([(key, blob)])
        with self._stats_lock:
            self.write_stats.writes += 1
            self.write_stats.write_bytes += len(blob) if blob else 0
            self.write_stats.time_s += time.perf_counter() - t0

    def has_cuboid(self, r: int, m: int, channel: int = 0) -> bool:
        key = (r, channel, m)
        if self.cache is not None:
            hit, blob = self.cache.probe(key)
            if hit:
                return blob is not None
        if self.write_behind is not None:
            found, blob = self.write_behind.peek(key)
            if found:
                return blob is not None
        if self.write_backend is not None:
            found, blob = self.write_backend.probe(key)
            if found:
                return blob is not None  # tombstone = definitively absent
        return key in self.read_backend

    # -- run (batch/sequential) ops ----------------------------------------
    def read_run(self, r: int, start: int, stop: int,
                 channel: int = 0) -> List[np.ndarray]:
        """Read a contiguous morton run — ONE sequential pass (paper C7)."""
        blobs = self.fetch_runs(r, [(start, stop)], channel)
        shape = self._cuboid_shape(r)
        return [self._zeros(r) if blobs[m] is None
                else decompress(blobs[m], shape, self._np_dtype)
                for m in range(start, stop)]

    def fetch_runs(self, r: int, runs: Sequence[Tuple[int, int]],
                   channel: int = 0, decode: bool = False):
        """Batch-fetch compressed blobs for every cuboid in ``runs``.

        Lookup order per key: hot-cuboid cache (when attached), pending
        write-behind values (freshest), then one ``get_many`` per run per
        path — write path first, misses fall through to the read path.
        Absent cuboids come back as ``None`` (lazy zeros) and are cached as
        absences.  Returns {morton_index: blob | None}.

        ``decode=True`` switches to the pipelined cold-read mode: blobs are
        decompressed *here* (chunked across the decode pool per
        :class:`DecodePolicy`) and the result maps morton index to decoded
        block — the mode the cluster's per-node fan-out workers run so
        decompression parallelizes across nodes and cores.
        """
        if decode:
            return self.fetch_blocks(r, runs, channel)
        out: Dict[int, Optional[bytes]] = {}
        cache = self.cache
        for start, stop in runs:
            t0 = time.perf_counter()
            keys = [(r, channel, m) for m in range(start, stop)]
            blobs: List[Optional[bytes]] = [None] * len(keys)
            miss_idx = list(range(len(keys)))
            hits_n = 0
            if cache is not None:
                miss_idx = []
                for i, k in enumerate(keys):
                    hit, blob = cache.get_blob(k)
                    if hit:
                        blobs[i] = blob
                        hits_n += 1
                    else:
                        miss_idx.append(i)
            with self._stats_lock:
                self.read_stats.seeks += 1
                self.read_stats.reads += hits_n
                if cache is not None:
                    self.read_stats.cache_hits += hits_n
                    self.read_stats.cache_misses += len(miss_idx)
            if miss_idx:
                gen0 = self._read_gen()
                sub = [keys[i] for i in miss_idx]
                with trace.span("store.fetch", cuboids=len(sub)):
                    fetched = self._fetch_misses(sub)
                for i, blob in zip(miss_idx, fetched):
                    blobs[i] = blob
                self._absorb_reads(list(zip(sub, fetched)), gen0)
            with self._stats_lock:
                self.read_stats.time_s += time.perf_counter() - t0
            for m, blob in zip(range(start, stop), blobs):
                out[m] = blob
        return out

    def _fetch_decode_chunks(self, cells: Sequence[int],
                             keys: Sequence[Key], shape, dtype,
                             emit: BlockSink) -> None:
        """The chunked cold-read pipeline: fetch + decode + assemble.

        The miss set is split into chunks of ``DecodePolicy.chunk``
        cuboids; each chunk is an independent stage instance — resolve the
        blobs through the merged read view, decompress them, hand every
        block to ``emit`` from the worker that decoded it (sinks write
        disjoint buffer slices, so this is race-free), then absorb into
        the cache under the generation guard.  Chunks drain from a shared
        work list: pool workers *and the calling thread* pull from it, so
        I/O of one chunk overlaps decompression of another even on a
        single-node store, the caller is never idle, and a saturated pool
        degrades to the caller draining everything itself (no deadlock).
        """
        def run_chunk(lo: int, hi: int) -> None:
            sub = list(keys[lo:hi])
            gen0 = self._read_gen()
            with trace.span("store.fetch", cuboids=hi - lo):
                fetched = self._fetch_misses(sub)
            t0 = time.perf_counter()
            decoded: List[Optional[np.ndarray]] = []
            n_blobs = 0
            with trace.span("decode", cuboids=hi - lo) as tmeta:
                for m, blob in zip(cells[lo:hi], fetched):
                    if blob is None:
                        block = None
                    else:
                        block = decompress(blob, shape, dtype)
                        n_blobs += 1
                    decoded.append(block)
                    emit(m, block)
                if tmeta is not None:
                    tmeta["blobs"] = n_blobs
            dt = time.perf_counter() - t0
            self._absorb_reads(list(zip(sub, fetched)), gen0,
                               blocks=decoded)
            with self._stats_lock:
                self.read_stats.decoded_blocks += n_blobs
                self.read_stats.decode_s += dt

        self._drain_chunks(len(keys), run_chunk)

    def _decode_hit_blobs(self, items: Sequence[Tuple[int, Key, bytes]],
                          shape, dtype, emit: BlockSink) -> None:
        """Parallel decode for blobs that need no backend fetch — cache
        hits that are blob-only, or prefetch-handoff blobs the cache
        refused to admit: chunked across the decode pool like misses,
        memoized back onto the cache entry via ``attach_block`` (a
        silent no-op for keys that are not resident)."""
        cache = self.cache

        def run_chunk(lo: int, hi: int) -> None:
            t0 = time.perf_counter()
            with trace.span("decode", cuboids=hi - lo, source="cache"):
                for m, key, blob in items[lo:hi]:
                    block = decompress(blob, shape, dtype)
                    cache.attach_block(key, blob, block)
                    emit(m, block)
            with self._stats_lock:
                self.read_stats.decoded_blocks += hi - lo
                self.read_stats.decode_s += time.perf_counter() - t0

        self._drain_chunks(len(items), run_chunk)

    def _drain_chunks(self, n: int, run_chunk) -> None:
        """Run ``run_chunk(lo, hi)`` over ``n`` items in
        ``DecodePolicy.chunk``-sized pieces, drained from a shared work
        list by pool workers *and the calling thread* — the caller is
        never idle, and a saturated pool degrades to the caller draining
        everything itself (progress is guaranteed, no deadlock)."""
        pol = self.decode_policy
        step = max(1, pol.chunk)
        bounds = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
        if pol.workers <= 1 or len(bounds) <= 1:
            for lo, hi in bounds:
                run_chunk(lo, hi)
            return
        todo = list(reversed(bounds))  # popped back-first = schedule order
        todo_lock = ordered_lock("store.drain", 81)

        def drain() -> None:
            while True:
                with todo_lock:
                    if not todo:
                        return
                    lo, hi = todo.pop()
                run_chunk(lo, hi)

        # The caller drains too and counts toward its own budget: each
        # caller adds at most (workers - 1) pool tasks on top of itself.
        # Under concurrent callers (cluster node fan-out) the shared pool
        # still caps pooled decode at pol.workers threads process-wide;
        # the callers beyond that are the node workers themselves, which
        # IS the intended node-parallel decode.
        # Pool drains carry the caller's active trace span (bind is the
        # identity when nothing is traced), so a sampled request's decode
        # spans nest under the stage that spawned them.
        pool = _decode_pool(pol.workers)
        before_submit()
        futures = [pool.submit(trace.bind(drain))
                   for _ in range(min(pol.workers - 1, len(bounds) - 1))]
        # Always join the pool drains before returning — an exception in
        # the caller's own drain must not strand workers writing into a
        # buffer the (failed) request has already abandoned.  The work
        # list is cleared first so they stop after their current chunk;
        # the first error (caller's preferentially) is re-raised.
        error: Optional[BaseException] = None
        try:
            drain()
        except BaseException as e:
            error = e
            with todo_lock:
                todo.clear()
        for f in futures:
            try:
                f.result()
            except BaseException as e:
                if error is None:
                    error = e
        if error is not None:
            raise error

    def fetch_blocks(self, r: int, runs: Sequence[Tuple[int, int]],
                     channel: int = 0,
                     sink: Optional[BlockSink] = None
                     ) -> Dict[int, Optional[np.ndarray]]:
        """Decoded-cuboid variant of :meth:`fetch_runs` — the cutout
        engine's one read path, pipelined:

        * hot cuboids come straight from the cache (no backend I/O, no
          decompression — read-only arrays memoized by the cache);
        * misses pipeline in chunks across the shared decode pool
          (:class:`DecodePolicy`): every chunk fetches its blobs through
          the merged read view, decompresses them, and assembles from the
          worker that decoded them, with the calling thread draining
          chunks too — so one chunk's backend I/O overlaps another's
          decompression even on a single node;
        * with a cache attached, the next ``prefetch_segments`` runs of
          the schedule stream into the cache *while the current run
          decodes* (the paper's sequential-read doctrine applied to the
          memory tier).

        With ``sink`` every (morton, block) pair is handed over as soon as
        it is available — possibly from a decode worker thread (sinks must
        be race-free; the cutout engine writes disjoint output-buffer
        slices) — and the returned dict is empty.  Without it, returns
        {morton_index: ndarray | None} (None = lazy zeros).
        """
        shape = self._cuboid_shape(r)
        dtype = self._np_dtype
        cache = self.cache
        out: Dict[int, Optional[np.ndarray]] = {}
        emit: BlockSink = sink if sink is not None else out.__setitem__
        runs = list(runs)
        advance = self._prefetch_plan(r, runs, channel)
        if advance is None:
            # No prefetch landing zone / lookahead: flatten the WHOLE
            # schedule into one chunked pipeline, so short runs (a
            # fragmented box decomposes into many few-cuboid runs) still
            # fetch and decode across the pool instead of serializing at
            # run boundaries.
            t0 = time.perf_counter()
            cells: List[int] = []
            keys: List[Key] = []
            hit_blobs: List[Tuple[int, Key, bytes]] = []
            hits_n = 0
            for start, stop in runs:
                for m in range(start, stop):
                    k = (r, channel, m)
                    if cache is not None:
                        hit, blob, block = cache.peek_block(k)
                        if hit:
                            hits_n += 1
                            if blob is None or block is not None:
                                emit(m, block)
                            else:
                                hit_blobs.append((m, k, blob))
                            continue
                    cells.append(m)
                    keys.append(k)
            with self._stats_lock:
                self.read_stats.seeks += len(runs)
                self.read_stats.reads += hits_n
                if cache is not None:
                    self.read_stats.cache_hits += hits_n
                    self.read_stats.cache_misses += len(keys)
            if cache is not None:
                trace.event("cache.lookup", hits=hits_n, misses=len(keys))
            if hit_blobs:
                self._decode_hit_blobs(hit_blobs, shape, dtype, emit)
            if keys:
                self._fetch_decode_chunks(cells, keys, shape, dtype, emit)
            with self._stats_lock:
                self.read_stats.time_s += time.perf_counter() - t0
            return out
        # Segment-pipelined mode: prefetch is engaged, which implies a
        # cache is attached (advance would be None otherwise).
        for i, (start, stop) in enumerate(runs):
            t0 = time.perf_counter()  # includes any wait on the handoff
            handoff = advance(i)
            keys = [(r, channel, m) for m in range(start, stop)]
            miss_idx: List[int] = []
            hit_blobs: List[Tuple[int, Key, bytes]] = []
            hits_n = 0
            for j, k in enumerate(keys):
                hit, blob, block = cache.peek_block(k)
                if not hit:
                    miss_idx.append(j)
                    continue
                hits_n += 1
                if blob is None or block is not None:
                    emit(start + j, block)  # lazy zero / memoized
                else:
                    hit_blobs.append((start + j, k, blob))
            # Cache misses resolve from the prefetch handoff first (its
            # generation was validated in advance(); the cache is
            # consulted first above, so an absorbed fresher write always
            # wins).  Only the remainder pays a backend fetch.
            pf_pairs: List[Tuple[int, Key, bytes]] = []
            still_missing = miss_idx
            if handoff:
                still_missing = []
                for j in miss_idx:
                    blob = handoff.get(keys[j], _MISS)
                    if blob is _MISS:
                        still_missing.append(j)
                    elif blob is None:
                        emit(start + j, None)  # known absent: lazy zeros
                    else:
                        pf_pairs.append((start + j, keys[j], blob))
            n_handoff = len(miss_idx) - len(still_missing)
            with self._stats_lock:
                self.read_stats.seeks += 1
                self.read_stats.reads += hits_n + n_handoff
                self.read_stats.cache_hits += hits_n
                self.read_stats.cache_misses += len(miss_idx)
            trace.event(
                "cache.lookup", hits=hits_n, misses=len(miss_idx), handoff=n_handoff
            )
            if hit_blobs:  # decode-only work (e.g. prefetched segments)
                self._decode_hit_blobs(hit_blobs, shape, dtype, emit)
            if pf_pairs:  # handed-off blobs: decode-only work too
                self._decode_hit_blobs(pf_pairs, shape, dtype, emit)
            if still_missing:
                self._fetch_decode_chunks(
                    [start + j for j in still_missing],
                    [keys[j] for j in still_missing], shape, dtype, emit)
            with self._stats_lock:
                self.read_stats.time_s += time.perf_counter() - t0
        return out

    # -- plan-driven segment prefetch (paper §5 sequential-read doctrine) --
    def _prefetch_plan(self, r: int, runs: Sequence[Tuple[int, int]],
                       channel: int):
        """Build the schedule-lookahead callback for one planned fetch.

        Returns ``None`` when prefetch cannot engage (no cache to land
        in, lookahead disabled, or a single-run schedule) — the caller
        then flattens the schedule into one chunked pipeline instead.

        ``advance(i)`` keeps the next ``prefetch_segments`` runs after
        ``i`` in flight on the decode pool: each task pulls one future
        run's blobs through the merged read view into the hot-cuboid
        cache (admission-guarded — prefetch never evicts resident data),
        so by the time assembly reaches that run it is all cache hits.
        If run ``i`` itself is still being prefetched, the foreground
        rides that task: ``advance(i)`` waits for it and returns its
        fetched ``{key: blob}`` for direct consumption, so the
        prefetcher's I/O is never wasted even when cache admission was
        refused (budget) — the handoff that turns lookahead into a
        pipeline rather than a race.  The wait is skipped (and the
        handoff abandoned) as soon as any write lands: a generation
        check at both ends guarantees a handed-off blob can never mask
        a fresher write, and a write-heavy interleaving degrades to the
        plain foreground fetch instead of blocking on doomed lookahead.
        """
        pol = self.decode_policy
        depth = pol.prefetch_segments
        if depth <= 0 or self.cache is None or len(runs) <= 1:
            return None  # caller flattens the schedule instead
        if sum(stop - start for start, stop in runs) < 2 * max(1, pol.chunk):
            return None  # too small to amortize lookahead startup
        pool = _decode_pool(max(2, pol.workers))
        inflight: Dict[int, Tuple[int, cf.Future]] = {}

        def advance(i: int) -> Optional[Dict[Key, Optional[bytes]]]:
            gen_now = self._read_gen()
            n = 0
            before_submit()
            for j in range(i + 1, min(i + 1 + depth, len(runs))):
                if j not in inflight:
                    trace.event("prefetch.issue", run=j)
                    inflight[j] = (gen_now, pool.submit(
                        trace.bind(self._prefetch_run), r, runs[j], channel))
                    n += 1
            if n:
                with self._stats_lock:
                    self.read_stats.prefetch_issued += n
            ent = inflight.get(i)
            if ent is None:
                return None
            gen_issue, fut = ent
            if self._read_gen() != gen_issue:
                # a write landed since issue: the task's result is (or
                # will be) stale — don't wait on doomed lookahead
                fut.cancel()
                return None
            if fut.cancel():
                return None  # still queued: fetching beats waiting
            try:
                res = fut.result()
            except Exception as e:
                self._note_prefetch_error(e)
                return None
            if res is None:
                return None
            gen0, blobs = res
            if self._read_gen() != gen0:
                return None  # raced by a write mid-fetch: discard
            return blobs

        return advance

    def _prefetch_run(
        self, r: int, run: Tuple[int, int], channel: int
    ) -> Optional[Tuple[int, Dict[Key, Optional[bytes]]]]:
        """Background task: fetch one future run's blobs ahead of the
        foreground, admitting them to the cache when budget allows.

        Returns ``(gen0, {key: blob})`` so ``advance`` can hand the
        fetched blobs straight to the foreground even when the cache
        refused admission — lookahead I/O is consumed either way.
        Coherent on both tiers: keys resolve through the same merged
        view as reads (pending write-behind values first), cache
        admission is generation-guarded under the order lock, and the
        caller re-validates ``gen0`` before consuming the handoff — a
        stale blob can never mask a fresher write.  Failures never break
        the foreground read prefetch is trying to speed up: the task
        returns ``None``, but the error is *recorded* —
        ``prefetch_errors`` counts it and ``last_prefetch_error`` keeps
        the most recent repr for `GET /stats` debugging — rather than
        silently swallowed (lint L005).
        """
        try:
            cache = self.cache
            if cache is None:
                return None
            keys = [(r, channel, m) for m in range(run[0], run[1])
                    if not cache.probe((r, channel, m))[0]]
            if not keys:
                return None
            gen0 = self._read_gen()
            blobs = self._fetch_misses(keys, record=False)
            # Admission precheck gates only the CACHE population: with no
            # spare budget even for entry overheads, put_prefetched would
            # reject wholesale — skip the lock traffic, the handoff still
            # delivers the blobs to the foreground.
            spare = cache.max_bytes - cache.bytes
            if spare > getattr(cache, "entry_overhead", 0) * len(keys):
                with self._order_lock:
                    if self._write_gen == gen0:
                        admitted, _ = cache.put_prefetched(
                            list(zip(keys, blobs)))
                        if admitted:
                            with self._stats_lock:
                                self.read_stats.prefetch_cuboids += admitted
            return gen0, dict(zip(keys, blobs))
        except Exception as e:
            self._note_prefetch_error(e)
            return None

    def _note_prefetch_error(self, exc: BaseException) -> None:
        """Count a failed lookahead task (visible in stats, never fatal)."""
        with self._stats_lock:
            self.read_stats.prefetch_errors += 1
        self.last_prefetch_error = repr(exc)

    def store_cuboids(self, r: int, blocks: Dict[int, np.ndarray],
                      channel: int = 0) -> None:
        """Batch write: compress all blocks, then ONE ``put_many``.

        Keeps the single-cuboid semantics: shape-checked, all-zero cuboids
        are deleted rather than stored (lazy allocation, paper §3.2), writes
        land on the write path when attached.
        """
        shape = self._cuboid_shape(r)
        t0 = time.perf_counter()
        items: List[Tuple[Key, Optional[bytes]]] = []
        blob_bytes = 0
        for m, data in blocks.items():
            if tuple(data.shape) != shape:
                raise ValueError(f"cuboid shape {data.shape} != {shape}")
            key = (r, channel, m)
            if not data.any():
                items.append((key, None))
                continue
            blob = compress(data.astype(self._np_dtype),
                            self.compression_level)
            blob_bytes += len(blob)
            items.append((key, blob))
        if items:
            self._apply_writes(items)
        with self._stats_lock:
            self.write_stats.writes += len(items)
            self.write_stats.write_bytes += blob_bytes
            self.write_stats.time_s += time.perf_counter() - t0

    def ingest_blobs(self, items: Sequence[Tuple[Key, Optional[bytes]]]) -> None:
        """Land pre-compressed blobs on this store (``None`` = lazy-zero
        delete) — the cluster's segment-migration entry point.

        Blobs move between node shards without a decompress/re-compress
        round trip, through the same single write order as normal writes
        (write-behind queue when attached, then the cache), so a moved key
        is readable here the moment this returns (read-your-writes).
        """
        if not items:
            return
        t0 = time.perf_counter()
        self._apply_writes(list(items))
        with self._stats_lock:
            self.write_stats.writes += len(items)
            self.write_stats.write_bytes += sum(
                len(b) for _, b in items if b is not None)
            self.write_stats.time_s += time.perf_counter() - t0

    def migrate(self) -> int:
        """Flush write path into the read path (paper: SSD→DB migration).

        Pending write-behind writes are flushed first (so nothing is in
        flight), and each key moves under the store lock — a write landing
        concurrently either precedes the move (and is migrated) or follows
        it (and stays on the write path, which reads consult first); it can
        never be silently dropped between the get and the delete.
        """
        self.flush()
        if self.write_backend is None:
            return 0
        if self.write_backend.supports_tombstones:
            # log write tier: migration IS compaction — the Morton-ordered
            # merge applies tombstones too (the plain loop below would
            # leave a tombstoned key's stale read-tier copy behind)
            return int(self.compact().keys)
        n = 0
        for key in list(self.write_backend.keys()):
            with self._lock:
                blob = self.write_backend.get(key)
                if blob is None:
                    continue
                self.read_backend.put(key, blob)
                self.write_backend.delete(key)
            n += 1
        return n

    def compact(self, max_segments: Optional[int] = None):
        """Merge flushed log segments into the read tier in Morton order.

        Returns a ``core.compact.CompactionStats`` (all zeros when
        the write tier is not an append log)."""
        from .compact import compact_store  # local: compact imports us
        return compact_store(self, max_segments=max_segments)

    def tier_stats(self) -> Dict[str, object]:
        """Tier gauges for ``GET /stats``: which backend serves each path,
        lifetime compaction totals, and (log tier) segment/index gauges."""
        wb = self.write_backend
        out: Dict[str, object] = {
            "read_tier": type(self.read_backend).__name__,
            "write_tier": type(wb).__name__ if wb is not None else None,
            "compactions": dict(self.compactions),
        }
        log_stats = getattr(wb, "stats", None)
        if callable(log_stats):
            out["log"] = log_stats()
        return out

    def _live_backend_keys(self) -> set:
        """Union of backend keys minus write-tier tombstones (a tombstone
        shadows — and thus un-stores — any read-tier copy below it)."""
        keys = set(self.read_backend.keys())
        if self.write_backend is not None:
            keys |= set(self.write_backend.keys())
            tombs = getattr(self.write_backend, "tombstone_keys", None)
            if callable(tombs):
                keys -= tombs()
        return keys

    def stored_keys(self) -> List[Key]:
        self.flush()  # pending write-behind writes count as stored
        return sorted(self._live_backend_keys())

    def key_count(self) -> int:
        """Stored-key count *without* the flush barrier: pending
        write-behind puts/deletes are folded in from a queue snapshot.
        The cheap occupancy gauge topology polling wants — a monitoring
        loop must not drain the write-behind queue it is observing."""
        keys = self._live_backend_keys()
        if self.write_behind is not None:
            puts, dels = self.write_behind.pending_keys()
            keys = (keys | puts) - dels
        return len(keys)

    def storage_bytes(self) -> int:
        total = 0
        for key in self.stored_keys():
            blob = (self.write_backend.get(key)
                    if self.write_backend and key in self.write_backend
                    else self.read_backend.get(key))
            total += len(blob or b"")
        return total


# -- the device store ------------------------------------------------------

_DTYPES = {
    "uint8": torch.uint8, "int8": torch.int8, "uint16": torch.uint16,
    "int16": torch.int16, "uint32": torch.int32, "int32": torch.int32,
    "int64": torch.int64, "float32": torch.float32, "float64": torch.float64,
}

# Bytes of decoded cuboids staged on the host per load batch, and cuboids
# per write-through call (the reference's write_cutout stores in chunks of
# 64: ~16 MB of 256K-voxel uint8 cuboids).
LOAD_BYTES = 1 << 28
WRITE_CHUNK = 64


def storage_dtype(dtype: str) -> torch.dtype:
    """Device dtype that holds a spec dtype (uint32 labels -> int32)."""
    try:
        return _DTYPES[np.dtype(dtype).name]
    except KeyError:
        raise ValueError(f"unsupported dataset dtype {dtype!r}") from None


def host_view(t: torch.Tensor, dtype) -> np.ndarray:
    """The bits of a CPU tensor as a numpy array of the dataset's dtype
    (int32 rows holding uint32 labels come back as uint32)."""
    return signed_view(t).numpy().view(np.dtype(dtype))


@dataclasses.dataclass
class LoadStats:
    """Cold loads of a backed `DeviceCuboidStore` from its `CuboidStore`."""

    loads: int = 0        # fetch_blocks calls (one per staged batch)
    cuboids: int = 0      # cuboids made resident
    bytes: int = 0        # decoded bytes copied to the device
    host_s: float = 0.0   # fetch + decode into the staging tensor, wall
    waits: int = 0        # waits on another thread's load of a cuboid


class DeviceCuboidStore:
    """Packed ``(n_cells, *cuboid_shape)`` tensor per (level, channel), on
    ``device``, optionally over a host store (``backing``): a single-node
    `CuboidStore` or a `ClusterStore` of node stores, which have the same
    storage interface.

    Without a backing the packed tensors are the only copy.  With one,
    every cuboid has a resident flag: `ensure_resident` loads the cuboids
    not yet resident through ``backing.fetch_blocks`` (a cuboid the
    backing lacks stays zero and counts as resident), and `write_through`
    hands merged rows to ``backing.store_cuboids``, so a write is
    acknowledged only once the backing's write path holds it (over a
    cluster: every member of the cuboid's replica set).  A cluster's live
    rebalance moves blobs between its nodes and changes no cuboid, so the
    resident rows stay current through it.  Levels stay allocated whole;
    nothing is evicted.
    """

    def __init__(self, spec: DatasetSpec, device: DeviceLike = "cuda",
                 backing: Optional[Union[CuboidStore, "ClusterStore"]] = None):
        if backing is not None and backing.spec.dtype != spec.dtype:
            raise ValueError(f"backing holds {backing.spec.dtype}, the store "
                             f"{spec.dtype}")
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = storage_dtype(spec.dtype)
        self.backing = backing
        self.load_stats = LoadStats()
        # (start, end) CUDA events around each load's copy to the card,
        # appended while ``copy_events`` is a list (a caller's timing hook)
        self.copy_events: Optional[list] = None
        self._levels: Dict[Tuple[int, int], torch.Tensor] = {}
        self._alloc_guard = ordered_lock("device.alloc", 84)
        # Writes are read-modify-write of whole cuboids: one writer at a time.
        self.write_guard = ordered_rlock("device.write", 20)
        if hasattr(backing, "allow_submit_under"):
            # a cluster fans the write-through out to its node pool under
            # this guard; the node jobs never take it
            backing.allow_submit_under(self.write_guard)
        # Residency: a flag per cuboid, and an event per cuboid being loaded.
        # Never held across a backing call (its decode pool takes submits).
        self._resident_lock = ordered_lock("device.resident", 85)
        self._resident: Dict[Tuple[int, int], np.ndarray] = {}
        self._loading: Dict[Tuple[int, int, int], threading.Event] = {}

    def _key(self, r: int, channel: int) -> Tuple[int, int]:
        if not 0 <= r < self.spec.n_resolutions:
            raise ValueError(f"resolution {r} outside [0, "
                             f"{self.spec.n_resolutions})")
        if not 0 <= channel < self.spec.n_channels:
            raise ValueError(f"channel {channel} outside [0, "
                             f"{self.spec.n_channels})")
        return r, channel

    def peek(self, r: int, channel: int = 0) -> Optional[torch.Tensor]:
        """The packed level, or None if it was never allocated.  Over a
        backing only resident rows are current (`ensure_resident`)."""
        return self._levels.get(self._key(r, channel))

    def level(self, r: int, channel: int = 0) -> torch.Tensor:
        """The packed level, allocated zero-filled on first use."""
        key = self._key(r, channel)
        with self._alloc_guard:
            packed = self._levels.get(key)
            if packed is None:
                grid = self.spec.grid(r)
                packed = torch.zeros((grid.n_cells,) + tuple(grid.cuboid_shape),
                                     dtype=self.dtype, device=self.device)
                self._levels[key] = packed
            return packed

    def set_level(self, r: int, packed: torch.Tensor, channel: int = 0) -> None:
        """Install a whole packed level (bulk load from `carry`)."""
        if self.backing is not None:
            raise ValueError("a backed store is loaded through write_cutout/ingest, "
                             "which write through to the backing")
        key = self._key(r, channel)
        grid = self.spec.grid(r)
        want = (grid.n_cells,) + tuple(grid.cuboid_shape)
        if tuple(packed.shape) != want or packed.dtype != self.dtype:
            raise ValueError(f"level {r} must be {want} {self.dtype}, got "
                             f"{tuple(packed.shape)} {packed.dtype}")
        with self._alloc_guard:
            self._levels[key] = packed.to(self.device).contiguous()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._levels.values())

    # -- residency over the backing ----------------------------------------
    def resident_count(self, r: int, channel: int = 0) -> int:
        """Resident cuboids of (level, channel); every cuboid without a
        backing."""
        key = self._key(r, channel)
        if self.backing is None:
            return self.spec.grid(r).n_cells
        with self._resident_lock:
            flags = self._resident.get(key)
            return 0 if flags is None else int(flags.sum())

    def ensure_resident(self, r: int, channel: int, cells) -> torch.Tensor:
        """Make the cuboids ``cells`` (Morton indices) of (level, channel)
        resident and return the packed level.

        The cuboids neither resident nor being loaded are claimed under
        the residency lock, fetched and decoded outside it (pipelined on
        the backing's decode pool) into a staging tensor, pinned when the
        store is on the card, copied to the device in one copy plus an
        ``index_copy_``, and published under the lock.  A cuboid another
        thread is loading is waited for, never loaded twice; if that load
        failed, the cuboid is claimed again.
        """
        packed = self.level(r, channel)
        if self.backing is None:
            return packed
        key = self._key(r, channel)
        want = np.unique(np.asarray(cells, dtype=np.int64))
        while True:
            with self._resident_lock:
                flags = self._resident.get(key)
                if flags is None:
                    flags = self._resident[key] = np.zeros(
                        self.spec.grid(r).n_cells, dtype=bool)
                missing = want[~flags[want]]
                mine, theirs = [], set()
                done = threading.Event()
                for m in missing.tolist():
                    ev = self._loading.get((r, channel, m))
                    if ev is None:
                        self._loading[(r, channel, m)] = done
                        mine.append(m)
                    else:
                        theirs.add(ev)
                self.load_stats.waits += len(theirs)
            if not mine and not theirs:
                return packed
            if mine:
                self._load_claimed(r, channel, packed, np.asarray(mine, np.int64),
                                   flags, done)
            for ev in theirs:
                ev.wait()

    def _load_claimed(self, r: int, channel: int, packed: torch.Tensor,
                      cells: np.ndarray, flags: np.ndarray,
                      done: threading.Event) -> None:
        """Load claimed ``cells`` (ascending) in staged batches; release the
        claim (published or not) and wake the waiters."""
        loaded = 0
        try:
            grid = self.spec.grid(r)
            step = max(1, LOAD_BYTES // (grid.cuboid_voxels * packed.element_size()))
            for i in range(0, len(cells), step):
                part = cells[i:i + step]
                self._load_batch(r, channel, packed, part)
                with self._resident_lock:
                    flags[part] = True
                loaded = i + len(part)
        finally:
            with self._resident_lock:
                for m in cells.tolist():
                    self._loading.pop((r, channel, m), None)
                self.load_stats.cuboids += loaded
            done.set()

    def _load_batch(self, r: int, channel: int, packed: torch.Tensor,
                    cells: np.ndarray) -> None:
        grid = self.spec.grid(r)
        t0 = time.perf_counter()
        staging = torch.empty((len(cells),) + tuple(grid.cuboid_shape), dtype=self.dtype,
                              pin_memory=self.device.type == "cuda")
        host = host_view(staging, self.spec.dtype)
        row = {m: i for i, m in enumerate(cells.tolist())}

        def sink(m: int, block: Optional[np.ndarray]) -> None:
            # decode workers write disjoint rows: race-free
            if block is None:
                host[row[m]] = 0  # lazy cuboid: zeros, and resident
            else:
                host[row[m]] = block

        self.backing.fetch_blocks(r, morton.indices_to_runs(cells), channel, sink=sink)
        dt = time.perf_counter() - t0
        timing = self.copy_events is not None and self.device.type == "cuda"
        if timing:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        idx = torch.from_numpy(cells).to(self.device)
        rows = staging.to(self.device, non_blocking=True)
        signed_view(packed).index_copy_(0, idx, signed_view(rows))
        if timing:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.copy_events.append((start, end))
        with self._resident_lock:
            self.load_stats.loads += 1
            self.load_stats.bytes += staging.numel() * staging.element_size()
            self.load_stats.host_s += dt

    def write_through(self, r: int, channel: int, cells) -> None:
        """Hand the rows ``cells`` of (level, channel) to the backing's
        write path, in Morton order and chunks of `WRITE_CHUNK`; each call
        returns once ``backing.store_cuboids`` holds its chunk (an all-zero
        row becomes a lazy delete there).  Call under ``write_guard``,
        after the merge.  A no-op without a backing."""
        if self.backing is None:
            return
        packed = self.level(r, channel)
        cells = np.unique(np.asarray(cells, dtype=np.int64))
        for i in range(0, len(cells), WRITE_CHUNK):
            part = cells[i:i + WRITE_CHUNK]
            rows = signed_view(packed).index_select(
                0, torch.from_numpy(part).to(self.device)).cpu()
            host = host_view(rows, self.spec.dtype)
            with trace.span("write.store", cuboids=len(part)):
                self.backing.store_cuboids(
                    r, {m: host[j] for j, m in enumerate(part.tolist())}, channel)
