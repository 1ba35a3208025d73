"""Hot-cuboid caching tier + write-behind ingest queue (paper §6 vision).

The paper's §6 roadmap puts a memcached-style memory tier in front of the
disk read path and lets SSD nodes absorb bursty small writes.  This module
reproduces both halves as composable objects a `CuboidStore` (and therefore
a `ClusterStore` shard) attaches:

* :class:`CuboidCache` — a read-through LRU of *compressed* cuboid blobs
  (plus lazily-memoized decoded blocks) in front of ``fetch_runs``.  The
  LRU is keyed for **Morton-curve locality**: keys are grouped into curve
  segments of ``2**segment_bits`` consecutive cuboids and eviction drops
  whole segments, never single keys — a cutout that re-touches a region
  finds the entire neighbourhood resident or absent together.  A byte
  budget bounds resident blob + block bytes.  Absence is cached too
  (``blob is None`` entries), so a fully warm cutout performs zero backend
  I/O even over lazily-allocated volumes.  The cache is also the landing
  zone for the cold path's plan-driven segment prefetcher
  (``put_prefetched``): prefetched blobs are admitted only into spare
  budget and queue at the LRU end until a real read touches them, so one
  giant scan's lookahead can never evict the hot set.

* :class:`WriteBehindQueue` — a bounded per-node queue that absorbs cuboid
  writes and applies them to the backing store from a background flusher
  thread in batches (the SSD write path absorbing bursts while reads
  proceed uninterfered).  ``peek``/``peek_many`` give readers the pending
  (freshest) value, so the store keeps **read-your-writes** without
  waiting for the flush.  ``flush()`` is the durability barrier: when it
  returns, every previously enqueued write has been applied to the
  backend.  ``close()`` flushes and stops the flusher.

Consistency contract:

1. A write is *readable* through the owning store the moment the write
   call returns (cache absorbs it, the queue holds it pending).
2. A write is *durable in the backend* only after ``flush()`` —
   ``migrate()``, ``stored_keys()``, and ``close()`` all force this
   barrier.
3. Eviction is invisible: an evicted segment re-reads from pending writes
   first, then the backends, bit-identically.

`attach_cache` / `enable_write_behind` wire either tier onto an existing
`CuboidStore`; a `DeviceCuboidStore` over that store reads and writes
through them.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.witness import ordered_lock
from ..core.store import Key, decompress
from ..obs import trace
from ..obs.registry import REGISTRY

# Accounting overhead charged per cache entry (key tuple, links, and the
# negative entries whose blob is None but which still occupy the table).
ENTRY_OVERHEAD = 64

SegKey = Tuple[int, int, int]  # (resolution, channel, morton >> segment_bits)


@dataclasses.dataclass
class _Entry:
    """One cached cuboid: compressed blob (None = cached absence) and an
    optionally memoized decoded block (read-only ndarray)."""

    blob: Optional[bytes]
    block: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        n = ENTRY_OVERHEAD
        if self.blob is not None:
            n += len(self.blob)
        if self.block is not None:
            n += self.block.nbytes
        return n


class _Segment:
    """One curve segment's entries (the eviction unit)."""

    __slots__ = ("entries", "nbytes")

    def __init__(self):
        self.entries: Dict[Key, _Entry] = {}
        self.nbytes = 0


class CuboidCache:
    """Segment-LRU read-through cache of compressed cuboid blobs.

    ``segment_bits`` sets the locality granule: morton indexes ``m`` with
    equal ``m >> segment_bits`` (same resolution/channel) live and die
    together.  ``max_bytes`` bounds total resident bytes; when exceeded,
    least-recently-*touched* segments are dropped wholesale until the
    budget holds (the most recent segment always survives, even if it
    alone exceeds the budget — it is the working set).

    Thread-safe; all counters are monotonic except ``bytes``.
    """

    # Per-entry accounting overhead, exposed so the store's prefetch
    # admission precheck stays in sync with put_prefetched's arithmetic.
    entry_overhead = ENTRY_OVERHEAD

    def __init__(self, max_bytes: int = 64 << 20, segment_bits: int = 3):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        if segment_bits < 0:
            raise ValueError("segment_bits must be >= 0")
        self.max_bytes = int(max_bytes)
        self.segment_bits = int(segment_bits)
        self._segments: "collections.OrderedDict[SegKey, _Segment]" = collections.OrderedDict()
        self._lock = ordered_lock("cache.segments", 60)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0  # segments dropped
        self.insertions = 0
        # Prefetch admission bookkeeping: which resident keys arrived via
        # put_prefetched and have not been touched by a real read yet.
        self._prefetched: set = set()
        self.prefetch_insertions = 0
        self.prefetch_hits = 0      # reads served by a prefetched entry
        self.prefetch_rejected = 0  # admissions refused (budget guard)

    # -- internals ---------------------------------------------------------
    def _seg_key(self, key: Key) -> SegKey:
        r, c, m = key
        return (r, c, m >> self.segment_bits)

    def _touch(self, sk: SegKey) -> Optional[_Segment]:
        seg = self._segments.get(sk)
        if seg is not None:
            self._segments.move_to_end(sk)
        return seg

    def _evict_to_budget(self) -> None:
        # Evict whole LRU segments; keep at least the most recent one.
        while self.bytes > self.max_bytes and len(self._segments) > 1:
            _, seg = self._segments.popitem(last=False)
            self.bytes -= seg.nbytes
            self.evictions += 1
            if self._prefetched:
                self._prefetched.difference_update(seg.entries)

    def _store(self, key: Key, entry: _Entry) -> None:
        sk = self._seg_key(key)
        seg = self._segments.get(sk)
        if seg is None:
            seg = self._segments[sk] = _Segment()
        else:
            self._segments.move_to_end(sk)
        old = seg.entries.get(key)
        if old is not None:
            seg.nbytes -= old.nbytes
            self.bytes -= old.nbytes
        seg.entries[key] = entry
        seg.nbytes += entry.nbytes
        self.bytes += entry.nbytes
        self.insertions += 1
        self._prefetched.discard(key)  # a real write/read supersedes it
        self._evict_to_budget()

    # -- lookups -----------------------------------------------------------
    def get_blob(self, key: Key) -> Tuple[bool, Optional[bytes]]:
        """Return ``(hit, blob)``.  ``hit`` and ``blob is None`` together
        mean *cached absence* (the cuboid is a lazy zero)."""
        with self._lock:
            seg = self._touch(self._seg_key(key))
            entry = seg.entries.get(key) if seg is not None else None
            if entry is None:
                self.misses += 1
                return False, None
            self.hits += 1
            self._count_prefetch_hit(key)
            return True, entry.blob

    def _count_prefetch_hit(self, key: Key) -> None:
        """Called under the lock on every hit: a prefetched entry's first
        real read counts once and promotes it to a normal resident."""
        if key in self._prefetched:
            self._prefetched.discard(key)
            self.prefetch_hits += 1

    def probe(self, key: Key) -> Tuple[bool, Optional[bytes]]:
        """`get_blob` without touching the hit/miss counters or the LRU —
        for presence checks (``has_cuboid``) that are not reads."""
        with self._lock:
            seg = self._segments.get(self._seg_key(key))
            entry = seg.entries.get(key) if seg is not None else None
            if entry is None:
                return False, None
            return True, entry.blob

    def peek_block(self, key: Key) -> Tuple[bool, Optional[bytes], Optional[np.ndarray]]:
        """Hit lookup returning ``(hit, blob, block)`` WITHOUT decoding.

        The pipelined cold path uses this instead of :meth:`get_block` so
        blob-only hits (e.g. freshly prefetched segments) can decompress
        in parallel chunks on the decode pool rather than one-by-one in
        the calling thread; callers memoize the result via
        :meth:`attach_block`.  Counts as a normal read (hit/miss + LRU
        touch).
        """
        with self._lock:
            seg = self._touch(self._seg_key(key))
            entry = seg.entries.get(key) if seg is not None else None
            if entry is None:
                self.misses += 1
                return False, None, None
            self.hits += 1
            self._count_prefetch_hit(key)
            return True, entry.blob, entry.block

    def attach_block(self, key: Key, blob: bytes, block: np.ndarray) -> None:
        """Memoize a block decoded *outside* the cache (decode workers).

        Same guard as :meth:`get_block`'s lazy memoization: attach only if
        the entry still holds the identical blob and no block — a racing
        write or eviction silently drops the memo.  Marks ``block``
        read-only (it becomes cache-owned and shared)."""
        block.flags.writeable = False
        with self._lock:
            seg = self._segments.get(self._seg_key(key))
            entry = seg.entries.get(key) if seg is not None else None
            if entry is not None and entry.blob is blob and entry.block is None:
                entry.block = block
                seg.nbytes += block.nbytes
                self.bytes += block.nbytes
                self._evict_to_budget()

    def get_block(self, key: Key, shape, dtype) -> Tuple[bool, Optional[np.ndarray]]:
        """Blob lookup that also memoizes the decoded block on first use.

        Returned arrays are read-only views owned by the cache — callers
        copy before mutating.  The cutout engine's pipelined path uses
        :meth:`peek_block` + :meth:`attach_block` directly so blob-only
        hits decode in parallel; this is the convenience form for
        single-key callers.
        """
        hit, blob, block = self.peek_block(key)
        if not hit:
            return False, None
        if blob is None or block is not None:
            return True, block
        # decompress OUTSIDE the lock (a first-touch decode must not
        # serialize every other cache operation), then memoize — only if
        # the entry still holds the same blob (a racing write or eviction
        # drops the memo; a racing decode of the same blob is benign).
        block = decompress(blob, shape, dtype)
        self.attach_block(key, blob, block)
        return True, block

    # -- population / coherence -------------------------------------------
    def put(self, key: Key, blob: Optional[bytes]) -> None:
        """Absorb a freshly read or written blob (None = known absent)."""
        with self._lock:
            self._store(key, _Entry(blob=blob))

    def put_many(self, items: Sequence[Tuple[Key, Optional[bytes]]]) -> None:
        with self._lock:
            for key, blob in items:
                self._store(key, _Entry(blob=blob))

    def put_prefetched(self, items: Sequence[Tuple[Key, Optional[bytes]]]) -> Tuple[int, int]:
        """Admission-guarded population for the plan-driven prefetcher.

        Unlike :meth:`put_many`, prefetched blobs may **never evict**
        resident data: an item is admitted only while it fits in the spare
        budget, and a freshly created segment enters at the *LRU* end — a
        giant scan's lookahead queues behind the hot set and is the first
        thing dropped if it is never touched (first real read promotes it
        via the normal LRU touch).  Keys already resident are left alone
        (a racing read/write beat us and is at least as fresh).

        Returns ``(admitted, rejected)``.
        """
        admitted = rejected = 0
        with self._lock:
            for key, blob in items:
                sk = self._seg_key(key)
                seg = self._segments.get(sk)
                if seg is not None and key in seg.entries:
                    continue
                entry = _Entry(blob=blob)
                if self.bytes + entry.nbytes > self.max_bytes:
                    rejected += 1
                    continue
                if seg is None:
                    seg = self._segments[sk] = _Segment()
                    self._segments.move_to_end(sk, last=False)
                seg.entries[key] = entry
                seg.nbytes += entry.nbytes
                self.bytes += entry.nbytes
                self.insertions += 1
                self._prefetched.add(key)
                admitted += 1
            self.prefetch_insertions += admitted
            self.prefetch_rejected += rejected
        if admitted or rejected:
            trace.event("cache.prefetch", admitted=admitted, rejected=rejected)
        return admitted, rejected

    def put_block(self, key: Key, blob: bytes, block: np.ndarray) -> None:
        """Absorb a blob together with its decoded block."""
        if not block.flags.c_contiguous or block.flags.writeable:
            block = np.ascontiguousarray(block).copy()
        block.flags.writeable = False
        with self._lock:
            self._store(key, _Entry(blob=blob, block=block))

    def _invalidate_locked(self, key: Key) -> None:
        sk = self._seg_key(key)
        seg = self._segments.get(sk)
        entry = seg.entries.pop(key, None) if seg is not None else None
        self._prefetched.discard(key)
        if entry is not None:
            seg.nbytes -= entry.nbytes
            self.bytes -= entry.nbytes
            if not seg.entries:
                del self._segments[sk]

    def invalidate(self, key: Key) -> None:
        with self._lock:
            self._invalidate_locked(key)

    def invalidate_many(self, keys: Sequence[Key]) -> None:
        """Drop entries wholesale (segment migration moved them away);
        unlike a cached absence this frees the bytes immediately."""
        with self._lock:
            for key in keys:
                self._invalidate_locked(key)

    def invalidate_range(self, r: int, start: int, stop: int) -> None:
        """Drop every cached entry — blobs *and* cached absences, every
        channel — for morton indexes in ``[start, stop)`` at resolution
        ``r``.  This is the replica-membership invalidation: when a node
        leaves a range's replica set, any entry it cached for the range
        (including "known absent" markers) describes data it no longer
        holds, so the whole range must go, not just the keys currently
        stored."""
        if start >= stop:
            return
        with self._lock:
            span = 1 << self.segment_bits
            for sk in list(self._segments):
                seg_r, _c, seg_m = sk
                if seg_r != r:
                    continue
                base = seg_m << self.segment_bits
                if base >= stop or base + span <= start:
                    continue
                seg = self._segments[sk]
                for key in [k for k in seg.entries if start <= k[2] < stop]:
                    self._invalidate_locked(key)

    def clear(self) -> None:
        with self._lock:
            self._segments.clear()
            self._prefetched.clear()
            self.bytes = 0

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return sum(len(s.entries) for s in self._segments.values())

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    def counters(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "insertions": self.insertions,
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "segments": len(self._segments),
            "prefetch_insertions": self.prefetch_insertions,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_rejected": self.prefetch_rejected,
        }


class WriteBehindQueue:
    """Bounded write-behind queue with a background batch flusher.

    ``put_many(items)`` / ``delete(key)`` are the apply callbacks (bound to
    the owning store's backends); both run under ``apply_lock`` so flushes
    serialize with per-key ``migrate()`` and direct writes.  Enqueued
    values overwrite older pending values for the same key (last write
    wins, exactly as the backend would resolve them); ``blob=None`` means
    *delete* (lazy-zero write).

    Backpressure: ``enqueue`` blocks while ``max_items`` distinct keys are
    pending (bursts are absorbed up to the bound, then writers throttle to
    the flusher's pace — the paper's SSD saturating behaviour).

    A flush failure never stops the queue: the failed batch is retried
    per-key with capped exponential backoff while fresh writes keep
    flowing.  A key that keeps failing past ``poison_after`` attempts
    (default 8) is quarantined into a poison list (surfaced via
    ``poison_keys()`` / ``counters()`` / ``PathStats``) so one broken key
    can never wedge the barrier for everyone else; re-enqueueing a
    poisoned key gives it a fresh chance.
    """

    def __init__(
        self,
        put_many: Callable[[Sequence[Tuple[Key, bytes]]], None],
        delete: Callable[[Key], None],
        apply_lock=None,  # a Lock-shaped object (ordered or plain)
        max_items: int = 512,
        batch_items: int = 64,
        retry_backoff: float = 0.01,
        retry_cap: float = 0.25,
        poison_after: int = 8,
    ):
        if max_items <= 0 or batch_items <= 0:
            raise ValueError("max_items and batch_items must be positive")
        self._put_many = put_many
        self._delete = delete
        self._apply_lock = apply_lock if apply_lock is not None \
            else ordered_lock("wb.apply", 40)
        self.max_items = int(max_items)
        self.batch_items = int(batch_items)
        self.retry_backoff = float(retry_backoff)
        self.retry_cap = float(retry_cap)
        self.poison_after = max(1, int(poison_after))
        self._mu = threading.Condition()
        self._pending: Dict[Key, Tuple[int, Optional[bytes]]] = {}
        self._order: Deque[Key] = collections.deque()
        self._fail_counts: Dict[Key, int] = {}
        self._poison: Dict[Key, str] = {}
        self._seq = 0
        self._closed = False
        self.enqueued = 0
        self.applied = 0
        self.batches = 0
        self.depth_peak = 0
        self.flush_errors = 0
        self.retried = 0
        self.poisoned = 0
        self.last_flush_error: Optional[str] = None
        self._thread = threading.Thread(target=self._run, name="ocp-write-behind", daemon=True)
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def enqueue(self, key: Key, blob: Optional[bytes]) -> None:
        with self._mu:
            if self._closed:
                raise RuntimeError("write-behind queue is closed")
            # Backpressure on *distinct* keys: rewriting a pending key never
            # blocks (it replaces in place).
            while len(self._pending) >= self.max_items and key not in self._pending:
                self._mu.notify_all()
                self._mu.wait(0.05)
                if self._closed:  # closed while we waited for room
                    raise RuntimeError("write-behind queue is closed")
            # A rewrite of a quarantined key is a fresh chance: the new
            # value may well apply (the poison may have been transient).
            self._poison.pop(key, None)
            self._fail_counts.pop(key, None)
            self._seq += 1
            self._pending[key] = (self._seq, blob)
            self._order.append(key)
            self.enqueued += 1
            self.depth_peak = max(self.depth_peak, len(self._pending))
            self._mu.notify_all()

    def enqueue_many(self, items: Sequence[Tuple[Key, Optional[bytes]]]) -> None:
        for key, blob in items:
            self.enqueue(key, blob)

    # -- reader side (read-your-writes) ------------------------------------
    def peek(self, key: Key) -> Tuple[bool, Optional[bytes]]:
        """Freshest pending value: ``(True, blob_or_None_for_delete)``."""
        with self._mu:
            ent = self._pending.get(key)
            if ent is None:
                return False, None
            return True, ent[1]

    def peek_many(self, keys: Sequence[Key]) -> List[Tuple[bool, Optional[bytes]]]:
        with self._mu:
            out = []
            for key in keys:
                ent = self._pending.get(key)
                out.append((False, None) if ent is None else (True, ent[1]))
            return out

    @property
    def depth(self) -> int:
        return len(self._pending)

    def pending_keys(self) -> Tuple[set, set]:
        """Snapshot of pending ``(put_keys, delete_keys)`` (last write
        wins) — lets occupancy be counted without forcing a flush."""
        with self._mu:
            puts = {k for k, (_, b) in self._pending.items() if b is not None}
            dels = {k for k, (_, b) in self._pending.items() if b is None}
        return puts, dels

    # -- flusher -----------------------------------------------------------
    def _apply(self, items: List[Tuple[Key, int, Optional[bytes]]]) -> bool:
        """Apply one batch under the apply lock.  Returns False on failure
        (recorded for the poison machinery) instead of raising — the
        flusher retries; only a ``BaseException`` (interpreter teardown)
        still kills the thread, and ``flush()``'s liveness check turns
        that into a loud error."""
        try:
            t0 = time.perf_counter()
            with self._apply_lock:
                puts = [(k, b) for k, _, b in items if b is not None]
                if puts:
                    self._put_many(puts)
                for k, _, b in items:
                    if b is None:
                        self._delete(k)
            # The flusher runs outside any request's trace, so its
            # visibility is a histogram, not spans: batch apply
            # latency by size is what diagnoses a saturated queue.
            REGISTRY.histogram(
                "repro_flush_batch_seconds",
                None,
                "write-behind flusher batch apply duration",
            ).observe(time.perf_counter() - t0)
            return True
        except Exception as e:
            with self._mu:
                self.flush_errors += 1
                self.last_flush_error = repr(e)
            return False

    def _ack_locked(self, items: List[Tuple[Key, int, Optional[bytes]]]) -> None:
        for key, seq, _ in items:
            ent = self._pending.get(key)
            if ent is not None and ent[0] == seq:
                del self._pending[key]
        self.applied += len(items)
        self.batches += 1

    def _run(self) -> None:
        backoff = self.retry_backoff
        while True:
            with self._mu:
                while not self._order and not self._closed:
                    self._mu.wait(0.1)
                if not self._order and self._closed:
                    return
                batch: List[Tuple[Key, int, Optional[bytes]]] = []
                seen = set()
                while self._order and len(batch) < self.batch_items:
                    key = self._order.popleft()
                    if key in seen:
                        continue
                    ent = self._pending.get(key)
                    if ent is None:  # a later pop already applied it
                        continue
                    seen.add(key)
                    batch.append((key, ent[0], ent[1]))
            if not batch:
                continue
            if self._apply(batch):
                backoff = self.retry_backoff
                with self._mu:
                    self._ack_locked(batch)
                    self._mu.notify_all()
                continue
            # The batch failed as a unit.  Retry each entry individually so
            # one bad key can't hold the rest of the batch hostage; a key
            # that keeps failing past the threshold is quarantined.
            acked: List[Tuple[Key, int, Optional[bytes]]] = []
            for key, seq, blob in batch:
                with self._mu:
                    ent = self._pending.get(key)
                    if ent is None or ent[0] != seq:
                        continue  # superseded: the newer write has its own order entry
                if self._apply([(key, seq, blob)]):
                    acked.append((key, seq, blob))
                    with self._mu:
                        self.retried += 1
                        self._fail_counts.pop(key, None)
                    continue
                with self._mu:
                    n = self._fail_counts.get(key, 0) + 1
                    self._fail_counts[key] = n
                    if n >= self.poison_after:
                        ent = self._pending.get(key)
                        if ent is not None and ent[0] == seq:
                            del self._pending[key]
                        self._poison[key] = self.last_flush_error or "flush failed"
                        self._fail_counts.pop(key, None)
                        self.poisoned += 1
                        self._mu.notify_all()  # quarantine unblocks flush()
                    else:
                        self._order.append(key)  # requeue for the next pass
            with self._mu:
                if acked:
                    self._ack_locked(acked)
                    self._mu.notify_all()
                    backoff = self.retry_backoff
                else:
                    # Every entry in the pass failed: back off (capped
                    # exponential; a close() notify wakes the wait early).
                    if not self._closed:
                        self._mu.wait(backoff)
                    backoff = min(backoff * 2, self.retry_cap)

    # -- barriers ----------------------------------------------------------
    def flush(self, timeout: Optional[float] = None) -> int:
        """Block until every write enqueued *before this call* is applied
        (or superseded by a newer write to the same key).

        The barrier is a sequence snapshot, not queue emptiness, so it
        stays live under sustained concurrent writers: writes enqueued
        after the flush began do not extend the wait.  A write whose key
        is quarantined as poison counts as settled (it will never apply;
        the quarantine is surfaced via ``poison_keys()``/``counters()``).
        Returns the number of writes that were pending at call time.
        """
        with self._mu:
            target = self._seq
            drained = sum(1 for seq, _ in self._pending.values() if seq <= target)
            self._mu.notify_all()
            waited = 0.0
            while any(seq <= target for seq, _ in self._pending.values()):
                if not self._thread.is_alive():
                    raise RuntimeError("write-behind flusher died")
                self._mu.wait(0.05)
                waited += 0.05
                if timeout is not None and waited >= timeout:
                    raise TimeoutError(f"flush timed out with {len(self._pending)} pending")
        return drained

    def close(self) -> None:
        """Flush, then stop the flusher thread.  Idempotent."""
        with self._mu:
            if self._closed and not self._thread.is_alive():
                return
            self._closed = True
            self._mu.notify_all()
        self._thread.join(timeout=30.0)
        with self._mu:
            if self._pending:
                raise RuntimeError(f"write-behind queue closed with {len(self._pending)} pending")

    def poison_keys(self) -> Dict[Key, str]:
        """Snapshot of quarantined keys -> the error that poisoned them."""
        with self._mu:
            return dict(self._poison)

    def counters(self) -> Dict[str, int]:
        return {
            "enqueued": self.enqueued,
            "applied": self.applied,
            "batches": self.batches,
            "depth": len(self._pending),
            "depth_peak": self.depth_peak,
            "flush_errors": self.flush_errors,
            "retried": self.retried,
            "poisoned": self.poisoned,
        }


# -- store wiring ----------------------------------------------------------


def attach_cache(store, cache_or_bytes) -> CuboidCache:
    """Attach a :class:`CuboidCache` to a `CuboidStore` (read-through +
    write-absorb from then on).  Accepts a cache instance or a byte budget."""
    cache = (
        cache_or_bytes
        if isinstance(cache_or_bytes, CuboidCache)
        else CuboidCache(max_bytes=int(cache_or_bytes))
    )
    store.cache = cache
    return cache


def enable_write_behind(store, max_items: int = 512, batch_items: int = 64) -> WriteBehindQueue:
    """Attach a :class:`WriteBehindQueue` to a `CuboidStore`.

    Puts land on the store's write path (the SSD-node analogue when a
    write backend is attached); deletes clear *both* paths so a lazy-zero
    write can never resurrect stale read-path data after the flush —
    except on a tombstone-capable write tier (the append log), where the
    delete is one durable tombstone that *shadows* the read path until
    compaction applies it.  Applies run under the store lock, serializing
    with ``migrate()``.
    """
    target = store.write_backend or store.read_backend

    if target.supports_tombstones:
        _delete = target.delete
    else:
        def _delete(key: Key) -> None:
            target.delete(key)
            store.read_backend.delete(key)

    queue = WriteBehindQueue(
        put_many=target.put_many,
        delete=_delete,
        apply_lock=store._lock,
        max_items=max_items,
        batch_items=batch_items,
    )
    store.write_behind = queue
    return queue
