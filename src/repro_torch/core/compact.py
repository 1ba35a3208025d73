"""Compaction: merge sealed log segments into the read tier, Morton order.

The other half of the paper's write/read split (§4.1): writes land
sequentially on the log tier (`core.wal`); a background merge —
"migrate write-hot databases back to the disk nodes when they cool" —
moves them into the compacted `DirectoryBackend` the cold read path
streams from.  The merge is Morton-ordered (the log index sorts by
(r, c, m)), so the read tier keeps its curve-sequential layout.

Coherence: each batch copies under ``store._lock`` — the same lock the
write-behind flusher and ``migrate()`` take — with a CAS per entry
(`LogBackend.entry_value`): a key superseded mid-compaction is skipped,
its newer version belongs to a later segment.  The read-tier copy lands
*before* the index entry drops, so a concurrent read sees either the log
copy or the read-tier copy — bit-identical.  Values never change, so no
cache invalidation or write-generation bump is needed.

Crash safety rides on ordering: segments are processed and removed
strictly ascending, so the surviving log is always a suffix of history —
replay after a crash can re-apply a record already compacted (idempotent,
same bytes) but can never resurrect an older version over a newer one.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..obs import trace
from ..obs.registry import REGISTRY
from .store import CuboidStore, crashpoint
from .wal import LogBackend


@dataclasses.dataclass
class CompactionStats:
    """One compaction run's work (also accumulated on
    ``store.compactions``)."""

    segments: int = 0    # sealed segments fully merged and removed
    keys: int = 0        # index entries applied (puts + tombstones)
    tombstones: int = 0  # of which deletes
    bytes: int = 0       # payload bytes copied to the read tier
    seconds: float = 0.0

    def asdict(self):
        return dataclasses.asdict(self)


def compact_store(store: CuboidStore, max_segments: Optional[int] = None,
                  batch_keys: int = 64, seal: bool = True) -> CompactionStats:
    """Merge flushed log segments into the read tier; returns run stats.

    A no-op (all-zero stats) when the write tier is not a `LogBackend`.
    ``seal=True`` rotates the active segment first so everything flushed
    so far is compactable; ``max_segments`` bounds one run's work (the
    background compactor trickles, an explicit call drains).
    """
    stats = CompactionStats()
    log = store.write_backend
    if not isinstance(log, LogBackend):
        return stats
    t0 = time.perf_counter()
    if seal:
        log.seal_active()
    segments = log.sealed_segments()
    if max_segments is not None:
        segments = segments[:max_segments]
    for seg in segments:
        with trace.span("compact.segment", segment=seg):
            entries = log.segment_entries(seg)  # Morton-sorted
            for i in range(0, len(entries), batch_keys):
                batch = entries[i:i + batch_keys]
                # store._lock (rank 40, "store.data") serializes us with
                # the flusher's applies and with migrate() — per-key
                # atomic against every writer.  The nested read-tier and
                # WAL acquisitions below rank higher (50), so the
                # compactor thread stays inside the witnessed order.
                with store._lock:
                    drop = []
                    for key, loc in batch:
                        current, blob = log.entry_value(key, loc)
                        if not current:
                            continue  # superseded: a later segment owns it
                        if blob is None:
                            store.read_backend.delete(key)  # tombstone
                            stats.tombstones += 1
                        else:
                            store.read_backend.put(key, blob)
                            stats.bytes += len(blob)
                        stats.keys += 1
                        drop.append((key, loc))
                    crashpoint("compact.copied")
                    # read-tier copy is live; NOW stop shadowing it
                    log.drop_entries(drop)
            removed = log.remove_segment(seg)
            crashpoint("compact.segment-removed")
        if removed:
            stats.segments += 1
    stats.seconds = time.perf_counter() - t0
    REGISTRY.histogram(
        "repro_compaction_seconds", None,
        "log-to-read-tier compaction run duration",
    ).observe(stats.seconds)
    totals = store.compactions
    totals["runs"] += 1
    totals["segments"] += stats.segments
    totals["keys"] += stats.keys
    totals["tombstones"] += stats.tombstones
    totals["bytes"] += stats.bytes
    totals["seconds"] += stats.seconds
    return stats


class Compactor:
    """Background compactor for one store.

    Wakes every ``interval`` seconds (or on :meth:`poke`) and runs
    :func:`compact_store` when the log holds at least ``min_sealed``
    sealed segments, or when total log bytes exceed ``max_log_bytes``
    (then the active segment is sealed so the backlog can drain).
    ``step()`` runs one deterministic tick without the thread — the shape
    tests and the storage supervisor drive directly.
    """

    def __init__(self, store: CuboidStore, interval: float = 0.25,
                 min_sealed: int = 1,
                 max_log_bytes: Optional[int] = None):
        self.store = store
        self.interval = interval
        self.min_sealed = min_sealed
        self.max_log_bytes = max_log_bytes
        self.runs = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _pressure(self) -> bool:
        log = self.store.write_backend
        if not isinstance(log, LogBackend):
            return False
        s = log.stats()
        if s["sealed"] >= self.min_sealed:
            return True
        return (self.max_log_bytes is not None
                and s["log_bytes"] > self.max_log_bytes)

    def step(self) -> CompactionStats:
        """One tick: compact if there is pressure, else all-zero stats."""
        if not self._pressure():
            return CompactionStats()
        self.runs += 1
        return compact_store(self.store)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._wake.wait(self.interval)
                self._wake.clear()
                if self._stop.is_set():
                    return
                self.step()

        self._thread = threading.Thread(
            target=loop, name="ocp-compactor", daemon=True)
        self._thread.start()

    def poke(self) -> None:
        """Wake the background thread now (e.g. after a burst of writes)."""
        self._wake.set()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
