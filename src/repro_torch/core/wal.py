"""Append-log write tier: sequential segments + an in-memory index.

The paper's I/O split sends "small random writes to solid-state storage"
while reads stream from the disk arrays (§4.1, Fig 13).  This module is
the write half of that split as an LSM-for-cuboids: `LogBackend` turns a
batch of cuboid writes into ONE sequential append (plus at most one
fsync), keyed by an in-memory ``key -> (segment, offset)`` index that is
rebuilt by scanning the segments on open.  Deletes append *tombstones* —
kept in the index so they shadow older read-tier data until compaction
(`core.compact`) merges sealed segments into the compacted
`DirectoryBackend` in Morton order.

Record format (little-endian), one per cuboid::

    MAGIC 'OCWL' | r u32 | c u32 | m u64 | length i64 | crc u32 | payload

``length == -1`` marks a tombstone (no payload).  ``crc`` covers the
header prefix and the payload, so recovery can detect a torn tail —
a partially-written final record is truncated away, never served.

`TierPolicy` is the pluggable-backend seam: it names which `Backend`
serves each path (``write_tier="log"|"dir"|"none"``) and builds the
pair; `tiered_store` wires a `CuboidStore` on top of it.  The segment
format is the reference's, byte for byte: either package opens the
other's directories.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import struct
import tempfile
import threading
import zlib
from typing import BinaryIO, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from ..analysis.witness import ordered_rlock
from .cuboid import DatasetSpec
from .store import (
    Backend,
    CuboidStore,
    DirectoryBackend,
    Key,
    crashpoint,
)

MAGIC = b"OCWL"
_FIELDS = struct.Struct("<IIQq")  # r, c, m, payload length (-1 = tombstone)
_CRC = struct.Struct("<I")
HEADER_BYTES = len(MAGIC) + _FIELDS.size + _CRC.size

_SEGMENT_RE = re.compile(r"^(\d{8})\.log$")

TOMBSTONE = -1


class _Loc(NamedTuple):
    """Where a key's newest record lives: payload offset within a segment.

    ``length == TOMBSTONE`` marks a delete; the entry stays in the index
    (shadowing lower tiers) until compaction applies it."""

    seg: int
    offset: int
    length: int


def _encode(key: Key, blob: Optional[bytes]) -> bytes:
    r, c, m = key
    payload = blob if blob is not None else b""
    length = len(payload) if blob is not None else TOMBSTONE
    head = MAGIC + _FIELDS.pack(r, c, m, length)
    crc = zlib.crc32(payload, zlib.crc32(head))
    return head + _CRC.pack(crc) + payload


class LogBackend(Backend):
    """Append-only segmented log with an in-memory key index.

    * ``put_many`` concatenates records into ONE sequential write on the
      active segment (and one fsync when enabled) — the SSD-node write
      path, O(1) syscalls per flush batch instead of per cuboid.
    * ``delete`` appends a tombstone; the index keeps it so lookups see a
      definitive absence (``probe -> (True, None)``) instead of falling
      through to a stale compacted copy.
    * Open scans segments in sequence order to rebuild the index; a torn
      tail (short record, bad magic, or crc mismatch — a crash mid-append)
      is truncated at the last whole record and counted in
      ``torn_truncated``.  Replay is idempotent: later records simply
      re-point the index.
    * The active segment rotates at ``segment_bytes``; sealed segments are
      immutable and are what the compactor merges and removes.

    All index and file access is serialized by one lock — this tier only
    sees flusher batches and the rare read that misses both the cache and
    the pending-write map, so contention is not the bottleneck; crash
    consistency is.
    """

    supports_tombstones = True

    def __init__(self, root: str, segment_bytes: int = 4 << 20,
                 fsync: bool = True):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # the write tier defaults to durable: it is the ack boundary
        self.fsync = bool(fsync)
        self.segment_bytes = int(segment_bytes)
        self._lock = ordered_rlock("wal.log", 50)
        self._index: Dict[Key, _Loc] = {}
        self._seg_refs: Dict[int, int] = {}   # index entries per segment
        self._sizes: Dict[int, int] = {}      # bytes per segment
        self._read_fds: Dict[int, int] = {}
        self._append_f: Optional[BinaryIO] = None
        self._active: int = 0
        self.torn_truncated = 0
        self.appends = 0
        self.syncs = 0
        self._recover()

    # -- recovery -----------------------------------------------------------
    def _segment_path(self, seg: int) -> str:
        return os.path.join(self.root, f"{seg:08d}.log")

    def _recover(self) -> None:
        segs = sorted(
            int(m.group(1))
            for m in (_SEGMENT_RE.match(fn) for fn in os.listdir(self.root))
            if m is not None
        )
        for seg in segs:
            self._sizes[seg] = self._scan_segment(seg)
        self._active = segs[-1] if segs else 1
        self._sizes.setdefault(self._active, 0)

    def _scan_segment(self, seg: int) -> int:
        """Replay one segment into the index; truncate a torn tail.

        Returns the post-truncation size.  Records replay in append order,
        so the newest version of a key wins — exactly the write order the
        flusher applied."""
        path = self._segment_path(seg)
        good = 0
        with open(path, "rb") as f:
            while True:
                head = f.read(HEADER_BYTES)
                if not head:
                    break
                if len(head) < HEADER_BYTES or head[:4] != MAGIC:
                    break  # torn/garbage tail
                r, c, m, length = _FIELDS.unpack(head[4:4 + _FIELDS.size])
                (crc,) = _CRC.unpack(head[4 + _FIELDS.size:])
                if length < TOMBSTONE:
                    break
                payload = f.read(length) if length > 0 else b""
                if length > 0 and len(payload) < length:
                    break  # crashed mid-payload
                if zlib.crc32(payload, zlib.crc32(head[:-_CRC.size])) != crc:
                    break  # bit-rot or an unsynced partial overwrite
                self._set_loc(
                    (r, c, m),
                    _Loc(seg, good + HEADER_BYTES, length))
                good += HEADER_BYTES + max(length, 0)
        if good < os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(good)
            self.torn_truncated += 1
        return good

    def _set_loc(self, key: Key, loc: _Loc) -> None:
        old = self._index.get(key)
        if old is not None:
            self._seg_refs[old.seg] -= 1
        self._index[key] = loc
        self._seg_refs[loc.seg] = self._seg_refs.get(loc.seg, 0) + 1

    # -- append path --------------------------------------------------------
    def _active_file(self) -> BinaryIO:
        if self._append_f is None or self._append_f.closed:
            # unbuffered append: bytes reach the page cache immediately, so
            # a pread on the same segment sees them without a flush
            self._append_f = open(
                self._segment_path(self._active), "ab", buffering=0)
        return self._append_f

    def _rotate(self) -> None:
        if self._append_f is not None and not self._append_f.closed:
            self._append_f.close()
        self._append_f = None
        self._active += 1
        self._sizes[self._active] = 0
        open(self._segment_path(self._active), "ab").close()
        if self.fsync:
            self._sync_root()

    def _sync_root(self) -> None:
        fd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _append(self, items: Sequence[Tuple[Key, Optional[bytes]]]) -> None:
        with self._lock:
            f = self._active_file()
            base = self._sizes[self._active]
            buf = bytearray()
            locs: List[Tuple[Key, _Loc]] = []
            for key, blob in items:
                rec = _encode(key, blob)
                offset = base + len(buf) + HEADER_BYTES
                length = len(blob) if blob is not None else TOMBSTONE
                locs.append((key, _Loc(self._active, offset, length)))
                buf += rec
            f.write(bytes(buf))
            crashpoint("wal.append.written")
            if self.fsync:
                os.fsync(f.fileno())
                self.syncs += 1
            crashpoint("wal.append.synced")
            # index only after the bytes are durable: an unsynced append
            # is not acked, and recovery replays whatever did survive
            self._sizes[self._active] = base + len(buf)
            for key, loc in locs:
                self._set_loc(key, loc)
            self.appends += len(items)
            if self._sizes[self._active] >= self.segment_bytes:
                self._rotate()

    def put(self, key, blob):
        self._append([(key, blob)])

    def put_many(self, items):
        if items:
            self._append(list(items))

    def delete(self, key):
        self._append([(key, None)])  # tombstone

    # -- lookup path --------------------------------------------------------
    def _read_fd(self, seg: int) -> int:
        fd = self._read_fds.get(seg)
        if fd is None:
            fd = os.open(self._segment_path(seg), os.O_RDONLY)
            self._read_fds[seg] = fd
        return fd

    def _read_loc(self, loc: _Loc) -> bytes:
        data = os.pread(self._read_fd(loc.seg), loc.length, loc.offset)
        if len(data) != loc.length:
            raise IOError(
                f"short log read: segment {loc.seg} offset {loc.offset} "
                f"wanted {loc.length} got {len(data)}")
        return data

    def get(self, key):
        with self._lock:
            loc = self._index.get(key)
            if loc is None or loc.length == TOMBSTONE:
                return None
            return self._read_loc(loc)

    def get_many(self, keys):
        with self._lock:
            return [
                None if (loc := self._index.get(k)) is None
                or loc.length == TOMBSTONE
                else self._read_loc(loc)
                for k in keys
            ]

    def probe(self, key):
        with self._lock:
            loc = self._index.get(key)
            if loc is None:
                return False, None
            if loc.length == TOMBSTONE:
                return True, None  # definitive absence — shadow lower tiers
            return True, self._read_loc(loc)

    def probe_many(self, keys):
        with self._lock:
            return [
                (False, None) if (loc := self._index.get(k)) is None
                else (True, None) if loc.length == TOMBSTONE
                else (True, self._read_loc(loc))
                for k in keys
            ]

    def __contains__(self, key):
        with self._lock:
            loc = self._index.get(key)
            return loc is not None and loc.length != TOMBSTONE

    def keys(self):
        with self._lock:
            return [k for k, loc in self._index.items()
                    if loc.length != TOMBSTONE]

    def tombstone_keys(self) -> Set[Key]:
        with self._lock:
            return {k for k, loc in self._index.items()
                    if loc.length == TOMBSTONE}

    # -- compaction interface ----------------------------------------------
    def seal_active(self) -> None:
        """Rotate a non-empty active segment so its records become
        compactable (sealed segments are immutable)."""
        with self._lock:
            if self._sizes.get(self._active, 0) > 0:
                if self.fsync and self._append_f is not None \
                        and not self._append_f.closed:
                    os.fsync(self._append_f.fileno())
                    self.syncs += 1
                self._rotate()

    def sealed_segments(self) -> List[int]:
        """Ascending — compaction MUST process (and remove) in this order
        so the surviving log is always a suffix: replay after a crash can
        then never resurrect an older version over a compacted newer one."""
        with self._lock:
            return sorted(s for s in self._sizes if s != self._active)

    def segment_entries(self, seg: int) -> List[Tuple[Key, _Loc]]:
        """Index entries currently pointing into ``seg``, Morton-sorted
        (key order (r, c, m) == curve order within each channel plane)."""
        with self._lock:
            return sorted(
                (k, loc) for k, loc in self._index.items() if loc.seg == seg)

    def entry_value(self, key: Key, loc: _Loc
                    ) -> Tuple[bool, Optional[bytes]]:
        """CAS read for the compactor: ``(still_current, blob)``.

        ``still_current`` is False when the index has moved past ``loc``
        (a newer write superseded it mid-compaction) — the caller must
        skip the entry, a later segment owns the key now."""
        with self._lock:
            if self._index.get(key) != loc:
                return False, None
            if loc.length == TOMBSTONE:
                return True, None
            return True, self._read_loc(loc)

    def drop_entries(self, pairs: Sequence[Tuple[Key, _Loc]]) -> int:
        """Remove index entries that still match (CAS) — after their
        values landed on the read tier.  Returns how many dropped."""
        n = 0
        with self._lock:
            for key, loc in pairs:
                if self._index.get(key) == loc:
                    del self._index[key]
                    self._seg_refs[loc.seg] -= 1
                    n += 1
        return n

    def remove_segment(self, seg: int) -> bool:
        """Unlink a fully-compacted sealed segment (no index refs left)."""
        with self._lock:
            if seg == self._active or self._seg_refs.get(seg, 0) > 0:
                return False
            fd = self._read_fds.pop(seg, None)
            if fd is not None:
                os.close(fd)
            with contextlib.suppress(FileNotFoundError):
                os.remove(self._segment_path(seg))
            self._sizes.pop(seg, None)
            self._seg_refs.pop(seg, None)
            if self.fsync:
                self._sync_root()
            return True

    # -- gauges / lifecycle -------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            live = sum(1 for loc in self._index.values()
                       if loc.length != TOMBSTONE)
            return {
                "segments": len(self._sizes),
                "sealed": len(self._sizes) - 1,
                "active_bytes": self._sizes.get(self._active, 0),
                "log_bytes": sum(self._sizes.values()),
                "live_keys": live,
                "tombstones": len(self._index) - live,
                "appends": self.appends,
                "syncs": self.syncs,
                "torn_truncated": self.torn_truncated,
            }

    def close(self) -> None:
        """Release file handles.  Safe to keep using the backend — the
        append handle and read fds reopen lazily."""
        with self._lock:
            if self._append_f is not None and not self._append_f.closed:
                if self.fsync:
                    os.fsync(self._append_f.fileno())
                self._append_f.close()
            self._append_f = None
            for fd in self._read_fds.values():
                os.close(fd)
            self._read_fds.clear()


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Which `Backend` serves each I/O path — the pluggable-backend seam.

    ``write_tier``: ``"log"`` (append-log segments, the paper's SSD write
    node), ``"dir"`` (a second `DirectoryBackend`), or ``"none"`` (single
    shared backend, no separation).  ``fsync`` is ON for the write tier
    by default — it is the ack boundary — and always off for the
    compacted read tier, whose writes re-derive from the log.
    """

    write_tier: str = "dir"
    fsync: bool = True
    segment_bytes: int = 4 << 20

    def __post_init__(self):
        if self.write_tier not in ("log", "dir", "none"):
            raise ValueError(
                f"write_tier must be log|dir|none, got {self.write_tier!r}")

    def build(self, root: str) -> Tuple[Backend, Optional[Backend]]:
        """Materialize ``(read_backend, write_backend | None)`` under
        ``root`` (``read/`` and ``wal/`` or ``write/`` subtrees)."""
        read = DirectoryBackend(os.path.join(root, "read"), fsync=False)
        fsync = self.fsync
        if self.write_tier == "log":
            return read, LogBackend(
                os.path.join(root, "wal"),
                segment_bytes=self.segment_bytes, fsync=fsync)
        if self.write_tier == "dir":
            return read, DirectoryBackend(
                os.path.join(root, "write"), fsync=fsync)
        return read, None


def tiered_store(spec: DatasetSpec, root: Optional[str] = None,
                 policy: Optional[TierPolicy] = None, **kwargs) -> CuboidStore:
    """Build a `CuboidStore` with `TierPolicy`-wired backends.

    ``root=None`` creates a temp directory the store owns: ``close()``
    removes it.  ``policy`` defaults to `TierPolicy()`.  Extra kwargs pass
    through to `CuboidStore`.
    """
    policy = policy or TierPolicy()
    tmpdir = None
    if root is None:
        tmpdir = tempfile.TemporaryDirectory(prefix="ocp-tier-")
        root = tmpdir.name
    read, write = policy.build(root)
    store = CuboidStore(
        spec, backend=read, write_path_backend=write, **kwargs)
    store.tier_policy = policy
    store._tier_tmpdir = tmpdir
    return store
