"""Runtime lock-order witness (deadlock detector for the test suite).

Every long-lived lock of the port's storage stack is created through
`ordered_lock` / `ordered_rlock` with a **name** and a **rank**.  Until
`enable()` is called the factories return plain ``threading.Lock`` /
``threading.RLock`` objects — zero overhead, the wrapper class is never
instantiated; locks made before the call stay plain.  After it, every
acquire is checked against the per-thread held stack and recorded into a
shared acquisition graph:

* **rank violation** — acquiring a lock whose rank is *lower* than the
  highest-ranked lock already held.  The global order (rank ascending)
  is the order the code is allowed to nest in; see `RANKS`.
* **cycle** — a new edge ``A -> B`` in the acquisition graph closes a
  cycle (the classic ABBA shape between equal-rank locks, e.g. two
  node-store locks).  Reported with the stack that first recorded the
  reverse path and the stack of the closing acquisition.
* **submit while locked** — `before_submit()` is called at every
  thread-pool ``submit`` site; holding a ranked lock across a submit is
  a deadlock hazard when the pool is saturated (a nested submit can
  wait on the pool it occupies).  Sites where the submitted work
  provably never takes the held lock pass it via ``allow=``.

Cost when enabled: the hot path is one dict lookup (known edge) plus a
scan of the held stack (depth <= 4 in this tree).  Stacks are captured
only the first time an edge is seen and when a violation is recorded.

The global rank order (must match the `ordered_lock` call sites):

====  ======================  ==================================
rank  name                    lock
====  ======================  ==================================
 10   cluster.admin           ``ClusterStore._admin_lock``
 20   cluster.move            ``ClusterStore._move_lock``
 20   device.write            ``DeviceCuboidStore.write_guard``
                              (held over a write's merge and its
                              write-through to the backing store;
                              a cluster backing fans it out to its
                              node pool, which never takes it:
                              ``ClusterStore.allow_submit_under``)
 22   cluster.health          ``ClusterStore._health_lock``
 24   cluster.repair          ``ClusterStore._repair_lock``
 30   store.order             ``CuboidStore._order_lock``
 40   store.data              ``CuboidStore._lock`` (also the
                              write-behind apply lock)
 50   wal.log                 ``LogBackend._lock``
 50   backend.memory          ``MemoryBackend._lock``
 60   cache.segments          ``CuboidCache._lock``
 65   frontdoor.coalesce      ``_CutoutCoalescer._lock``
 70   store.stats             ``CuboidStore._stats_lock``
 75   cluster.heat            ``ClusterStore._heat_lock``
 76   cluster.batch           ``ClusterStore._batch_lock``
 80   store.decode_pools      ``_DECODE_POOLS_LOCK``
 81   store.drain             cold-read drain ``todo_lock``
 84   device.alloc            ``DeviceCuboidStore._alloc_guard``
 85   device.resident         ``DeviceCuboidStore._resident_lock``
                              (never held across a backing-store call)
 90   obs.ring                ``SpanRing._lock``
 91   obs.registry            ``Registry._lock``
 92   obs.hist                ``Histogram._lock``
 93   obs.log                 ``obs.log._handler_lock``
====  ======================  ==================================

Conditions (`_OpGate._cond`, the write-behind queue's ``_mu``) stay raw
``threading.Condition`` objects: they are leaves that wrap their own
private mutex and are never held across another ranked acquire.
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, Iterable, List, Optional, Set, Tuple

ENABLED = False


def enable(on: bool = True) -> None:
    """Turn the witness on (or off) for locks made from now on."""
    global ENABLED
    ENABLED = bool(on)


class Violation:
    """One recorded lock-discipline violation (kept cheap to build)."""

    __slots__ = ("kind", "message", "stack", "other_stack")

    def __init__(self, kind: str, message: str, stack: str, other_stack: str = ""):
        self.kind = kind  # "order" | "cycle" | "submit"
        self.message = message
        self.stack = stack
        self.other_stack = other_stack

    def format(self) -> str:
        out = [f"[{self.kind}] {self.message}", "--- acquiring stack ---", self.stack]
        if self.other_stack:
            out += ["--- prior (first-edge) stack ---", self.other_stack]
        return "\n".join(out)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Violation({self.kind!r}, {self.message!r})"


def _stack() -> str:
    return "".join(traceback.format_stack(limit=18)[:-2])


class Witness:
    """Shared acquisition graph + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()
        # thread ident -> [[lock, count], ...] in acquisition order
        self._held: Dict[int, List[list]] = {}
        # (id(a), id(b)) -> stack captured when the edge was first seen
        self._edges: Dict[Tuple[int, int], str] = {}
        self._succ: Dict[int, Set[int]] = {}
        self._names: Dict[int, Tuple[str, int]] = {}
        # Edge endpoints are keyed by id(); pin the lock objects so a
        # dead lock's id is never recycled into a phantom graph node
        # (id reuse after gc would fabricate cycles across tests).
        self._pinned: Dict[int, object] = {}
        self._violations: List[Violation] = []

    # -- acquisition hooks -------------------------------------------------

    def note_attempt(self, lock) -> None:
        """Check (and record) the edge *before* blocking on the acquire."""
        held = self._held.get(threading.get_ident())
        if not held:
            return
        for entry in held:
            if entry[0] is lock:  # RLock re-entry: no new edge
                return
        prev = held[-1][0]
        key = (id(prev), id(lock))
        if key in self._edges:  # fast path: edge already checked once
            return
        with self._mu:
            if key in self._edges:
                return
            stack = _stack()
            self._edges[key] = stack
            self._pinned[id(prev)] = prev
            self._pinned[id(lock)] = lock
            self._names[id(prev)] = (prev.name, prev.rank)
            self._names[id(lock)] = (lock.name, lock.rank)
            self._succ.setdefault(id(prev), set()).add(id(lock))
            top_rank = max(e[0].rank for e in held)
            if lock.rank < top_rank:
                holder = max(held, key=lambda e: e[0].rank)[0]
                rev = self._edges.get((id(lock), id(prev)), "")
                self._violations.append(Violation(
                    "order",
                    f"acquired {lock.name!r} (rank {lock.rank}) while holding "
                    f"{holder.name!r} (rank {holder.rank}); ranks must ascend",
                    stack, rev))
            elif self._path_exists(id(lock), id(prev)):
                self._violations.append(Violation(
                    "cycle",
                    f"edge {prev.name!r} -> {lock.name!r} closes a cycle in the "
                    f"acquisition graph (potential deadlock)",
                    stack, self._edges.get((id(lock), id(prev)), "")))

    def note_acquired(self, lock) -> None:
        ident = threading.get_ident()
        held = self._held.get(ident)
        if held is None:
            held = self._held[ident] = []
        for entry in held:
            if entry[0] is lock:
                entry[1] += 1
                return
        held.append([lock, 1])

    def note_released(self, lock) -> None:
        ident = threading.get_ident()
        held = self._held.get(ident)
        if not held:
            return
        for entry in reversed(held):
            if entry[0] is lock:
                entry[1] -= 1
                if entry[1] == 0:
                    held.remove(entry)
                break
        if not held:
            self._held.pop(ident, None)

    def before_submit(self, allow: Iterable = ()) -> None:
        """Flag a thread-pool submit issued while ranked locks are held."""
        held = self._held.get(threading.get_ident())
        if not held:
            return
        allowed = {id(a) for a in allow}
        bad = [e[0] for e in held if id(e[0]) not in allowed]
        if not bad:
            return
        names = ", ".join(f"{l.name!r} (rank {l.rank})" for l in bad)
        with self._mu:
            self._violations.append(Violation(
                "submit",
                f"pool submit while holding {names}: deadlock hazard if the "
                f"pool's work needs the same lock",
                _stack()))

    # -- graph -------------------------------------------------------------

    def _path_exists(self, src: int, dst: int) -> bool:
        """DFS over the acquisition graph; caller holds ``self._mu``."""
        stack, seen = [src], set()
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._succ.get(node, ()))
        return False

    # -- inspection --------------------------------------------------------

    def take_violations(self) -> List[Violation]:
        with self._mu:
            out, self._violations = self._violations, []
        return out

    def held_snapshot(self) -> Dict[int, List[Tuple[str, int, int]]]:
        """{thread ident: [(name, rank, depth)]} for every tracked thread."""
        out = {}
        for ident, held in list(self._held.items()):
            entries = [(e[0].name, e[0].rank, e[1]) for e in list(held)]
            if entries:
                out[ident] = entries
        return out


GLOBAL = Witness()


class OrderedLock:
    """A named, ranked ``threading.Lock`` reporting into a `Witness`."""

    __slots__ = ("name", "rank", "_lock", "_witness")
    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str, rank: int, witness: Optional[Witness] = None):
        self.name = name
        self.rank = rank
        self._lock = self._factory()
        self._witness = witness if witness is not None else GLOBAL

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._witness.note_attempt(self)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._witness.note_acquired(self)
        return got

    def release(self) -> None:
        self._lock.release()
        self._witness.note_released(self)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}({self.name!r}, rank={self.rank})"


class OrderedRLock(OrderedLock):
    """Re-entrant variant; same-thread re-entry records no edge."""

    __slots__ = ()
    _factory = staticmethod(threading.RLock)


def ordered_lock(name: str, rank: int):
    """A ranked Lock when the witness is on, a plain Lock otherwise."""
    if not ENABLED:
        return threading.Lock()
    return OrderedLock(name, rank)


def ordered_rlock(name: str, rank: int):
    """A ranked RLock when the witness is on, a plain RLock otherwise."""
    if not ENABLED:
        return threading.RLock()
    return OrderedRLock(name, rank)


def before_submit(allow: Iterable = ()) -> None:
    """Call at every pool ``submit`` site; no-op when the witness is off.

    ``allow`` lists held locks that are safe to hold across this submit
    (the submitted work is known never to acquire them).
    """
    if ENABLED:
        GLOBAL.before_submit(allow)
