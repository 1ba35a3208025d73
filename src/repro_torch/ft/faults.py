"""Deterministic, seeded fault injection at the cluster's node boundary
(`repro.ft.faults`).

The cluster's fault-tolerance story (the health machine, quorum writes,
failover: `repro_torch.cluster.store`) is trusted only once it has been
driven with faults that repeat under a seed.  This module is that harness:

* :class:`FaultPlan`: one node's fault policy.  A seeded probability of
  injected errors and hangs, a fixed added latency, an explicit per-op
  schedule, and a crash switch (``crash()`` makes every later op raise
  :class:`NodeCrashed` at once, the network-partition model, until
  ``restart()``; the node's data survives, as a process restarting over
  durable storage keeps it).
* :class:`FaultyNode`: a transparent proxy around a `CuboidStore` shard.
  Data-plane ops (reads, writes, the health probe) consult the plan before
  they delegate; everything else (stats, admin, the migration plumbing)
  passes straight through, so the cluster's own machinery keeps working
  while its data path misbehaves.
* :func:`faulty_factory`: a node factory for `ClusterStore` that wraps
  chosen shards in faulty proxies.  Node ``i`` draws from ``seed + i``, so
  a whole chaos run replays from one number.
* :func:`crash_schedule_hook`: composes the harness with the storage
  tier's ``set_crash_hook`` points: a hook that errors on the N-th hit of
  a named crash point, so a chaos walk can also tear the durable-put path
  mid-write.

Faults injected here raise :class:`FaultInjected` (or sleep); they never
corrupt stored data.  The harness models failing machines, and the bar
(no acknowledged write lost, reads equal to an oracle) is about what the
cluster does around them.

The reference reads its rates, seed and afflicted nodes from the
``REPRO_FAULT_*`` variables; here they are the arguments of `FaultPlan`
and `faulty_factory`, and nothing reads the environment.
"""

from __future__ import annotations

import functools
import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Type

from ..core.cuboid import DatasetSpec
from ..core.store import CuboidStore


class FaultInjected(RuntimeError):
    """An error injected by the fault harness (not a real storage fault)."""


class NodeCrashed(FaultInjected):
    """The wrapped node is crashed: every data-plane op fails at once."""


class FaultPlan:
    """One node's deterministic fault policy.

    ``schedule`` maps an intercepted-op ordinal (0-based, counted across
    all faulted ops on the node) to ``"error"``, ``"hang"``, ``"crash"``
    or ``"restart"``: exact, replayable placement.  The seeded RNG adds
    faults at random on top: ``error_rate`` / ``hang_rate`` per op,
    ``latency_s`` on every op.  Thread-safe; the internal lock is a plain
    leaf, never held across the delegated call or a sleep.
    """

    def __init__(
        self,
        seed: int = 0,
        error_rate: float = 0.0,
        latency_s: float = 0.0,
        hang_s: float = 0.0,
        hang_rate: float = 0.0,
        schedule: Optional[Dict[int, str]] = None,
    ):
        self.error_rate = float(error_rate)
        self.latency_s = float(latency_s)
        self.hang_s = float(hang_s)
        self.hang_rate = float(hang_rate)
        self.schedule = dict(schedule or {})
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.ops = 0
        self.crashed = False
        self.injected_errors = 0
        self.injected_hangs = 0
        self.injected_latency_s = 0.0
        self.crashes = 0
        self.restarts = 0

    def crash(self) -> None:
        """Kill the node: every op raises ``NodeCrashed`` until restart."""
        with self._lock:
            if not self.crashed:
                self.crashed = True
                self.crashes += 1

    def restart(self) -> None:
        """Bring the node back (its durable data was never touched)."""
        with self._lock:
            if self.crashed:
                self.crashed = False
                self.restarts += 1

    def before_op(self, op: str) -> None:
        """Consult the plan before one intercepted op: may sleep (latency,
        hang) or raise (injected error, crashed node)."""
        with self._lock:
            n = self.ops
            self.ops += 1
            planned = self.schedule.get(n)
            if planned == "crash" and not self.crashed:
                self.crashed = True
                self.crashes += 1
            elif planned == "restart" and self.crashed:
                self.crashed = False
                self.restarts += 1
            crashed = self.crashed
            roll_error = planned == "error" or (
                self.error_rate > 0 and self._rng.random() < self.error_rate)
            roll_hang = planned == "hang" or (
                self.hang_rate > 0 and self._rng.random() < self.hang_rate)
        if crashed:
            raise NodeCrashed(f"node is crashed (op #{n}: {op})")
        if roll_hang and self.hang_s > 0:
            with self._lock:
                self.injected_hangs += 1
            time.sleep(self.hang_s)
        elif self.latency_s > 0:
            with self._lock:
                self.injected_latency_s += self.latency_s
            time.sleep(self.latency_s)
        if roll_error:
            with self._lock:
                self.injected_errors += 1
            raise FaultInjected(f"injected fault (op #{n}: {op})")

    def counters(self) -> Dict[str, object]:
        with self._lock:
            return {
                "ops": self.ops,
                "crashed": self.crashed,
                "errors": self.injected_errors,
                "hangs": self.injected_hangs,
                "latency_s": self.injected_latency_s,
                "crashes": self.crashes,
                "restarts": self.restarts,
            }


class FaultyNode:
    """A `CuboidStore` proxy that runs its :class:`FaultPlan` before every
    data-plane op, then delegates to the wrapped store.

    Only the ops the cluster's degraded paths must survive are
    intercepted: single and batch reads, writes, and ``has_cuboid`` (the
    health probe).  Introspection and the migration and repair plumbing
    (``stored_keys``, ``ingest_blobs``, ``flush`` ...) pass through, so the
    cluster can still heal a node whose serving path is down.  Attribute
    reads and writes delegate too: `ClusterStore` assigns
    ``decode_policy`` on its shards, and `cluster.cache` assigns ``cache``
    and ``write_behind``, all of which land on the wrapped store, so the
    cache and the queue sit behind the fault point as in the reference.
    """

    _OWN_ATTRS = frozenset({"inner", "plan", "name"})

    def __init__(self, inner: CuboidStore, plan: Optional[FaultPlan] = None,
                 name: str = "node"):
        self.__dict__["inner"] = inner
        self.__dict__["plan"] = plan or FaultPlan()
        self.__dict__["name"] = name

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    def __setattr__(self, attr, value):
        if attr in self._OWN_ATTRS:
            self.__dict__[attr] = value
        else:
            setattr(self.inner, attr, value)

    def __repr__(self) -> str:
        return f"FaultyNode({self.name!r}, crashed={self.plan.crashed})"

    def crash(self) -> None:
        self.plan.crash()

    def restart(self) -> None:
        self.plan.restart()

    # -- intercepted data plane --------------------------------------------
    def read_cuboid(self, *args, **kwargs):
        self.plan.before_op("read_cuboid")
        return self.inner.read_cuboid(*args, **kwargs)

    def write_cuboid(self, *args, **kwargs):
        self.plan.before_op("write_cuboid")
        return self.inner.write_cuboid(*args, **kwargs)

    def has_cuboid(self, *args, **kwargs):
        self.plan.before_op("has_cuboid")
        return self.inner.has_cuboid(*args, **kwargs)

    def read_run(self, *args, **kwargs):
        self.plan.before_op("read_run")
        return self.inner.read_run(*args, **kwargs)

    def fetch_runs(self, *args, **kwargs):
        self.plan.before_op("fetch_runs")
        return self.inner.fetch_runs(*args, **kwargs)

    def fetch_blocks(self, *args, **kwargs):
        self.plan.before_op("fetch_blocks")
        return self.inner.fetch_blocks(*args, **kwargs)

    def store_cuboids(self, *args, **kwargs):
        self.plan.before_op("store_cuboids")
        return self.inner.store_cuboids(*args, **kwargs)


def faulty_factory(
    base_factory: Optional[Callable[[int, DatasetSpec], CuboidStore]] = None,
    plans: Optional[Dict[int, FaultPlan]] = None,
    seed: int = 0,
    nodes: Optional[Iterable[int]] = None,
    *,
    error_rate: float = 0.0,
    latency_s: float = 0.0,
    hang_s: float = 0.0,
    hang_rate: float = 0.0,
    write_tier: Optional[str] = None,
):
    """A node factory wrapping built shards in :class:`FaultyNode`.

    ``plans`` pins explicit per-node plans; every other wrapped node ``i``
    gets ``FaultPlan(seed + i)`` with the given rates (all 0 by default: a
    crash-only plan).  ``nodes`` limits which indexes are wrapped (default
    all).  Without ``base_factory`` a node is the cluster's default: in
    memory, or the on-disk tier pair of ``write_tier`` (``"log"`` or
    ``"dir"``).  The returned factory exposes the proxies it built as
    ``factory.built`` ({index: FaultyNode}) so a chaos driver can crash
    and restart them.
    """
    from ..cluster.store import _default_node_factory

    base = base_factory or functools.partial(_default_node_factory, write_tier=write_tier)
    afflicted = frozenset(nodes) if nodes is not None else None
    rates = dict(error_rate=error_rate, latency_s=latency_s, hang_s=hang_s,
                 hang_rate=hang_rate)

    def factory(i: int, spec: DatasetSpec) -> CuboidStore:
        node = base(i, spec)
        if afflicted is not None and i not in afflicted:
            return node
        plan = (plans or {}).get(i)
        if plan is None:
            plan = FaultPlan(seed=seed + i, **rates)
        proxy = FaultyNode(node, plan, name=f"node{i}")
        factory.built[i] = proxy
        return proxy

    factory.built = {}
    return factory


def crash_schedule_hook(
    schedule: Dict[str, int],
    exc: Type[BaseException] = FaultInjected,
) -> Callable[[str], None]:
    """A ``set_crash_hook`` hook raising on the N-th hit of each named
    crash point: composes this harness with the storage tier's
    ``crashpoint()`` markers (``dir.put.synced``, ``wal.append.written``,
    ...) so a chaos run can tear the durable-put path at an exact syscall
    boundary, deterministically."""
    counts: Dict[str, int] = {}
    lock = threading.Lock()

    def hook(name: str) -> None:
        with lock:
            nth = schedule.get(name)
            if nth is None:
                return
            counts[name] = counts.get(name, 0) + 1
            hit = counts[name]
        if hit == nth:
            raise exc(f"injected crash at point {name!r} (hit #{hit})")

    return hook
