"""Checkpoint/restart supervision, straggler monitoring, and the storage
tier's watch loop (`repro.ft.supervisor`).

`TrainingSupervisor` wraps the step loop: periodic async checkpoints
(`ckpt.CheckpointManager`), and on a `WorkerFailure` a restore from the
newest committed checkpoint (or the step-0 snapshot) and a replay.  The
data pipeline addresses batches by step, so the replay is exact when the
step function is deterministic.  `FailureInjector` raises failures on a
fixed schedule, so recovery is testable; `StragglerMonitor` keeps a
per-worker EMA of step times and flags workers slower than ``threshold``
x the median.

The storage tier's loop is watch and re-shape: `ClusterWatch` polls the
data cluster's gauges (key occupancy, write-behind depth, sealed log
segments, replication, node health, access heat) and advises the live
control verbs (rebalance, flush, compact, re_replicate, resync, and a
debounced failover); `StorageSupervisor` executes that advice on a
background tick, so a dead node is removed and replication healed with
no operator call.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..ckpt import CheckpointManager, restore_checkpoint
from ..ckpt.checkpoint import host_copy
from ..models.params import tree_map


class WorkerFailure(RuntimeError):
    """A (simulated) node failure."""

    def __init__(self, worker: int, step: int):
        super().__init__(f"worker {worker} failed at step {step}")
        self.worker = worker
        self.step = step


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: worker_id}, each firing once."""
    schedule: Dict[int, int]
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(self.schedule[step], step)


class StragglerMonitor:
    """EMA step-time tracking per worker; flags > threshold x median."""

    def __init__(self, n_workers: int, alpha: float = 0.3, threshold: float = 1.8):
        self.ema = np.zeros(n_workers)
        self.alpha = alpha
        self.threshold = threshold
        self.reissued: List[int] = []

    def record(self, worker: int, dt: float) -> None:
        e = self.ema[worker]
        self.ema[worker] = dt if e == 0 else self.alpha * dt + (1 - self.alpha) * e

    def stragglers(self) -> List[int]:
        active = self.ema[self.ema > 0]
        if len(active) < 2:
            return []
        med = float(np.median(active))
        return [int(i) for i in np.nonzero(self.ema > self.threshold * med)[0]]

    def reissue(self, worker: int) -> None:
        self.reissued.append(worker)


class ClusterWatch:
    """Advise storage-tier control actions from observability gauges.

    The training tier recovers by checkpoint/restart; the storage tier's
    analogous loop is *watch and re-shape*: the same gauges the
    ``/metrics`` scrape exports (``keys_per_node``, write-behind
    ``depth``, segment heat) feed two live control verbs the cluster
    already serves — rebalance on occupancy skew, flush on queue
    pressure.  The watch only *advises*; invoking the verbs stays with
    the operator (or the caller's loop) because both move data.

    The watch is also the cluster's failure detector tick: ``sample()``
    drives ``probe_health()`` when the store has one, and ``advise()``
    turns node health into two more verbs — ``failover`` when a node has
    stayed dead for ``dead_ticks`` consecutive samples (debounced so one
    probe blip never evicts a node), and ``resync`` for a recovering node
    (or a live one with queued repair writes) so it is caught up via
    anti-entropy before serving reads again.

    Works against any store with ``topology()``; queue, heat, and health
    signals degrade gracefully when the store lacks them (single-node
    tiers).
    """

    def __init__(self, store, skew: float = 1.5, max_queue_depth: int = 256,
                 heat_top: int = 4, max_sealed_segments: int = 1,
                 dead_ticks: int = 2):
        self.store = store
        self.skew = skew                    # max/mean occupancy ratio that trips
        self.max_queue_depth = max_queue_depth
        self.heat_top = heat_top
        # sealed log segments across the cluster that trip "compact"
        self.max_sealed_segments = max_sealed_segments
        # consecutive dead samples before failover is advised
        self.dead_ticks = max(1, int(dead_ticks))
        self._dead_streak: Dict[int, int] = {}
        self._last_n_nodes: Optional[int] = None
        self.history: List[Dict] = []

    def sample(self) -> Dict:
        """One gauge snapshot, appended to ``history``."""
        if hasattr(self.store, "probe_health"):
            self.store.probe_health()  # the cheap failure-detector tick
        topo = (self.store.topology() if hasattr(self.store, "topology")
                else {"n_nodes": 1, "keys_per_node": []})
        replication = int(topo.get("replication", 1))
        snap: Dict = {
            "n_nodes": int(topo["n_nodes"]),
            "rebalancing": bool(topo.get("rebalancing", False)),
            "keys_per_node": [int(k) for k in topo.get("keys_per_node", [])],
            "replication": replication,
            "replication_target": int(
                topo.get("replication_target", replication)),
            "queue_depth": 0,
            "sealed_segments": 0,
            "hot": [],
        }
        if hasattr(self.store, "queue_counters"):
            snap["queue_depth"] = int(self.store.queue_counters().get("depth", 0))
        if hasattr(self.store, "tier_counters"):
            snap["sealed_segments"] = int(
                self.store.tier_counters().get("sealed", 0))
        elif hasattr(self.store, "tier_stats"):
            log = self.store.tier_stats().get("log")
            snap["sealed_segments"] = int(log["sealed"]) if log else 0
        if hasattr(self.store, "access_heat"):
            heat = self.store.access_heat(top=self.heat_top)
            snap["hot"] = [tuple(row) for row in heat["read"]]
        snap["health"] = [str(h) for h in topo.get("health", [])]
        snap["repair"] = []
        if hasattr(self.store, "node_health"):
            snap["repair"] = [int(h["repair_pending"])
                              for h in self.store.node_health()]
        # Debounce death: a node must stay dead across consecutive samples
        # before failover fires.  Streaks are keyed by node index, so any
        # membership change (indexes shift) resets them all.
        if self._last_n_nodes != snap["n_nodes"]:
            self._dead_streak.clear()
            self._last_n_nodes = snap["n_nodes"]
        for i, state in enumerate(snap["health"]):
            if state == "dead":
                self._dead_streak[i] = self._dead_streak.get(i, 0) + 1
            else:
                self._dead_streak.pop(i, None)
        snap["dead_streaks"] = dict(self._dead_streak)
        self.history.append(snap)
        return snap

    def advise(self, snap: Optional[Dict] = None) -> List[Dict]:
        """Actions implied by a snapshot (default: the latest sampled)."""
        if snap is None:
            snap = self.history[-1] if self.history else self.sample()
        actions: List[Dict] = []
        keys = snap["keys_per_node"]
        occupied = [k for k in keys if k > 0]
        if len(keys) > 1 and occupied and not snap["rebalancing"]:
            mean = sum(keys) / len(keys)
            if mean > 0 and max(keys) / mean > self.skew:
                actions.append({
                    "action": "rebalance",
                    "reason": f"occupancy skew {max(keys) / mean:.2f} > {self.skew}",
                    "keys_per_node": keys,
                })
        if snap["queue_depth"] > self.max_queue_depth:
            actions.append({
                "action": "flush",
                "reason": (f"write-behind depth {snap['queue_depth']} > "
                           f"{self.max_queue_depth}"),
            })
        if snap.get("sealed_segments", 0) >= self.max_sealed_segments:
            actions.append({
                "action": "compact",
                "reason": (f"{snap['sealed_segments']} sealed log "
                           f"segment(s) awaiting merge into the read tier"),
            })
        if (snap.get("replication", 1) < snap.get("replication_target", 1)
                and not snap["rebalancing"]):
            actions.append({
                "action": "re_replicate",
                "reason": (f"effective replication {snap['replication']} < "
                           f"target {snap['replication_target']}"),
            })
        health = snap.get("health", [])
        repair = snap.get("repair", [])
        for i, state in enumerate(health):
            backlog = repair[i] if i < len(repair) else 0
            if state == "recovering" or (state == "alive" and backlog > 0):
                actions.append({
                    "action": "resync",
                    "node": i,
                    "reason": (f"node {i} is {state} with {backlog} repair "
                               f"write(s) queued; anti-entropy resync"),
                })
        if not snap.get("rebalancing", False):
            streaks = snap.get("dead_streaks", {})
            for i, state in enumerate(health):
                if state == "dead" and streaks.get(i, 0) >= self.dead_ticks:
                    actions.append({
                        "action": "failover",
                        "node": i,
                        "reason": (f"node {i} dead for {streaks[i]} "
                                   f"consecutive samples; promote replicas"),
                    })
                    break  # one removal per tick: indexes shift afterwards
        return actions

    def step(self) -> List[Dict]:
        """Sample then advise — one watch-loop tick."""
        return self.advise(self.sample())


class StorageSupervisor:
    """Close the watch loop: sample the gauges, *execute* the advice.

    `ClusterWatch` only advises; this supervisor owns acting on it — the
    runtime-not-operator recovery doctrine applied to the storage tier.
    Per tick (`step`, or the background thread `start` runs every
    ``interval`` seconds) it maps advised actions to store verbs:

    * ``flush`` — drain the write-behind queues (queue pressure),
    * ``compact`` — merge sealed log segments into the read tier (this is
      what drives ``core.compact`` in the background),
    * ``re_replicate`` — heal under-replicated segments after a shrink
      (``replication`` below ``replication_target``),
    * ``rebalance`` — only when ``allow_rebalance=True``; occupancy moves
      whole key ranges, so it stays opt-in,
    * ``failover`` — remove a node the health machine has held dead for
      ``dead_ticks`` samples (re-verified against ``node_health()`` at
      execution time so a healed or already-removed node is skipped); the
      removal migration itself promotes replicas, and any residual gap is
      healed by the existing ``re_replicate`` advice,
    * ``resync`` — anti-entropy catch-up for a recovering node (or a live
      one with queued repair writes) before it serves reads again.

    Topology verbs run with ``wait=False`` and a concurrent admin op just
    skips the tick (the advice re-fires next tick if still true); any
    other verb failure is swallowed the same way — recorded on the action
    dict, never allowed to kill the supervisor thread.  ``log`` records
    every executed action for inspection.
    """

    def __init__(self, store, watch: Optional[ClusterWatch] = None,
                 interval: float = 0.25, allow_rebalance: bool = False,
                 allow_failover: bool = True):
        self.store = store
        self.watch = watch or ClusterWatch(store)
        self.interval = interval
        self.allow_rebalance = allow_rebalance
        self.allow_failover = allow_failover
        self.log: List[Dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _execute(self, action: Dict) -> bool:
        from ..cluster.store import RebalanceInFlight  # lazy: keep ft light
        kind = action["action"]
        store = self.store
        try:
            if kind == "flush" and hasattr(store, "flush"):
                store.flush()
            elif kind == "compact" and hasattr(store, "compact"):
                store.compact()
            elif kind == "re_replicate" and hasattr(store, "re_replicate"):
                store.re_replicate(wait=False)
            elif (kind == "rebalance" and self.allow_rebalance
                    and hasattr(store, "rebalance")):
                store.rebalance(wait=False)
            elif kind == "resync" and hasattr(store, "resync_node"):
                store.resync_node(action["node"], wait=False)
            elif (kind == "failover" and self.allow_failover
                    and hasattr(store, "remove_node")):
                idx = action["node"]
                health = (store.node_health()
                          if hasattr(store, "node_health") else [])
                if not (0 <= idx < len(health)) or health[idx]["state"] != "dead":
                    return False  # healed or already removed since advised
                store.remove_node(idx, wait=False)
            else:
                return False
        except RebalanceInFlight:
            return False  # an admin op holds the lock; re-advised next tick
        except Exception as e:
            # The supervisor tick must outlive any one verb: record and
            # move on (the advice re-fires next tick if still true).
            action["error"] = repr(e)
            return False
        return True

    def step(self) -> List[Dict]:
        """One tick: watch, execute, log.  Returns the executed actions."""
        executed = [a for a in self.watch.step() if self._execute(a)]
        self.log.extend(executed)
        return executed

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self.step()

        self._thread = threading.Thread(
            target=loop, name="ocp-storage-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class TrainingSupervisor:
    """Run a step function under checkpoint/restart supervision.

    ``step_fn(state, step) -> state`` must be deterministic in (state,
    step); that makes recovery by replay exact.  ``state_to_tree`` gives
    the checkpoint tree of a state (its leaves are copied to the host when
    a snapshot is taken, so the step may update the state in place), and
    ``tree_to_state(tree, state)`` loads a restored tree (CPU tensors)
    back."""

    def __init__(self, ckpt_dir: str, ckpt_every: int = 10, keep: int = 3,
                 injector: Optional[FailureInjector] = None, max_restarts: int = 8):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.max_restarts = max_restarts
        self.restarts = 0
        self.recovery_log: List[Dict] = []

    def run(self, state, step_fn: Callable, n_steps: int,
            state_to_tree: Callable = lambda s: s,
            tree_to_state: Callable = lambda t, s: t):
        # step-0 snapshot: a cold restart (no committed checkpoint yet)
        # must replay from the INITIAL state, not the mutated one
        initial = tree_map(host_copy, state_to_tree(state))
        step = 0
        while step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                state = step_fn(state, step)
                if (step + 1) % self.ckpt_every == 0:
                    self.mgr.save_async(step + 1, state_to_tree(state))
                step += 1
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.mgr.wait()  # drain in-flight checkpoint writes
                last = self.mgr.latest_step()
                if last is None:
                    state = tree_to_state(initial, state)  # cold restart
                    restart_step = 0
                else:
                    _, tree = restore_checkpoint(self.mgr.ckpt_dir, last)
                    state = tree_to_state(tree, state)
                    restart_step = last
                self.recovery_log.append({
                    "failed_step": e.step, "worker": e.worker,
                    "restored_to": restart_step, "lost_steps": step - restart_step})
                step = restart_step
        self.mgr.wait()
        return state
