"""Checkpoint/restart supervision and straggler monitoring
(`repro.ft.supervisor`, its training half).

`TrainingSupervisor` wraps the step loop: periodic async checkpoints
(`ckpt.CheckpointManager`), and on a `WorkerFailure` a restore from the
newest committed checkpoint (or the step-0 snapshot) and a replay.  The
data pipeline addresses batches by step, so the replay is exact when the
step function is deterministic.  `FailureInjector` raises failures on a
fixed schedule, so recovery is testable; `StragglerMonitor` keeps a
per-worker EMA of step times and flags workers slower than ``threshold``
x the median.
"""
from __future__ import annotations

import dataclasses
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
