"""Fault tolerance of the port (`repro.ft`): checkpoint/restart
supervision and straggler monitoring for training; seeded fault
injection at the cluster's node boundary and the storage tier's watch
and supervisor loop."""
from .faults import (FaultInjected, FaultPlan, FaultyNode, NodeCrashed,
                     crash_schedule_hook, faulty_factory)
from .supervisor import (ClusterWatch, FailureInjector, StorageSupervisor,
                         StragglerMonitor, TrainingSupervisor, WorkerFailure)

__all__ = ["ClusterWatch", "FailureInjector", "StorageSupervisor",
           "StragglerMonitor", "TrainingSupervisor", "WorkerFailure",
           "FaultInjected", "FaultPlan", "FaultyNode", "NodeCrashed",
           "crash_schedule_hook", "faulty_factory"]
