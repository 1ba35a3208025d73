"""Fault tolerance of the port (`repro.ft`), the training half:
checkpoint/restart supervision and straggler monitoring."""
from .supervisor import (FailureInjector, StragglerMonitor, TrainingSupervisor,
                         WorkerFailure)

__all__ = ["FailureInjector", "StragglerMonitor", "TrainingSupervisor",
           "WorkerFailure"]
