"""Serving in the port: LM serving (`repro.serve`'s serving steps and
batcher) and the volume data service's HTTP front door.

The volume verbs (paper §4.2) are stateless request-dict handlers over
device stores backed by the data cluster, with the hot-cuboid cache tier,
write-behind ingest queue, and the elastic rebalancing verbs (GET
/topology, POST /rebalance — paper §6).  HANDLERS is re-exported so HTTP
shims can enumerate every verb they need to route."""
from ..cluster import HANDLERS as VOLUME_HANDLERS
from ..cluster import (ClusterStore, CuboidCache, VolumeService, WriteBehindQueue,
                       url_dispatch)
from ..cluster import dispatch as volume_dispatch
from .batcher import ContinuousBatcher, Request
from .client import RetryingClient
from .http_front import FrontDoor
from .serve_step import make_prefill_step, make_serve_step

__all__ = [
    "RetryingClient",
    "make_serve_step",
    "make_prefill_step",
    "ContinuousBatcher",
    "Request",
    "VolumeService",
    "VOLUME_HANDLERS",
    "volume_dispatch",
    "url_dispatch",
    "FrontDoor",
    "ClusterStore",
    "CuboidCache",
    "WriteBehindQueue",
]
