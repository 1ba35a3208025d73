"""Spatially-partitioned *elastic* data cluster (paper §4.1 + §6):
sharded stores with per-segment replication, stateless routing over
movable curve partitions, live rebalancing with segment migration, the
hot-cuboid cache tier + write-behind ingest queue, and the RESTful-style
service verbs (flat verb table + URL-routed v1 paths) over device stores
whose backing is such a cluster."""

from ..core.store import DecodePolicy
from .api import ApiError, parse_url, url_dispatch
from .cache import (
    CuboidCache,
    WriteBehindQueue,
    attach_cache,
    enable_write_behind,
)
from .handlers import (
    HANDLERS,
    VolumeService,
    dispatch,
    get_annotation_bbox,
    get_cutout,
    get_object_cutout,
    get_projection,
    get_stats,
    get_topology,
    post_add_node,
    post_batch_cutout,
    post_flush,
    post_rebalance,
    post_remove_node,
    put_cutout,
)
from .router import Partition, Router
from .store import ClusterStore, RebalanceInFlight

__all__ = [
    "ClusterStore",
    "RebalanceInFlight",
    "Router",
    "Partition",
    "DecodePolicy",
    "CuboidCache",
    "WriteBehindQueue",
    "attach_cache",
    "enable_write_behind",
    "VolumeService",
    "HANDLERS",
    "dispatch",
    "ApiError",
    "parse_url",
    "url_dispatch",
    "get_cutout",
    "put_cutout",
    "get_projection",
    "get_annotation_bbox",
    "get_object_cutout",
    "post_batch_cutout",
    "post_flush",
    "get_stats",
    "get_topology",
    "post_rebalance",
    "post_add_node",
    "post_remove_node",
]
