"""Stateless request routing over a Morton-curve partition (paper §4.1 C3).

The paper shards a dataset across database nodes by partitioning the Morton
curve into contiguous segments; any front-end web server can route any
request because ownership is a pure function of (dataset spec, partition,
morton index) — no routing table, no directory service.  :class:`Router` is
that pure function made explicit: it owns no sockets and no state, so a
`ClusterStore` holds one and so could a fleet of stateless web front-ends.

Partitioning is per resolution level (each level has its own curve length);
every node therefore owns a spatially compact region at *every* level, and
runs within one node stay sequential (paper: reads on a node are few long
sequential I/Os even after sharding).

Ownership is evaluated against an explicit per-resolution
:class:`repro_torch.core.morton.Partition` (a curve boundary list), so boundaries
can *move*: rebalancing builds a new Router with shifted bounds and swaps
it in atomically (paper §6 "dynamically redistribute data").  Resolutions
without an explicit partition fall back to the even `partition_curve`
split, which is what a freshly-built cluster uses everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np

from ..core import morton
from ..core.cuboid import DatasetSpec

Runs = morton.Runs
Partition = morton.Partition


@dataclasses.dataclass(frozen=True)
class Router:
    """Pure ownership function for a curve-partitioned dataset.

    ``partitions`` maps resolution -> explicit :class:`Partition` override;
    missing resolutions use the even split over ``n_nodes``.  Routers are
    immutable — rebalancing derives a new one via :meth:`with_partitions`
    and publishes it atomically, so every request evaluates one consistent
    boundary set end to end.

    ``replication`` is the requested copies-per-segment: segment ``i`` is
    held by the replica set ``(i, i+1, ..., i+R-1) mod n_nodes`` (a
    successor ring over the node indices, capped at ``n_nodes``).  The
    first member is the *primary* — the segment's partition owner — and
    write fan-out targets every member while reads may pick any.  Like
    ownership itself, the replica set is a pure function of the router, so
    any stateless front-end resolves it identically.
    """

    spec: DatasetSpec
    n_nodes: int
    partitions: Mapping[int, Partition] = dataclasses.field(default_factory=dict)
    replication: int = 1

    def __post_init__(self):
        if self.n_nodes <= 0:
            raise ValueError("n_nodes must be positive")
        if self.replication <= 0:
            raise ValueError("replication must be positive")
        for r, part in self.partitions.items():
            if part.n_parts != self.n_nodes:
                raise ValueError(
                    f"partition at r={r} has {part.n_parts} parts, expected {self.n_nodes}"
                )

    def n_cells(self, r: int) -> int:
        return self.spec.grid(r).n_cells

    @property
    def n_replicas(self) -> int:
        """Effective copies per segment (capped: a 2-node cluster can hold
        at most 2 distinct copies however large the requested factor)."""
        return min(self.replication, self.n_nodes)

    def replicas_of(self, primary: int) -> Tuple[int, ...]:
        """The replica set of the segment owned by ``primary``: the
        successor ring starting at the primary."""
        return tuple((primary + k) % self.n_nodes for k in range(self.n_replicas))

    def replica_set(self, r: int, m: int) -> Tuple[int, ...]:
        """Every node holding morton index ``m`` (primary first)."""
        return self.replicas_of(self.owner(r, m))

    def partition(self, r: int) -> Partition:
        """The explicit curve partition at resolution ``r``."""
        part = self.partitions.get(r)
        if part is not None:
            return part
        return Partition.even(self.n_cells(r), self.n_nodes)

    def with_partitions(
        self, partitions: Mapping[int, Partition], n_nodes: int | None = None
    ) -> "Router":
        """A new Router with updated boundaries (rebalance publishes this)."""
        merged = dict(self.partitions)
        merged.update(partitions)
        return Router(
            self.spec,
            self.n_nodes if n_nodes is None else n_nodes,
            merged,
            self.replication,
        )

    def segments(self, r: int) -> List[Tuple[int, int]]:
        """The curve partition at resolution ``r``: node i owns segment i."""
        return self.partition(r).segments()

    def owner(self, r: int, m: int) -> int:
        """Owning node of one morton index."""
        return int(self.partition(r).owner(m))

    def owners(self, r: int, cells) -> np.ndarray:
        """Vectorized owner lookup for an array of morton indexes."""
        return self.partition(r).owner(np.asarray(cells, dtype=np.int64))

    def split_run(self, r: int, start: int, stop: int) -> List[Tuple[int, int, int]]:
        """Split one curve run at partition boundaries.

        Returns [(node, start, stop), ...] in curve order — each piece is
        non-empty and wholly owned by one node, so node-local I/O stays
        sequential.  Empty segments (a node owning nothing at this
        resolution) are skipped.
        """
        return self.partition(r).split(start, stop)

    def split_runs(self, r: int, runs: Runs) -> Dict[int, Runs]:
        """Group a run schedule by owning node: {node: runs on that node}."""
        part = self.partition(r)
        by_node: Dict[int, Runs] = {}
        for start, stop in runs:
            for node, a, b in part.split(start, stop):
                by_node.setdefault(node, []).append((a, b))
        return by_node

    def split_run_replicas(
        self, r: int, start: int, stop: int
    ) -> List[Tuple[Tuple[int, ...], int, int]]:
        """Like :meth:`split_run`, but each piece carries its full replica
        set: [(members, start, stop), ...] in curve order.  A replicated
        read picks any one member per piece; pieces stay whole so
        node-local I/O stays sequential whichever member serves them."""
        return [
            (self.replicas_of(node), a, b) for node, a, b in self.partition(r).split(start, stop)
        ]

    def group_cells(self, r: int, cells) -> Dict[int, np.ndarray]:
        """Group loose morton indexes by owning node (write routing)."""
        cells = np.asarray(cells, dtype=np.int64)
        owners = self.owners(r, cells)
        return {int(n): cells[owners == n] for n in np.unique(owners)}
