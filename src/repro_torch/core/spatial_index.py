"""Per-object sparse spatial index (paper §4.2, C7).

Maps annotation identifier -> the Morton locations of the cuboids holding
that object's voxels.  Maintenance is append-mostly and batched; retrieval
sorts the list into curve order so an object is read in one sequential
pass (paper Fig 9).  Host-side bookkeeping, copied from the reference.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

from . import morton
from .cuboid import CuboidGrid


class ObjectIndex:
    def __init__(self):
        self._idx: Dict[int, Set[int]] = {}
        self._lock = threading.Lock()
        self.append_batches = 0  # write transactions applied

    def append_batch(self, updates: Dict[int, Iterable[int]]) -> None:
        """One write transaction appends all new cuboid locations (§4.2)."""
        with self._lock:
            for ann_id, cubes in updates.items():
                self._idx.setdefault(int(ann_id), set()).update(
                    int(c) for c in cubes)
            self.append_batches += 1

    def cuboids(self, ann_id: int) -> List[int]:
        """Morton locations for an object, sorted into curve order."""
        return sorted(self._idx.get(int(ann_id), ()))

    def remove(self, ann_id: int) -> None:
        with self._lock:
            self._idx.pop(int(ann_id), None)

    def ids(self) -> List[int]:
        return sorted(self._idx.keys())

    def __contains__(self, ann_id: int) -> bool:
        return int(ann_id) in self._idx

    def runs(self, ann_id: int) -> List[Tuple[int, int]]:
        """Collapse the sorted cuboid list into contiguous morton runs."""
        return morton.indices_to_runs(self.cuboids(ann_id))

    def partitioned_runs(self, ann_id: int,
                         segments: Sequence[Tuple[int, int]]
                         ) -> Dict[int, List[Tuple[int, int]]]:
        """Object runs grouped by curve segment (segment i = rank or node
        i, `morton.partition_curve` order), each run clipped at the segment
        boundaries so that one owner holds it."""
        by_part: Dict[int, List[Tuple[int, int]]] = {}
        for start, stop in self.runs(ann_id):
            for i, (seg_lo, seg_hi) in enumerate(segments):
                a, b = max(start, seg_lo), min(stop, seg_hi)
                if a < b:
                    by_part.setdefault(i, []).append((a, b))
        return by_part

    def bounding_box(self, ann_id: int,
                     grid: CuboidGrid) -> Tuple[List[int], List[int]] | None:
        """Cuboid-resolution bounding box from the index alone (no voxel
        read, paper §4.2), clipped to the volume."""
        cubes = self.cuboids(ann_id)
        if not cubes:
            return None
        cs = np.array(grid.cuboid_shape)
        origins = morton.morton_decode(np.asarray(cubes), grid.bits) * cs
        lo = origins.min(axis=0)
        hi = np.minimum(origins.max(axis=0) + cs, np.array(grid.volume_shape))
        return [int(x) for x in lo], [int(x) for x in hi]
