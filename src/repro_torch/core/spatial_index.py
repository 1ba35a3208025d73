"""Per-object sparse spatial index (paper §4.2, C7).

Maps annotation identifier -> the Morton locations of the cuboids holding
that object's voxels.  Maintenance is append-mostly and batched; retrieval
sorts the list into curve order so an object is read in one sequential
pass (paper Fig 9).  Host-side bookkeeping, copied from the reference and
trimmed to what the detection path uses.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Set


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
