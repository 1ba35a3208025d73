"""Annotation projects: RAMON-like metadata + device label volumes (§3.2).

An `AnnotationProject` pairs a host metadata table (a small RAMON-like
ontology with predicate queries) and a host object index with a label
database held as a `DeviceCuboidStore` registered to an image dataset.
Labels are uint32 identifiers in the reference; on the device they are
held as int32 with the same bits, so an id at or above 2^31 is stored as
a negative int32.  Ids are uint32 at every boundary: index keys and
metadata use the unsigned value (`_uint_ids`), writes reinterpret uint32
labels bit for bit, and reads compare against an id's int32 view
(`_stored_id`); the numpy boundary (`carry`) hands back uint32.

The batch write applies many objects as one voxel scatter with the same
result as writing them one after another: for ``overwrite`` the last
object that covers a voxel wins, for ``preserve`` a stored label is kept
and otherwise the first object wins.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from . import morton
from .cuboid import DatasetSpec
from .cutout import as_device_tensor, cutout, write_cutout
from .distributed import signed_view
from .spatial_index import ObjectIndex
from .store import DeviceCuboidStore

RAMON_TYPES = ("generic", "seed", "synapse", "segment", "neuron", "organelle")


def _stored_id(ann_id: int) -> int:
    """The int32 that holds uint32 id ``ann_id`` on the device."""
    return int(np.array(ann_id, dtype=np.uint32).view(np.int32))


def _uint_ids(ids: torch.Tensor) -> torch.Tensor:
    """Stored int32 ids as their uint32 values, in int64."""
    return ids.to(torch.int64) & 0xFFFFFFFF


@dataclasses.dataclass
class Annotation:
    ann_id: int
    ann_type: str = "generic"
    confidence: float = 1.0
    status: int = 0
    author: str = ""
    kv: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # synapse-specific (paper's driving application):
    synapse_type: int = 0
    weight: float = 0.0
    segments: Tuple[int, ...] = ()      # linked segment ids
    # segment/neuron-specific:
    neuron: int = 0
    parent_seed: int = 0

    def matches(self, field: str, op: str, value) -> bool:
        v = self.kv.get(field) if field in self.kv else getattr(
            self, field, None)
        if v is None:
            return False
        if op == "eq":
            return str(v) == str(value) if isinstance(v, str) else v == value
        x, y = float(v), float(value)
        return {"lt": x < y, "leq": x <= y, "gt": x > y,
                "geq": x >= y}[op]


class MetadataTable:
    """Key/value predicate queries over annotation metadata (paper §4.2)."""

    def __init__(self):
        self._rows: Dict[int, Annotation] = {}
        self._next_id = itertools.count(1)
        self._max_id = 0  # largest id in the table
        self._lock = threading.Lock()

    def create(self, ann: Optional[Annotation] = None, **kwargs) -> Annotation:
        with self._lock:
            if ann is None:
                ann_id = kwargs.pop("ann_id", None) or next(self._next_id)
                ann = Annotation(ann_id=ann_id, **kwargs)
            elif ann.ann_id in (0, None):
                ann.ann_id = next(self._next_id)
            if ann.ann_type not in RAMON_TYPES:
                raise ValueError(f"unknown RAMON type {ann.ann_type!r}")
            self._rows[ann.ann_id] = ann
            # keep auto-ids ahead of explicit ids; a running max, since
            # rescanning every row per create is quadratic in the table
            self._max_id = max(self._max_id, ann.ann_id)
            self._next_id = itertools.count(self._max_id + 1)
            return ann

    def get(self, ann_id: int) -> Optional[Annotation]:
        return self._rows.get(int(ann_id))

    def query(self, *predicates: Tuple[str, str, Any]) -> List[int]:
        """Conjunctive predicates: [(field, op, value), ...] -> ids."""
        out = []
        for ann_id, ann in self._rows.items():
            if all(ann.matches(f, op, v) for f, op, v in predicates):
                out.append(ann_id)
        return sorted(out)


class AnnotationProject:
    """One annotation database registered to an image dataset (paper §3.2)."""

    def __init__(self, name: str, image_spec: DatasetSpec,
                 device: DeviceLike = "cuda"):
        self.name = name
        self.spec = dataclasses.replace(
            image_spec, name=f"{image_spec.name}/{name}", dtype="uint32",
            n_channels=1)
        self.store = DeviceCuboidStore(self.spec, device=device)
        self.meta = MetadataTable()
        self.index = ObjectIndex()

    def _index_voxels(self, r: int, coords: torch.Tensor,
                      ids: torch.Tensor) -> None:
        """Append (id -> cuboid) locations of labelled in-volume voxels:
        one device ``unique`` over id * n_cells + Morton cell."""
        if coords.shape[0] == 0:
            return
        grid = self.spec.grid(r)
        cs = torch.tensor(grid.cuboid_shape, device=coords.device)
        cell = morton.morton_encode_torch(coords // cs, grid.bits)
        keys = torch.unique(_uint_ids(ids) * grid.n_cells + cell).tolist()
        updates: Dict[int, set] = {}
        for key in keys:
            updates.setdefault(key // grid.n_cells, set()).add(key % grid.n_cells)
        self.index.append_batch(updates)

    def _in_volume(self, r: int, coords: torch.Tensor) -> torch.Tensor:
        vol = torch.tensor(self.spec.grid(r).volume_shape, device=coords.device)
        return ((coords >= 0) & (coords < vol)).all(dim=1)

    # -- write -------------------------------------------------------------
    def write(self, r: int, lo: Sequence[int], labels,
              discipline: str = "overwrite") -> None:
        """Write a labelled volume with a conflict discipline (paper §3.2).

        Visible at resolution ``r`` at once; other levels stay stale until
        the label hierarchy is rebuilt (deferred consistency, paper §3.2).
        """
        labels = as_device_tensor(labels, self.store.device)
        # uint32 ids keep their bits; other integer labels are cast
        labels = (labels.view(torch.int32) if labels.dtype == torch.uint32
                  else labels.to(torch.int32))
        write_cutout(self.store, r, lo, labels, discipline=discipline)
        nz = labels.nonzero()
        coords = nz + torch.tensor([int(l) for l in lo], device=nz.device)
        keep = self._in_volume(r, coords)
        self._index_voxels(r, coords[keep], labels[tuple(nz[keep].T)])

    def batch_write_objects(
            self, r: int,
            objects: List[Tuple[Annotation, Sequence[int], Any]],
            discipline: str = "overwrite") -> List[int]:
        """Write many (metadata, offset, labelled-volume) at once.

        The paper doubled synapse-finder throughput batching 40 writes; here
        the whole batch is one voxel scatter and one index transaction.
        """
        if discipline not in ("overwrite", "preserve"):
            raise ValueError(f"unsupported batch discipline {discipline!r}")
        dev = self.store.device
        ids, masks, shapes, los = [], [], [], []
        for ann, lo, vol in objects:
            ids.append(self.meta.create(ann).ann_id)
            t = as_device_tensor(vol, dev)
            masks.append((t != 0).reshape(-1))
            shapes.append(tuple(t.shape))
            los.append([int(l) for l in lo])
        if not ids:
            return ids
        # one nonzero over the concatenated masks, then back to (object,
        # voxel) with the masks' offsets and shapes
        sizes = torch.tensor([m.numel() for m in masks], device=dev)
        ends = torch.cumsum(sizes, 0)
        flat = torch.cat(masks).nonzero().squeeze(1)
        order_t = torch.searchsorted(ends, flat, right=True)
        local = flat - (ends - sizes)[order_t]
        dims = torch.tensor(shapes, device=dev)[order_t]
        cols = []
        for d in reversed(range(dims.shape[1])):
            cols.append(local % dims[:, d])
            local = local // dims[:, d]
        coords_t = torch.stack(cols[::-1], dim=1) + torch.tensor(
            los, device=dev)[order_t]
        keep = self._in_volume(r, coords_t)
        coords_t, order_t = coords_t[keep], order_t[keep]
        ids_t = torch.from_numpy(np.asarray(ids, dtype=np.uint32).view(np.int32)).to(dev)
        self._scatter_labels(r, coords_t, order_t, ids_t, discipline)
        self._index_voxels(r, coords_t, ids_t[order_t])
        return ids

    def _scatter_labels(self, r: int, coords: torch.Tensor,
                        order: torch.Tensor, ids: torch.Tensor,
                        discipline: str) -> None:
        if coords.shape[0] == 0:
            return
        grid = self.spec.grid(r)
        cs = torch.tensor(grid.cuboid_shape, device=coords.device)
        cell = morton.morton_encode_torch(coords // cs, grid.bits)
        local = coords % cs
        inner = local[:, 0]
        for d in range(1, grid.rank):
            inner = inner * grid.cuboid_shape[d] + local[:, d]
        key = cell * grid.cuboid_voxels + inner
        ukey, inv = torch.unique(key, return_inverse=True)
        winner = torch.full_like(ukey, -1 if discipline == "overwrite"
                                 else order.shape[0])
        winner.scatter_reduce_(0, inv, order, "amax" if discipline ==
                               "overwrite" else "amin")
        val = ids[winner]
        with self.store.write_guard:
            flat = signed_view(self.store.level(r)).view(-1)
            if discipline == "preserve":
                old = flat[ukey]
                val = torch.where(old != 0, old, val)
            flat[ukey] = val

    # -- read ---------------------------------------------------------------
    def read(self, r: int, lo: Sequence[int], hi: Sequence[int]) -> torch.Tensor:
        """Dense int32 labels of [lo, hi) on the project's device."""
        return cutout(self.store, r, lo, hi)

    def voxel_list(self, ann_id: int, r: int) -> np.ndarray:
        """Sparse (N, rank) int64 voxel coordinates, in the index's curve
        order and C order within each cuboid (paper Fig 9)."""
        grid = self.spec.grid(r)
        cells = self.index.cuboids(ann_id)
        packed = self.store.peek(r)
        if not cells or packed is None:
            return np.zeros((0, grid.rank), dtype=np.int64)
        rows = packed.index_select(
            0, torch.tensor(cells, dtype=torch.int64, device=packed.device))
        hit = (rows == _stored_id(ann_id)).nonzero().cpu().numpy()
        origins = morton.morton_decode(np.asarray(cells),
                                       grid.bits) * np.asarray(grid.cuboid_shape)
        return origins[hit[:, 0]] + hit[:, 1:]

    def centroid(self, ann_id: int, r: int) -> Optional[np.ndarray]:
        vox = self.voxel_list(ann_id, r)
        return vox.mean(axis=0) if len(vox) else None
