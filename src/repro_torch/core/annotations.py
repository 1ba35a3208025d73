"""Annotation projects: RAMON-like metadata + device label volumes (§3.2).

An `AnnotationProject` pairs a host metadata table (a small RAMON-like
ontology with predicate queries) and a host object index with a label
database held as a `DeviceCuboidStore` registered to an image dataset,
with per-cuboid exception lists for multiply labelled voxels (the
``exception`` write discipline), object queries (cutout, bounding box,
region, voxel list, distance) and deferred propagation of the label
hierarchy.
Labels are uint32 identifiers in the reference; on the device they are
held as int32 with the same bits, so an id at or above 2^31 is stored as
a negative int32.  Ids are uint32 at every boundary: index keys and
metadata use the unsigned value (`_uint_ids`), writes reinterpret uint32
labels bit for bit, and reads compare against an id's int32 view
(`_stored_id`); the numpy boundary (`carry`) hands back uint32.

The batch write applies many objects as one voxel scatter with the same
result as writing them one after another: for ``overwrite`` the last
object that covers a voxel wins, for ``preserve`` a stored label is kept
and otherwise the first object wins.  Under ``exception`` (or on a
readonly project) it writes object by object through `write`, as the
reference does, so a later object's conflicts with an earlier one are
listed.

With a ``backend`` or ``write_path_backend`` the label store is a
`DeviceCuboidStore` over a host `CuboidStore` of those backends, as the
reference keeps its labels: reads load cuboids on first touch and every
write (the batch scatter included, object box by object box as the
reference writes them) goes through to the backing before it returns.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from . import morton
from .cuboid import DatasetSpec
from ..kernels.cutout_gather.ops import build_plan
from .cutout import as_device_tensor, build_hierarchy, cutout, write_cutout
from .distributed import signed_view
from .spatial_index import ObjectIndex
from .store import Backend, CuboidStore, DeviceCuboidStore

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
    """Key/value predicate queries over annotation metadata (paper §4.2).

    Auto ids follow the reference: after a create the next one is the
    largest id in the table plus one.  The table keeps that largest id as
    it goes (the reference rescans every row per create, which is
    quadratic) and recomputes it only when `delete` removes it.
    """

    def __init__(self):
        self._rows: Dict[int, Annotation] = {}
        self._next_id = 1  # the next auto id
        self._max_id = 0   # largest id in the table
        self._lock = threading.Lock()

    def _take_id(self) -> int:
        ann_id = self._next_id
        self._next_id += 1
        return ann_id

    def create(self, ann: Optional[Annotation] = None, **kwargs) -> Annotation:
        with self._lock:
            if ann is None:
                ann_id = kwargs.pop("ann_id", None) or self._take_id()
                ann = Annotation(ann_id=ann_id, **kwargs)
            elif ann.ann_id in (0, None):
                ann.ann_id = self._take_id()
            if ann.ann_type not in RAMON_TYPES:
                raise ValueError(f"unknown RAMON type {ann.ann_type!r}")
            self._rows[ann.ann_id] = ann
            self._max_id = max(self._max_id, ann.ann_id)
            self._next_id = self._max_id + 1
            return ann

    def get(self, ann_id: int) -> Optional[Annotation]:
        return self._rows.get(int(ann_id))

    def update(self, ann_id: int, **fields) -> Annotation:
        ann = self._rows[int(ann_id)]
        for k, v in fields.items():
            if hasattr(ann, k):
                setattr(ann, k, v)
            else:
                ann.kv[k] = v
        return ann

    def delete(self, ann_id: int) -> None:
        with self._lock:
            if self._rows.pop(int(ann_id), None) is not None \
                    and int(ann_id) == self._max_id:
                self._max_id = max(self._rows, default=0)

    def query(self, *predicates: Tuple[str, str, Any]) -> List[int]:
        """Conjunctive predicates: [(field, op, value), ...] -> ids."""
        out = []
        for ann_id, ann in self._rows.items():
            if all(ann.matches(f, op, v) for f, op, v in predicates):
                out.append(ann_id)
        return sorted(out)

    def __len__(self):
        return len(self._rows)


class AnnotationProject:
    """One annotation database registered to an image dataset (paper §3.2).

    ``enable_exceptions`` lets writes use the ``exception`` discipline,
    which keeps the stored label and lists each conflicting new label per
    cuboid (`exceptions_at`, `voxel_labels`); ``readonly`` refuses writes.
    ``backend`` and ``write_path_backend`` put the labels on a host
    `CuboidStore` of those backends (zlib level 1) under the device store;
    ``store_factory(spec)`` builds the store instead.
    """

    def __init__(self, name: str, image_spec: DatasetSpec,
                 enable_exceptions: bool = False, readonly: bool = False,
                 device: DeviceLike = "cuda",
                 backend: Optional[Backend] = None,
                 write_path_backend: Optional[Backend] = None,
                 store_factory: Optional[Callable[[DatasetSpec], Any]] = None):
        self.name = name
        self.spec = dataclasses.replace(
            image_spec, name=f"{image_spec.name}/{name}", dtype="uint32",
            n_channels=1)
        if store_factory is not None:
            self.store = store_factory(self.spec)
        elif backend is not None or write_path_backend is not None:
            self.store = DeviceCuboidStore(self.spec, device=device, backing=CuboidStore(
                self.spec, backend=backend, write_path_backend=write_path_backend,
                compression_level=1))
        else:
            self.store = DeviceCuboidStore(self.spec, device=device)
        self.meta = MetadataTable()
        self.index = ObjectIndex()
        self.enable_exceptions = enable_exceptions
        self.readonly = readonly
        # (resolution, morton) -> [(flat voxel offset, label)], appended per
        # write in ascending offset
        self._exceptions: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        self._dirty_levels: set[int] = set()

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
              discipline: str = "overwrite", update_index: bool = True) -> None:
        """Write a labelled volume with a conflict discipline (paper §3.2).

        Visible at resolution ``r`` at once; other levels stay stale until
        `propagate` (deferred consistency, paper §3.2).
        """
        if self.readonly:
            raise PermissionError(f"project {self.name} is readonly")
        if discipline == "exception" and not self.enable_exceptions:
            raise ValueError("exceptions not enabled for this project")
        labels = as_device_tensor(labels, self.store.device)
        # uint32 ids keep their bits; other integer labels are cast
        labels = (labels.view(torch.int32) if labels.dtype == torch.uint32
                  else labels.to(torch.int32))
        sink = self._exception_sink(r) if discipline == "exception" else None
        write_cutout(self.store, r, lo, labels, discipline=discipline,
                     on_conflict=sink)
        self._dirty_levels.add(r)
        if update_index:
            nz = labels.nonzero()
            coords = nz + torch.tensor([int(l) for l in lo], device=nz.device)
            keep = self._in_volume(r, coords)
            self._index_voxels(r, coords[keep], labels[tuple(nz[keep].T)])

    def _exception_sink(self, r: int):
        def sink(m, origin, old_block, new_block):
            flat_new = new_block.ravel()
            offs = np.flatnonzero(flat_new)
            self._exceptions.setdefault((r, m), []).extend(
                zip(offs.tolist(), flat_new[offs].tolist()))
        return sink

    def batch_write_objects(
            self, r: int,
            objects: List[Tuple[Annotation, Sequence[int], Any]],
            discipline: str = "overwrite") -> List[int]:
        """Write many (metadata, offset, labelled-volume) at once.

        The paper doubled synapse-finder throughput batching 40 writes; for
        ``overwrite`` and ``preserve`` the whole batch is one voxel scatter
        and one index transaction.  Otherwise (``exception``, a readonly
        project, an unknown discipline) the objects go one by one through
        `write`, which lists conflicts or raises as the reference does.
        """
        dev = self.store.device
        if discipline not in ("overwrite", "preserve") or self.readonly:
            ids = []
            for ann, lo, vol in objects:
                ann = self.meta.create(ann)
                ids.append(ann.ann_id)
                mask = as_device_tensor(vol, dev) != 0
                self.write(r, lo, mask.to(torch.int32) * _stored_id(ann.ann_id),
                           discipline=discipline)
            return ids
        ids, masks, shapes, los = [], [], [], []
        for ann, lo, vol in objects:
            ids.append(self.meta.create(ann).ann_id)
            t = as_device_tensor(vol, dev)
            masks.append((t != 0).reshape(-1))
            shapes.append(tuple(t.shape))
            los.append([int(l) for l in lo])
        if not ids:
            return ids
        self._dirty_levels.add(r)
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
        boxes = (self._box_cells(r, los, shapes) if self.store.backing is not None
                 else [])
        self._scatter_labels(r, coords_t, order_t, ids_t, discipline, boxes)
        self._index_voxels(r, coords_t, ids_t[order_t])
        return ids

    def _box_cells(self, r: int, los, shapes) -> List[np.ndarray]:
        """Each object's clamped box as Morton cells (none outside the
        volume): the cuboids the reference writes for it."""
        grid = self.spec.grid(r)
        out = []
        for lo, shape in zip(los, shapes):
            clo, chi = grid.clamp_box(lo, [l + s for l, s in zip(lo, shape)])
            out.append(build_plan(grid, clo, chi)[1].astype(np.int64)
                       if all(l < h for l, h in zip(clo, chi))
                       else np.zeros(0, np.int64))
        return out

    def _scatter_labels(self, r: int, coords: torch.Tensor,
                        order: torch.Tensor, ids: torch.Tensor,
                        discipline: str, boxes: List[np.ndarray]) -> None:
        """One voxel scatter of the batch; over a backing the objects'
        box cuboids are loaded first and written through after, object by
        object, so the backing holds and counts what the reference's
        per-object writes leave."""
        if boxes:
            self.store.ensure_resident(r, 0, np.concatenate(boxes))
        if coords.shape[0] == 0:
            with self.store.write_guard:
                for cells in boxes:
                    self.store.write_through(r, 0, cells)
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
            for cells in boxes:
                self.store.write_through(r, 0, cells)

    # -- read ---------------------------------------------------------------
    def read(self, r: int, lo: Sequence[int], hi: Sequence[int],
             with_exceptions: bool = False) -> torch.Tensor:
        """Dense int32 labels of [lo, hi) on the project's device: the
        primary labels (exceptions through `exceptions_at` and
        `voxel_labels`, as in the reference, whatever ``with_exceptions``
        says)."""
        return cutout(self.store, r, lo, hi)

    def exceptions_at(self, r: int, m: int) -> List[Tuple[int, int]]:
        return list(self._exceptions.get((r, m), ()))

    def voxel_labels(self, r: int, voxel: Sequence[int]) -> List[int]:
        """All labels at one voxel: primary + exceptions (paper §3.2)."""
        grid = self.spec.grid(r)
        m = grid.cuboid_of_voxel(voxel)
        local = tuple(int(v) - o for v, o in zip(voxel, grid.cuboid_origin(m)))
        if self.store.backing is not None:
            self.store.ensure_resident(r, 0, [m])
        packed = self.store.peek(r)
        primary = 0 if packed is None else int(packed[(m,) + local]) & 0xFFFFFFFF
        labels = [primary] if primary else []
        flat = int(np.ravel_multi_index(local, grid.cuboid_shape))
        for off, lab in self._exceptions.get((r, m), ()):
            if off == flat and lab not in labels:
                labels.append(lab)
        return labels

    # -- object-level queries (paper §4.2) -----------------------------------
    def object_cutout(self, ann_id: int, r: int,
                      box: Optional[Tuple[Sequence[int], Sequence[int]]] = None
                      ) -> Tuple[List[int], torch.Tensor]:
        """One object's labels within its index bounding box (or ``box``),
        other ids set to 0; int32 holding the uint32 ids on the device."""
        bbox = box or self.index.bounding_box(ann_id, self.spec.grid(r))
        if bbox is None:
            rank = self.spec.spatial_rank
            return [0] * rank, torch.zeros((0,) * rank, dtype=torch.int32,
                                           device=self.store.device)
        lo, hi = bbox
        dense = self.read(r, lo, hi)
        return list(lo), torch.where(dense == _stored_id(ann_id), dense, 0)

    def objects_in_region(self, r: int, lo, hi) -> List[int]:
        """The ids in a region, ascending by their uint32 value."""
        ids = torch.unique(_uint_ids(self.read(r, lo, hi))).tolist()
        return [i for i in ids if i]

    def bounding_box(self, ann_id: int, r: int):
        return self.index.bounding_box(ann_id, self.spec.grid(r))

    def batch_read_objects(self, ann_ids: Sequence[int], r: int):
        return {i: self.object_cutout(i, r) for i in ann_ids}

    def _voxels(self, ann_id: int, r: int) -> torch.Tensor:
        """(N, rank) int64 voxel coordinates on the device, in the index's
        curve order and C order within each cuboid (paper Fig 9)."""
        grid = self.spec.grid(r)
        cells = self.index.cuboids(ann_id)
        if cells and self.store.backing is not None:
            self.store.ensure_resident(r, 0, cells)
        packed = self.store.peek(r)
        if not cells or packed is None:
            return torch.zeros((0, grid.rank), dtype=torch.int64,
                               device=self.store.device)
        rows = packed.index_select(
            0, torch.tensor(cells, dtype=torch.int64, device=packed.device))
        hit = (rows == _stored_id(ann_id)).nonzero()
        origins = torch.from_numpy(morton.morton_decode(
            np.asarray(cells), grid.bits) * np.asarray(grid.cuboid_shape))
        return origins.to(packed.device)[hit[:, 0]] + hit[:, 1:]

    def voxel_list(self, ann_id: int, r: int) -> np.ndarray:
        """Sparse (N, rank) int64 voxel coordinates, in the index's curve
        order and C order within each cuboid (paper Fig 9)."""
        return self._voxels(ann_id, r).cpu().numpy()

    # -- hierarchy (deferred consistency) ------------------------------------
    def propagate(self) -> None:
        """Rebuild the label hierarchy (stride-sampled, paper §3.2): until
        it runs, annotations are visible only at their write resolution."""
        build_hierarchy(self.store, labels=True)
        self._dirty_levels.clear()

    @property
    def pending_propagation(self) -> bool:
        return bool(self._dirty_levels) and self.spec.n_resolutions > 1

    # -- spatial analysis (paper §2) -----------------------------------------
    def centroid(self, ann_id: int, r: int) -> Optional[np.ndarray]:
        vox = self.voxel_list(ann_id, r)
        return vox.mean(axis=0) if len(vox) else None

    def distance(self, a: int, b: int, r: int) -> float:
        """Least voxel-to-voxel distance between two objects (synapse to
        dendrite, paper §2): the least squared distance in int64 on the
        device, chunked, then one square root, which equals the
        reference's float64 norm on integer coordinates bit for bit."""
        va, vb = self._voxels(a, r), self._voxels(b, r)
        if not len(va) or not len(vb):
            return float("inf")
        step = max(1, (1 << 22) // len(vb))
        best = None
        for i in range(0, len(va), step):
            d2 = (va[i:i + step, None, :] - vb[None]).square().sum(-1).min()
            best = d2 if best is None else torch.minimum(best, d2)
        return math.sqrt(int(best))
