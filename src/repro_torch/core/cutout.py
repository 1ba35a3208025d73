"""The cutout engine on the device (paper §4.2, C2): sub-volume read/write.

A cutout clamps its box to the volume and assembles it with the
`cutout_gather` kernel straight from the packed tensor of the level and
channel.  A write is a read-modify-write of whole cuboids: the data is laid
into its cuboid-aligned box, split into cuboid blocks, merged with the
stored rows by the conflict discipline (paper §3.2) and scattered back.
Large writes and the hierarchy build walk the box in slabs of cuboid
planes so the temporaries stay bounded.

The ``exception`` discipline merges as ``preserve`` and reports every voxel
where a stored label and a new one differ (both nonzero) to
``on_conflict(m, origin, old_full, new_full)`` per cuboid, in ascending
Morton order, with numpy blocks of the full cuboid's shape in the
dataset's dtype, as the reference does.  The conflicts are found on the
device inside the merge; each slab brings its (cell, offset, old, new)
values to the host in one transfer.

`project` reduces a cutout along one axis (a tile, a MIP rendering, paper
§3.3) and `batch_cutout` cuts many boxes, one gather each.  Grids of rank
1-4 (a time series is rank 4) go through the same kernel.

Over a store with a host backing (`DeviceCuboidStore`), a cutout first
makes the cuboids of its Morton runs resident (``max_runs`` coarsens the
runs, which changes only which cuboids are loaded), and a write loads the
cuboids it touches, merges on the device and writes the merged cuboids
through to the backing before it returns.  `CutoutStats` counts as the
reference's, and the reference's spans (``plan``, ``assemble``,
``write.fetch``, ``write.store``) are opened around the same stages.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.cutout_gather.ops import build_plan, planned_gather
from ..obs import trace
from . import morton
from .cuboid import CuboidGrid, downsample_block, downsample_labels
from .distributed import as_device_tensor, pad_to_grid, signed_view, split_blocks
from .store import DeviceCuboidStore

# Elements per write/hierarchy slab: bounds the float64 temporaries of the
# image hierarchy at a few GiB.
SLAB_ELEMENTS = 1 << 29


Box = Tuple[Sequence[int], Sequence[int]]  # (lo, hi) half-open
DISCIPLINES = ("overwrite", "preserve", "exception")
ConflictSink = Callable[[int, Tuple[int, ...], np.ndarray, np.ndarray], None]


@dataclasses.dataclass
class CutoutStats:
    cuboids_read: int = 0
    runs: int = 0
    bytes_assembled: int = 0
    bytes_discarded: int = 0   # read-and-discarded due to misalignment
    zero_copy: int = 0         # aligned requests returned without a copy


def _count(stats: CutoutStats, grid: CuboidGrid, lo, hi, gshape, alo,
           n_runs: int, itemsize: int) -> None:
    """Add one cutout to ``stats`` as the reference counts it: its buffer
    is the cuboid-aligned box cut at the grid's edge."""
    cs = grid.cuboid_shape
    buf = [min((a // c + g) * c, n * c) - a
           for a, c, g, n in zip(alo, cs, gshape, grid.grid_shape)]
    out = [h - l for l, h in zip(lo, hi)]
    stats.cuboids_read += int(np.prod(gshape))
    stats.runs += n_runs
    stats.bytes_assembled += int(np.prod(out)) * itemsize
    stats.bytes_discarded += (int(np.prod(buf)) - int(np.prod(out))) * itemsize
    stats.zero_copy += int(list(lo) == list(alo) and buf == out)


def cutout(store: DeviceCuboidStore, r: int, lo: Sequence[int],
           hi: Sequence[int], channel: int = 0,
           stats: Optional[CutoutStats] = None,
           max_runs: Optional[int] = None) -> torch.Tensor:
    """Dense sub-volume [lo, hi) at resolution ``r``, on the store's device.

    Over a backing, the cuboids of the box's Morton runs (coarsened to at
    most ``max_runs``) are made resident first; the answer does not depend
    on ``max_runs``."""
    grid = store.spec.grid(r)
    lo, hi = grid.clamp_box(lo, hi)
    shape = [max(0, h - l) for l, h in zip(lo, hi)]
    if 0 in shape:
        return torch.zeros(shape, dtype=store.dtype, device=store.device)
    backed = store.backing is not None
    with trace.span("plan", r=r):
        runs = (grid.box_to_runs(lo, hi, max_runs=max_runs)
                if backed or stats is not None else None)
        gshape, cells, alo = build_plan(grid, lo, hi)
    if stats is not None:
        _count(stats, grid, lo, hi, gshape, alo, len(runs),
               np.dtype(store.spec.dtype).itemsize)
    with trace.span("assemble", cuboids=len(cells), runs=len(runs or ())):
        if backed:
            packed = store.ensure_resident(r, channel, morton.runs_to_indices(runs))
        else:
            packed = store.peek(r, channel)
            if packed is None:
                return torch.zeros(shape, dtype=store.dtype, device=store.device)
        plan = torch.from_numpy(cells).to(packed.device)
        return planned_gather(packed, plan, gshape, [l - a for l, a in zip(lo, alo)],
                              shape)


def _merge_rows(packed: torch.Tensor, cells: torch.Tensor,
                new: torch.Tensor, discipline: str,
                report: bool = False) -> Optional[torch.Tensor]:
    """Merge full-cuboid ``new`` blocks (a signed view for unsigned 16-64
    bit data, as `_write_box` passes them) into rows ``cells`` of
    ``packed``.

    ``overwrite``: nonzero new voxels win; ``preserve`` and ``exception``:
    nonzero stored voxels win.  Zeros in ``new`` never change a voxel, which
    is what lets callers pad partial cuboids with zeros.  With ``report``,
    the conflicts (old and new nonzero and different) come back as one
    uint8 tensor on the host: the int64 cells and flat offsets, then the
    old and new values in the packed dtype (`_unpack_conflicts`).
    """
    rows = signed_view(packed)
    old = rows.index_select(0, cells)
    if discipline == "overwrite":
        merged = torch.where(new != 0, new, old)
    else:
        merged = torch.where(old != 0, old, new)
    found = None
    if report:
        n = cells.shape[0]
        conflict = ((old != 0) & (new != 0) & (old != new)).reshape(n, -1)
        row, flat = conflict.nonzero().unbind(1)
        keys = torch.stack([cells[row], flat])
        vals = torch.stack([old.reshape(n, -1)[row, flat],
                            new.reshape(n, -1)[row, flat].to(rows.dtype)])
        found = torch.cat([keys.reshape(-1).view(torch.uint8),
                           vals.reshape(-1).view(torch.uint8)]).cpu()
    rows.index_copy_(0, cells, merged.to(rows.dtype))
    return found


def _unpack_conflicts(found: torch.Tensor, dtype: np.dtype):
    """(cells, flat offsets, old, new) numpy arrays of `_merge_rows`'s
    report; the values in the dataset's dtype (the packed bits)."""
    raw = found.numpy()
    k = raw.size // (16 + 2 * dtype.itemsize)
    keys = raw[:16 * k].view(np.int64).reshape(2, k)
    vals = raw[16 * k:].view(dtype).reshape(2, k)
    return keys[0], keys[1], vals[0], vals[1]


def _report_conflicts(grid: CuboidGrid, found: List[torch.Tensor],
                      dtype: np.dtype, on_conflict: ConflictSink) -> None:
    """Call ``on_conflict`` once per cuboid with a conflict, in ascending
    Morton order, with full-cuboid blocks holding the conflicting voxels'
    old and new values (zeros elsewhere)."""
    parts = [_unpack_conflicts(f, dtype) for f in found]
    cells, flats, olds, news = (np.concatenate(a) for a in zip(*parts))
    order = np.lexsort((flats, cells))
    cells, flats, olds, news = cells[order], flats[order], olds[order], news[order]
    starts = np.flatnonzero(np.diff(cells, prepend=-1))
    for a, b in zip(starts, list(starts[1:]) + [len(cells)]):
        old_full = np.zeros(grid.cuboid_shape, dtype=dtype)
        new_full = np.zeros(grid.cuboid_shape, dtype=dtype)
        old_full.reshape(-1)[flats[a:b]] = olds[a:b]
        new_full.reshape(-1)[flats[a:b]] = news[a:b]
        m = int(cells[a])
        on_conflict(m, grid.cuboid_origin(m), old_full, new_full)


def _slabs(glo0: int, ghi0: int, plane_elements: int):
    """Split the box-grid's first axis into runs of whole cuboid planes."""
    step = max(1, SLAB_ELEMENTS // max(1, plane_elements))
    for g in range(glo0, ghi0, step):
        yield g, min(ghi0, g + step)


def write_cutout(store: DeviceCuboidStore, r: int, lo: Sequence[int],
                 data, channel: int = 0, discipline: str = "overwrite",
                 on_conflict: Optional[ConflictSink] = None) -> None:
    """Write dense ``data`` (tensor or numpy) at offset ``lo``.

    Disciplines as the reference's (paper §3.2): ``overwrite``,
    ``preserve``, and ``exception``, which merges as ``preserve`` and calls
    ``on_conflict`` for each cuboid where labels collide (module
    docstring); the calls happen inside the store's write guard, so the
    order of reports follows the order of merges.  Over a backing, the
    touched cuboids are loaded before the guard is taken, and each slab's
    merged cuboids are written through before the next slab: when this
    returns, the backing's write path holds the write.
    """
    if discipline not in DISCIPLINES:
        raise ValueError(f"unknown discipline {discipline!r}")
    grid = store.spec.grid(r)
    lo = [int(l) for l in lo]
    hi = [l + s for l, s in zip(lo, data.shape)]
    clo, chi = grid.clamp_box(lo, hi)
    if any(l >= h for l, h in zip(clo, chi)):
        return
    cs = grid.cuboid_shape
    plane = int(np.prod([-(-h // c) - l // c for l, h, c in
                         zip(clo[1:], chi[1:], cs[1:])])) * grid.cuboid_voxels
    report = discipline == "exception" and on_conflict is not None
    found = []
    if store.backing is not None:
        cells = build_plan(grid, clo, chi)[1]
        with trace.span("write.fetch", cuboids=len(cells)):
            store.ensure_resident(r, channel, cells)
    with store.write_guard:
        packed = store.level(r, channel)
        for g0, g1 in _slabs(clo[0] // cs[0], -(-chi[0] // cs[0]), plane):
            slo = [max(clo[0], g0 * cs[0])] + clo[1:]
            shi = [min(chi[0], g1 * cs[0])] + chi[1:]
            src = data[tuple(slice(a - l, b - l)
                             for a, b, l in zip(slo, shi, lo))]
            cells, part = _write_box(packed, grid, slo, shi,
                                     as_device_tensor(src, store.device), discipline,
                                     report=report)
            store.write_through(r, channel, cells)
            if part is not None and part.numel():
                found.append(part)
        if found:
            _report_conflicts(grid, found, np.dtype(store.spec.dtype),
                              on_conflict)


def _write_box(packed: torch.Tensor, grid: CuboidGrid, lo, hi,
               data: torch.Tensor, discipline: str,
               keep: Optional[torch.Tensor] = None,
               report: bool = False) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """Merge ``data`` (exactly the box [lo, hi)) into the packed level;
    ``keep`` (bool per box-grid cell, row-major) restricts the cells.
    Returns the merged cells (Morton indices) and, with ``report``, the
    conflicts (`_merge_rows`)."""
    gshape, cells, alo = build_plan(grid, lo, hi)
    cs = grid.cuboid_shape
    rel = [l - a for l, a in zip(lo, alo)]
    data = signed_view(data)  # the card has no boolean indexing of uint16
    aligned = torch.zeros([g * c for g, c in zip(gshape, cs)],
                          dtype=data.dtype, device=data.device)
    aligned[tuple(slice(a, a + s) for a, s in zip(rel, data.shape))] = data
    blocks = split_blocks(aligned, gshape, cs)
    cells = cells.astype(np.int64)
    if keep is not None:
        cells = cells[keep.cpu().numpy()]
        blocks = blocks[keep]
    cells_t = torch.from_numpy(cells).to(packed.device)
    return cells, _merge_rows(packed, cells_t, blocks, discipline, report=report)


def project(store: DeviceCuboidStore, r: int, lo: Sequence[int],
            hi: Sequence[int], axis: int, reduce: str = "slice",
            channel: int = 0) -> torch.Tensor:
    """Lower-dimensional projection of [lo, hi) (paper §3.3 tiles).

    ``slice`` takes the first plane along ``axis`` (a tile request; only
    that plane is cut out); ``max`` and ``mean`` reduce along it (MIP
    renderings).  As numpy on the reference's arrays: unsigned data
    (uint16, and uint32 labels held as int32) compares by its unsigned
    value; an integer ``mean`` sums in float64 (exact) and truncates back to
    the dtype; a float ``mean`` stays in its own dtype (numpy's pairwise
    float32 sum rounds differently: equal within a relative 1e-6).
    """
    if reduce not in ("slice", "max", "mean"):
        raise ValueError(f"unknown reduce {reduce!r}")
    grid = store.spec.grid(r)
    lo, hi = grid.clamp_box(lo, hi)
    if reduce == "slice":
        if hi[axis] <= lo[axis]:
            raise IndexError(f"no plane to take along axis {axis} of [{lo}, {hi})")
        hi[axis] = lo[axis] + 1
        return cutout(store, r, lo, hi, channel).select(axis, 0)
    vol = cutout(store, r, lo, hi, channel)
    if vol.is_floating_point():
        return (vol.amax(axis) if reduce == "max" else vol.mean(axis))
    wide = vol.to(torch.int64)
    if np.dtype(store.spec.dtype) == np.uint32:
        wide &= 0xFFFFFFFF
    if reduce == "max":
        out = wide.amax(axis)
    else:
        out = (wide.to(torch.float64).sum(axis) / vol.shape[axis]).to(torch.int64)
    return out.to(vol.dtype)  # int64 -> int32 keeps a uint32 label's bits


def batch_cutout(store: DeviceCuboidStore, r: int, boxes: Sequence[Box],
                 channel: int = 0) -> List[torch.Tensor]:
    """Cutouts of many boxes (paper §4.2's batch interface), in request
    order, one gather each.  Over a cluster the boxes overlap on its
    request-level pool (``run_batch``), so one box's cold loads pipeline
    with another's; over any other store they run one after another."""
    jobs = [functools.partial(cutout, store, r, lo, hi, channel) for lo, hi in boxes]
    runner = getattr(store.backing, "run_batch", None)
    if runner is None:
        return [job() for job in jobs]
    return list(runner(jobs))


def ingest(store: DeviceCuboidStore, r: int, volume, channel: int = 0,
           offset: Optional[Sequence[int]] = None) -> None:
    """Bulk-load a dense volume (instrument -> store ingest path)."""
    write_cutout(store, r, list(offset or [0] * volume.ndim), volume, channel,
                 discipline="overwrite")


def build_hierarchy(store: DeviceCuboidStore, channel: int = 0,
                    labels: bool = False) -> None:
    """Propagate level r -> r+1 for the whole dataset (paper §3.2).

    Image data average-pools the scaled dims; label data stride-samples so
    identifiers survive.  Vectorised over destination cuboids, one slab of
    cuboid planes at a time: the source region of the slab is one cutout,
    and a destination cuboid whose source region is all zero is skipped
    (not written), as the reference skips it.  Over a backing the written
    cuboids are loaded first and written through, as `write_cutout` does.
    """
    spec = store.spec
    f = [2 if d in spec.scaled_dims else 1 for d in range(spec.spatial_rank)]
    for r in range(spec.n_resolutions - 1):
        if store.backing is None and store.peek(r, channel) is None:
            continue  # nothing stored at r: every destination is skipped
        dst = spec.grid(r + 1)
        cs = dst.cuboid_shape
        plane = int(np.prod(dst.grid_shape[1:])) * dst.cuboid_voxels
        plane *= int(np.prod(f))  # source voxels per destination voxel
        for g0, g1 in _slabs(0, dst.grid_shape[0], plane):
            dlo = [g0 * cs[0]] + [0] * (dst.rank - 1)
            dhi = [min(g1 * cs[0], dst.volume_shape[0])] + list(
                dst.volume_shape[1:])
            block = cutout(store, r, [l * k for l, k in zip(dlo, f)],
                           [h * k for h, k in zip(dhi, f)], channel)
            gshape = [-(-(h - l) // c) for l, h, c in zip(dlo, dhi, cs)]
            src_cs = [c * k for c, k in zip(cs, f)]
            nonzero = split_blocks(pad_to_grid(block != 0, gshape, src_cs),
                                   gshape, src_cs).flatten(1).any(1)
            if not bool(nonzero.any()):
                continue
            down = (downsample_labels(block, spec.scaled_dims) if labels
                    else downsample_block(block, spec.scaled_dims))
            if 0 in down.shape:
                continue
            dhi = [l + s for l, s in zip(dlo, down.shape)]
            if store.backing is not None:
                cells = build_plan(dst, dlo, dhi)[1][nonzero.cpu().numpy()]
                store.ensure_resident(r + 1, channel, cells)
            with store.write_guard:
                cells, _ = _write_box(store.level(r + 1, channel), dst, dlo, dhi, down,
                                      "overwrite", keep=nonzero)
                store.write_through(r + 1, channel, cells)
