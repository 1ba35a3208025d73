"""The cutout engine on the device (paper §4.2, C2): sub-volume read/write.

A cutout clamps its box to the volume and assembles it with the
`cutout_gather` kernel straight from the level's packed tensor.  A write is
a read-modify-write of whole cuboids: the data is laid into its
cuboid-aligned box, split into cuboid blocks, merged with the stored rows
by the conflict discipline (paper §3.2) and scattered back.  Large writes
and the hierarchy build walk the box in slabs of cuboid planes so the
temporaries stay bounded.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.cutout_gather.ops import build_plan, cutout_gather
from .cuboid import CuboidGrid, downsample_block, downsample_labels
from .distributed import pad_to_grid, signed_view, split_blocks
from .store import DeviceCuboidStore

# Elements per write/hierarchy slab: bounds the float64 temporaries of the
# image hierarchy at a few GiB.
SLAB_ELEMENTS = 1 << 29


def as_device_tensor(data, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or numpy array; uint32 labels
    become int32 with the same bits (ids at or above 2^31 turn negative)."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    arr = np.asarray(data)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def cutout(store: DeviceCuboidStore, r: int, lo: Sequence[int],
           hi: Sequence[int]) -> torch.Tensor:
    """Dense sub-volume [lo, hi) at resolution ``r``, on the store's device."""
    grid = store.spec.grid(r)
    lo, hi = grid.clamp_box(lo, hi)
    shape = [max(0, h - l) for l, h in zip(lo, hi)]
    packed = store.peek(r)
    if packed is None or 0 in shape:
        return torch.zeros(shape, dtype=store.dtype, device=store.device)
    return cutout_gather(packed, grid, lo, hi)


def _merge_rows(packed: torch.Tensor, cells: torch.Tensor,
                new: torch.Tensor, discipline: str) -> None:
    """Merge full-cuboid ``new`` blocks into rows ``cells`` of ``packed``.

    ``overwrite``: nonzero new voxels win; ``preserve``: nonzero stored
    voxels win.  Zeros in ``new`` never change a voxel under either, which
    is what lets callers pad partial cuboids with zeros.
    """
    rows = signed_view(packed)
    old = rows.index_select(0, cells)
    if new.dtype == packed.dtype:
        new = signed_view(new)
    if discipline == "overwrite":
        merged = torch.where(new != 0, new, old)
    else:
        merged = torch.where(old != 0, old, new)
    rows.index_copy_(0, cells, merged.to(rows.dtype))


def _slabs(glo0: int, ghi0: int, plane_elements: int):
    """Split the box-grid's first axis into runs of whole cuboid planes."""
    step = max(1, SLAB_ELEMENTS // max(1, plane_elements))
    for g in range(glo0, ghi0, step):
        yield g, min(ghi0, g + step)


def write_cutout(store: DeviceCuboidStore, r: int, lo: Sequence[int],
                 data, discipline: str = "overwrite") -> None:
    """Write dense ``data`` (tensor or numpy) at offset ``lo``.

    Disciplines as the reference's ``overwrite``/``preserve`` (paper §3.2);
    ``exception`` (multi-label exception lists) is not ported yet.
    """
    if discipline == "exception":
        raise NotImplementedError("the exception discipline is not ported")
    if discipline not in ("overwrite", "preserve"):
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
    with store.write_guard:
        packed = store.level(r)
        for g0, g1 in _slabs(clo[0] // cs[0], -(-chi[0] // cs[0]), plane):
            slo = [max(clo[0], g0 * cs[0])] + clo[1:]
            shi = [min(chi[0], g1 * cs[0])] + chi[1:]
            src = data[tuple(slice(a - l, b - l)
                             for a, b, l in zip(slo, shi, lo))]
            _write_box(packed, grid, slo, shi,
                       as_device_tensor(src, store.device), discipline)


def _write_box(packed: torch.Tensor, grid: CuboidGrid, lo, hi,
               data: torch.Tensor, discipline: str,
               keep: Optional[torch.Tensor] = None) -> None:
    """Merge ``data`` (exactly the box [lo, hi)) into the packed level;
    ``keep`` (bool per box-grid cell, row-major) restricts the cells."""
    gshape, cells, alo = build_plan(grid, lo, hi)
    cs = grid.cuboid_shape
    rel = [l - a for l, a in zip(lo, alo)]
    aligned = torch.zeros([g * c for g, c in zip(gshape, cs)],
                          dtype=data.dtype, device=data.device)
    aligned[tuple(slice(a, a + s) for a, s in zip(rel, data.shape))] = data
    blocks = split_blocks(aligned, gshape, cs)
    cells_t = torch.from_numpy(cells.astype(np.int64)).to(packed.device)
    if keep is not None:
        cells_t, blocks = cells_t[keep], blocks[keep]
    _merge_rows(packed, cells_t, blocks, discipline)


def ingest(store: DeviceCuboidStore, r: int, volume,
           offset: Optional[Sequence[int]] = None) -> None:
    """Bulk-load a dense volume (instrument -> store ingest path)."""
    write_cutout(store, r, list(offset or [0] * volume.ndim), volume,
                 discipline="overwrite")


def build_hierarchy(store: DeviceCuboidStore, labels: bool = False) -> None:
    """Propagate level r -> r+1 for the whole dataset (paper §3.2).

    Image data average-pools the scaled dims; label data stride-samples so
    identifiers survive.  Vectorised over destination cuboids, one slab of
    cuboid planes at a time: the source region of the slab is one cutout,
    and a destination cuboid whose source region is all zero is skipped
    (not written), as the reference skips it.
    """
    spec = store.spec
    f = [2 if d in spec.scaled_dims else 1 for d in range(spec.spatial_rank)]
    for r in range(spec.n_resolutions - 1):
        if store.peek(r) is None:
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
                           [h * k for h, k in zip(dhi, f)])
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
            with store.write_guard:
                _write_box(store.level(r + 1), dst, dlo,
                           [l + s for l, s in zip(dlo, down.shape)], down,
                           "overwrite", keep=nonzero)
