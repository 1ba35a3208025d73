"""The device-resident cuboid-major layout and the multi-rank cutout
(paper §4.1 C3).

The volume lives on the device as one array of shape
``(n_cells, *cuboid_shape)`` whose row index IS the Morton index: a cutout
is a gather of the planned rows plus a trim (`kernels.cutout_gather`).
Rows for the power-of-two padding cells past the volume are zero, so the
index stays dense (lazy cuboids, paper §3.2).

Packing and unpacking are vectorised reshape/permute plus one row scatter
(or gather) on the tensor's own device.

Across ranks of a ``torch.distributed`` group (the paper's database
nodes), each rank holds one contiguous segment of the curve
(`shard_cuboids`, `morton.partition_curve`).  `distributed_cutout`:
(1) each rank gathers the box's cells it owns with `cutout_gather` (a row
gather over a ``(max_k, 1, ...)`` box grid), (2) ``all_gather`` of those
rows, (3) a second `cutout_gather` over the gathered rows puts them in
box-grid order and trims.  Only the touched cells move.
`distributed_write_cutout` applies, on each rank, the cells it owns.  The
group is set up by the caller with an explicit ``init_method``
(``torch.distributed.init_process_group``); one rank per card with NCCL,
any number on the CPU with gloo.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import morton
from .cuboid import CuboidGrid

_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """Same-width signed view of an unsigned 16/32/64-bit tensor.

    PyTorch implements ``index_select``/``index_copy_`` for few of the wide
    unsigned types; data movement through a signed view of the same width
    is byte-exact.
    """
    signed = _SIGNED_OF.get(t.dtype)
    return t if signed is None else t.view(signed)


def as_device_tensor(data, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or numpy array; uint32 labels
    become int32 with the same bits (ids at or above 2^31 turn negative)."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    arr = np.asarray(data)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def grid_cells(grid: CuboidGrid) -> np.ndarray:
    """Morton index of every grid position, in row-major grid order."""
    axes = np.meshgrid(*[np.arange(g) for g in grid.grid_shape], indexing="ij")
    coords = np.stack([a.ravel() for a in axes], axis=-1)
    return morton.morton_encode(coords, grid.bits)


def split_blocks(vol: torch.Tensor, gshape, cs) -> torch.Tensor:
    """(g0*c0, g1*c1, ...) -> (g0*g1*..., c0, c1, ...), row-major grid order."""
    rank = len(cs)
    inter = [n for g, c in zip(gshape, cs) for n in (g, c)]
    perm = list(range(0, 2 * rank, 2)) + list(range(1, 2 * rank, 2))
    return vol.reshape(inter).permute(perm).reshape((-1,) + tuple(cs))


def merge_blocks(blocks: torch.Tensor, gshape, cs) -> torch.Tensor:
    """Inverse of `split_blocks`: interleave grid and cuboid axes, merge."""
    rank = len(cs)
    perm = [a for d in range(rank) for a in (d, rank + d)]
    return blocks.reshape(tuple(gshape) + tuple(cs)).permute(perm).reshape(
        tuple(g * c for g, c in zip(gshape, cs)))


def pad_to_grid(volume: torch.Tensor, gshape, cs) -> torch.Tensor:
    """Zero-pad a dense volume at its high end to whole cuboids."""
    pad = []
    for v, g, c in reversed(list(zip(volume.shape, gshape, cs))):
        pad += [0, g * c - v]
    if not any(pad):
        return volume
    return F.pad(volume, pad)


def pack_to_cuboids(volume: torch.Tensor, grid: CuboidGrid) -> torch.Tensor:
    """Dense volume -> (n_cells, *cuboid_shape), rows in Morton order."""
    if tuple(volume.shape) != tuple(grid.volume_shape):
        raise ValueError(f"volume shape {tuple(volume.shape)} != "
                         f"{grid.volume_shape}")
    cs = grid.cuboid_shape
    src = signed_view(volume)
    blocks = split_blocks(pad_to_grid(src, grid.grid_shape, cs),
                          grid.grid_shape, cs)
    cells = torch.as_tensor(grid_cells(grid), device=volume.device)
    out = torch.zeros((grid.n_cells,) + tuple(cs), dtype=src.dtype,
                      device=volume.device)
    out.index_copy_(0, cells, blocks)
    return out.view(volume.dtype)


def unpack_from_cuboids(packed: torch.Tensor, grid: CuboidGrid) -> torch.Tensor:
    """(n_cells, *cuboid_shape) -> the dense volume (padding dropped)."""
    cells = torch.as_tensor(grid_cells(grid), device=packed.device)
    blocks = signed_view(packed).index_select(0, cells)
    merged = merge_blocks(blocks, grid.grid_shape, grid.cuboid_shape)
    vol = merged[tuple(slice(0, v) for v in grid.volume_shape)]
    return vol.contiguous().view(packed.dtype)


# -- multi-rank ----------------------------------------------------------

def shard_cuboids(packed: torch.Tensor, rank: int, world_size: int) -> torch.Tensor:
    """Rank ``rank``'s curve segment of a packed level: rows [a, b) of
    `morton.partition_curve` (the first ``n_cells % world_size`` ranks
    take one row more), as a view of ``packed``."""
    a, b = morton.partition_curve(packed.shape[0], world_size)[rank]
    return packed[a:b]


def _cutout_plan(grid: CuboidGrid, lo, hi, n_ranks: int):
    """Static plan: per-rank padded row lists + the assembly permutation."""
    cs = grid.cuboid_shape
    glo = [l // c for l, c in zip(lo, cs)]
    ghi = [-(-h // c) for h, c in zip(hi, cs)]
    gshape = tuple(h - l for l, h in zip(glo, ghi))
    mesh_idx = np.meshgrid(*[np.arange(l, h) for l, h in zip(glo, ghi)],
                           indexing="ij")
    coords = np.stack([g.ravel() for g in mesh_idx], axis=-1)
    cells = morton.morton_encode(coords, grid.bits)          # box-grid order
    n_box = len(cells)

    seg = morton.partition_curve(grid.n_cells, n_ranks)
    owner = morton.owner_of(cells, grid.n_cells, n_ranks)
    counts = np.bincount(owner, minlength=n_ranks)
    max_k = max(1, int(counts.max()))
    local_idx = np.zeros((n_ranks, max_k), dtype=np.int32)
    slot_of = np.zeros(n_box, dtype=np.int64)  # rank * max_k + slot per cell
    fill = [0] * n_ranks
    for i, (c, o) in enumerate(zip(cells, owner)):
        s = fill[o]
        local_idx[o, s] = c - seg[o][0]     # row within the rank's shard
        slot_of[i] = o * max_k + s
        fill[o] += 1
    return gshape, local_idx, slot_of, max_k


def distributed_cutout(shard: torch.Tensor, grid: CuboidGrid,
                       lo: Sequence[int], hi: Sequence[int],
                       group=None) -> torch.Tensor:
    """Dense cutout of [lo, hi) from a curve-sharded level; every rank of
    ``group`` calls it with its own shard (`shard_cuboids`) and gets the
    whole box on its shard's device.  The box is not clamped (as the
    reference's): it must lie in the grid's power-of-two extent."""
    from ..kernels.cutout_gather.ops import planned_gather  # imports this module

    lo = tuple(int(x) for x in lo)
    hi = tuple(int(x) for x in hi)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    gshape, local_idx, slot_of, max_k = _cutout_plan(grid, lo, hi, world)
    cs = tuple(grid.cuboid_shape)
    dev = shard.device
    rows_shape = (max_k * cs[0],) + cs[1:]
    if shard.shape[0]:
        mine = torch.from_numpy(local_idx[rank]).to(dev)
        rows = planned_gather(shard, mine, (max_k,) + (1,) * (len(cs) - 1),
                              [0] * len(cs), rows_shape)
    else:  # a rank that owns no row (more ranks than cells)
        rows = torch.zeros(rows_shape, dtype=shard.dtype, device=dev)
    gathered = torch.empty((world * max_k,) + cs, dtype=shard.dtype, device=dev)
    # bytes, so that every dtype crosses (NCCL has no 16-bit integers)
    dist.all_gather(list(gathered.view(torch.uint8).chunk(world)),
                    rows.reshape((max_k,) + cs).view(torch.uint8), group=group)
    plan = torch.from_numpy(slot_of.astype(np.int32)).to(dev)
    alo = [l // c * c for l, c in zip(lo, cs)]
    return planned_gather(gathered, plan, gshape, [l - a for l, a in zip(lo, alo)],
                          [h - l for l, h in zip(lo, hi)])


def distributed_write_cutout(shard: torch.Tensor, grid: CuboidGrid,
                             lo: Sequence[int], data, group=None) -> torch.Tensor:
    """Write ``data`` (tensor or numpy, the same on every rank) at ``lo``
    into a curve-sharded level: each rank applies the cells it owns to its
    own shard, so no write crosses ranks (paper §4.1).

    Every voxel of the box is written, zeros included (an explicit mask,
    unlike `cutout.write_cutout`'s ``overwrite``), with the data cast to
    the shard's dtype.  The reference returns a new array; here the shard
    is updated in place and returned.
    """
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    a, b = morton.partition_curve(grid.n_cells, world)[rank]
    if shard.shape[0] != b - a:
        raise ValueError(f"rank {rank} holds {shard.shape[0]} rows, its segment "
                         f"[{a}, {b}) has {b - a}")
    data = as_device_tensor(data, shard.device)
    lo = [int(x) for x in lo]
    hi = [l + s for l, s in zip(lo, data.shape)]
    cs = grid.cuboid_shape
    glo = [l // c for l, c in zip(lo, cs)]
    ghi = [-(-h // c) for h, c in zip(hi, cs)]
    gshape = [h - l for l, h in zip(glo, ghi)]
    mesh_idx = np.meshgrid(*[np.arange(l, h) for l, h in zip(glo, ghi)],
                           indexing="ij")
    cells = morton.morton_encode(np.stack([g.ravel() for g in mesh_idx], -1),
                                 grid.bits)
    own = np.flatnonzero((cells >= a) & (cells < b))
    if own.size == 0:
        return shard
    aligned = [g * c for g, c in zip(gshape, cs)]
    box = tuple(slice(l - g * c, h - g * c) for l, h, g, c in zip(lo, hi, glo, cs))
    view = signed_view(shard)
    dpad = torch.zeros(aligned, dtype=view.dtype, device=shard.device)
    dpad[box] = signed_view(data.to(shard.dtype))
    mpad = torch.zeros(aligned, dtype=torch.bool, device=shard.device)
    mpad[box] = True
    sel = torch.from_numpy(own).to(shard.device)
    rows = torch.from_numpy(cells[own] - a).to(shard.device)
    new = split_blocks(dpad, gshape, cs).index_select(0, sel)
    mask = split_blocks(mpad, gshape, cs).index_select(0, sel)
    view.index_copy_(0, rows, torch.where(mask, new, view.index_select(0, rows)))
    return shard
