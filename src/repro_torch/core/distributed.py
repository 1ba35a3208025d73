"""The device-resident cuboid-major layout (paper §4.1 C3).

The volume lives on the device as one array of shape
``(n_cells, *cuboid_shape)`` whose row index IS the Morton index: a cutout
is a gather of the planned rows plus a trim (`kernels.cutout_gather`).
Rows for the power-of-two padding cells past the volume are zero, so the
index stays dense (lazy cuboids, paper §3.2).

Packing and unpacking are vectorised reshape/permute plus one row scatter
(or gather) on the tensor's own device.  The multi-rank cutout and write
over ``torch.distributed`` are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
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
