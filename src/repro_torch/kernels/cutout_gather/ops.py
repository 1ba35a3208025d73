"""Cutout wrapper: box -> Morton plan -> gather kernel (trim fused).

`cutout_gather` launches the hand-written CUDA kernel (``kernel.cu``) for a
tensor on the card and uses the plain PyTorch version (``ref.py``) only for
a tensor on the CPU.  `launches` counts kernel launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ...core import morton
from ...core.cuboid import CuboidGrid
from .. import _build, _wrap
from .ref import cutout_gather_ref

NAME = "cutout_gather"

# kernel launches since the last reset (read by ocpbench's harness and chip_smoke)
_counts = _wrap.Counts(__name__, "launches")
reset_launches = _counts.reset
__getattr__ = _counts.get


def build_plan(grid: CuboidGrid, lo: Sequence[int], hi: Sequence[int]
               ) -> Tuple[Tuple[int, ...], np.ndarray, list]:
    """Static part of a cutout: box-grid shape, Morton cell per position
    (row-major, int32) and the cuboid-aligned lo corner."""
    cs = grid.cuboid_shape
    glo = [l // c for l, c in zip(lo, cs)]
    ghi = [-(-h // c) for h, c in zip(hi, cs)]
    gshape = tuple(h - l for l, h in zip(glo, ghi))
    axes = np.meshgrid(*[np.arange(l, h) for l, h in zip(glo, ghi)],
                       indexing="ij")
    coords = np.stack([a.ravel() for a in axes], axis=-1)
    cells = morton.morton_encode(coords, grid.bits).astype(np.int32)
    return gshape, cells, [g * c for g, c in zip(glo, cs)]


def _unit_bytes(esize: int, extents: Sequence[int], ptrs: Sequence[int]) -> int:
    """Widest power-of-two copy unit (<= 16 bytes) dividing every innermost
    byte extent/offset and every base address."""
    return next(unit for unit in (16, 8, 4, 2, 1)
                if all((e * esize) % unit == 0 for e in extents)
                and all(p % unit == 0 for p in ptrs))


_I64 = ctypes.c_int64
# out, packed, plan; X, Y, Z, T; the offset; the cuboid; gy, gz, gt; unit;
# stream
ARGTYPES = [ctypes.c_void_p] * 3 + [_I64] * 16 + [ctypes.c_void_p]


def cutout_gather_cuda(packed: torch.Tensor, plan: torch.Tensor, gshape,
                       offset, out_shape) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as `cutout_gather_ref`, for a
    grid of rank 3 (``packed`` (n_cells, cx, cy, cz)) or 4 (a time series,
    (n_cells, cx, cy, cz, ct)).  Rank 3 goes to the C entry with a leading
    unit axis, which runs the rank-3 kernel."""
    if not packed.is_cuda or plan.device != packed.device:
        raise ValueError("packed and plan must be on the same CUDA device")
    if packed.dim() not in (4, 5) or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (n_cells, *cuboid) tensor "
                         f"of rank 3 or 4, got {tuple(packed.shape)}")
    if plan.dtype != torch.int32 or not plan.is_contiguous():
        raise ValueError("plan must be a contiguous int32 tensor")
    esize = packed.element_size()
    if esize not in (1, 2, 4, 8):
        raise ValueError(f"unsupported element size {esize}")
    pad = 5 - packed.dim()
    cx, cy, cz, ct = (1,) * pad + tuple(packed.shape[1:])
    _, gy, gz, gt = (1,) * pad + tuple(gshape)
    if plan.numel() != int(np.prod(gshape)):
        raise ValueError("plan length does not match the box grid")
    X, Y, Z, T = (1,) * pad + tuple(int(s) for s in out_shape)
    ox, oy, oz, ot = (0,) * pad + tuple(int(o) for o in offset)
    out = torch.empty(tuple(int(s) for s in out_shape), dtype=packed.dtype,
                      device=packed.device)
    if out.numel() == 0:
        return out
    unit = _unit_bytes(esize, (ct, ot, T), (packed.data_ptr(), out.data_ptr()))
    per = unit // esize
    _build.launch(_build.entry(NAME, "cutout_gather_launch", ARGTYPES), packed.device,
                  out.data_ptr(), packed.data_ptr(), plan.data_ptr(),
                  X, Y, Z, T // per, ox, oy, oz, ot // per, cx, cy, cz, ct // per,
                  gy, gz, gt, unit, what="cutout_gather launch")
    _counts.add("launches")
    return out


def planned_gather(packed: torch.Tensor, plan: torch.Tensor, gshape, offset,
                   out_shape) -> torch.Tensor:
    """Gather a box by an explicit plan on ``packed``'s own device: the
    kernel for a card tensor, the plain version for a CPU one.

    ``plan`` (int32, row-major over the box grid ``gshape``) names the row
    of ``packed`` for each box-grid position; any rows will do, which lets
    `core.distributed` gather a rank's rows and assemble gathered ones.  A
    grid of rank below 3 (the training pipeline's 2-D token store) goes to
    the kernel as a 3-D one with leading unit axes: the packed view, the
    box grid, the offset and the output shape gain them, and the output
    drops them again.
    """
    rank = packed.dim() - 1
    if not 1 <= rank <= 4:
        raise ValueError(f"cutout_gather takes grids of rank 1-4, got {rank}")
    out_shape = [int(s) for s in out_shape]
    pad = max(0, 3 - rank)
    view = packed.view((packed.shape[0],) + (1,) * pad + tuple(packed.shape[1:]))
    args = (view, plan, (1,) * pad + tuple(gshape), [0] * pad + list(offset),
            [1] * pad + out_shape)
    if packed.is_cuda:
        out = cutout_gather_cuda(*args)
    elif packed.device.type == "cpu":
        out = cutout_gather_ref(*args)
    else:
        raise ValueError(f"no cutout_gather for device {packed.device}")
    return out.view(out_shape)


def cutout_gather(packed: torch.Tensor, grid: CuboidGrid, lo, hi) -> torch.Tensor:
    """Dense cutout [lo, hi) from a cuboid-major tensor on its own device
    (a grid of rank 1-4): the Morton plan of the box, then
    `planned_gather`.  The plan's cells keep their values when unit axes
    are added (an axis of extent 1 takes no Morton bits)."""
    lo = tuple(int(x) for x in lo)
    hi = tuple(int(x) for x in hi)
    if tuple(packed.shape) != (grid.n_cells,) + tuple(grid.cuboid_shape):
        raise ValueError(f"packed shape {tuple(packed.shape)} does not match "
                         f"the grid ({grid.n_cells}, {grid.cuboid_shape})")
    gshape, cells, alo = build_plan(grid, lo, hi)
    plan = torch.from_numpy(cells).to(packed.device)
    return planned_gather(packed, plan, gshape, [l - a for l, a in zip(lo, alo)],
                          [h - l for l, h in zip(lo, hi)])
