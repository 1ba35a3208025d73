"""Cutout wrapper: box -> Morton plan -> gather kernel (trim fused).

`cutout_gather` launches the hand-written CUDA kernel (``kernel.cu``) for a
tensor on the card and uses the plain PyTorch version (``ref.py``) only for
a tensor on the CPU.  `launches` counts kernel launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from ...core import morton
from ...core.cuboid import CuboidGrid
from .. import _build
from .ref import cutout_gather_ref

NAME = "cutout_gather"

launches = 0  # kernel launches since the last reset (read by chip_smoke)
_count_guard = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_guard:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_guard:
        launches += 1


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


def _entry():
    fn = _build.library(NAME).cutout_gather_launch
    if fn.argtypes is None:  # untyped ctypes would cut pointers to 32 bits
        fn.argtypes = [ctypes.c_void_p] * 3 + [_I64] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cutout_gather_cuda(packed: torch.Tensor, plan: torch.Tensor, gshape,
                       offset, out_shape) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as `cutout_gather_ref`."""
    if not packed.is_cuda or plan.device != packed.device:
        raise ValueError("packed and plan must be on the same CUDA device")
    if packed.dim() != 4 or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (n_cells, cx, cy, cz) "
                         f"tensor, got {tuple(packed.shape)}")
    if plan.dtype != torch.int32 or not plan.is_contiguous():
        raise ValueError("plan must be a contiguous int32 tensor")
    esize = packed.element_size()
    if esize not in (1, 2, 4, 8):
        raise ValueError(f"unsupported element size {esize}")
    _, cx, cy, cz = packed.shape
    gx, gy, gz = gshape
    if plan.numel() != gx * gy * gz:
        raise ValueError("plan length does not match the box grid")
    X, Y, Z = (int(s) for s in out_shape)
    ox, oy, oz = (int(o) for o in offset)
    out = torch.empty((X, Y, Z), dtype=packed.dtype, device=packed.device)
    if out.numel() == 0:
        return out
    unit = _unit_bytes(esize, (cz, oz, Z), (packed.data_ptr(), out.data_ptr()))
    per = unit // esize
    fn = _entry()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(out.data_ptr(), packed.data_ptr(), plan.data_ptr(),
                 X, Y, Z // per, ox, oy, oz // per, cx, cy, cz // per,
                 gy, gz, unit, stream)
    if err != 0:
        raise RuntimeError(f"cutout_gather launch failed (cudaError {err})")
    _count_launch()
    return out


def cutout_gather(packed: torch.Tensor, grid: CuboidGrid, lo, hi) -> torch.Tensor:
    """Dense cutout [lo, hi) from a cuboid-major tensor on its own device.

    A grid of rank below 3 (the training pipeline's 2-D token store) goes
    to the kernel as a 3-D one with leading unit axes: the packed view, the
    box grid, the offset and the output shape gain them, the plan's cells
    stay (an axis of extent 1 takes no Morton bits), and the output drops
    them again.
    """
    lo = tuple(int(x) for x in lo)
    hi = tuple(int(x) for x in hi)
    if tuple(packed.shape) != (grid.n_cells,) + tuple(grid.cuboid_shape):
        raise ValueError(f"packed shape {tuple(packed.shape)} does not match "
                         f"the grid ({grid.n_cells}, {grid.cuboid_shape})")
    if grid.rank > 3:
        raise ValueError(f"cutout_gather takes grids of rank 1-3, got {grid.rank}")
    gshape, cells, alo = build_plan(grid, lo, hi)
    plan = torch.from_numpy(cells).to(packed.device)
    offset = [l - a for l, a in zip(lo, alo)]
    out_shape = [h - l for l, h in zip(lo, hi)]
    pad = 3 - grid.rank
    view = packed.view((packed.shape[0],) + (1,) * pad + tuple(packed.shape[1:]))
    args = (view, plan, (1,) * pad + tuple(gshape), [0] * pad + offset,
            [1] * pad + out_shape)
    if packed.is_cuda:
        out = cutout_gather_cuda(*args)
    elif packed.device.type == "cpu":
        out = cutout_gather_ref(*args)
    else:
        raise ValueError(f"no cutout_gather for device {packed.device}")
    return out.view(out_shape)
