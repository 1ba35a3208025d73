"""Plain PyTorch cutout gather: the kernel's reference on any device.

Gathers the planned rows with ``index_select``, interleaves the grid and
cuboid axes (as the reference's multi-device assembly does), merges them
into the cuboid-aligned box and trims it to [lo, hi).
"""
from __future__ import annotations

import torch

from ...core.distributed import merge_blocks, signed_view


def cutout_gather_ref(packed: torch.Tensor, plan: torch.Tensor, gshape,
                      offset, out_shape) -> torch.Tensor:
    """packed (n_cells, *cs); plan (n_box,) int32 Morton cell per box-grid
    position (row-major); offset = lo - aligned lo; out_shape = hi - lo."""
    cs = tuple(packed.shape[1:])
    blocks = signed_view(packed).index_select(0, plan.to(torch.int64))
    merged = merge_blocks(blocks, gshape, cs)
    trim = tuple(slice(o, o + s) for o, s in zip(offset, out_shape))
    return merged[trim].contiguous().view(packed.dtype)
