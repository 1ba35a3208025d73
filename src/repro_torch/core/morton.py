"""N-dimensional Morton (z-order) index: the static cutout plan.

A trimmed copy of the reference curve (OCP, Burns et al. 2013, §3):
cuboids are indexed by bit-interleaving their per-dimension grid offsets,
with unequal per-dimension bit widths for anisotropic grids (exhausted
dimensions drop out of the interleave, so the index stays dense in
``[0, prod(2^bits))``).  Pure numpy on the host — the plan is computed
before any device work, and only the resulting cell list moves to the card.
The 2-d Hilbert decode serves `kernels/morton_matmul`'s tile orders, and
`partition_curve` cuts a curve into the hosts' segments (`data.pipeline`).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def bit_placement(bits: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    """(dim, src_bit) per output bit, LSB first, round-robin over dims."""
    placement = []
    for level in range(max(bits) if bits else 0):
        for dim, b in enumerate(bits):
            if level < b:
                placement.append((dim, level))
    return tuple(placement)


def grid_bits(grid_shape: Sequence[int]) -> Tuple[int, ...]:
    """Per-dim bit widths for a cuboid-grid shape (rounded up to pow2)."""
    out = []
    for s in grid_shape:
        if s <= 0:
            raise ValueError(f"grid dim must be positive, got {grid_shape}")
        out.append(int(np.ceil(np.log2(s))) if s > 1 else 0)
    return tuple(out)


def morton_encode(coords, bits: Tuple[int, ...]) -> np.ndarray:
    """Vectorized encode. coords: (..., d) int array -> (...) int64."""
    coords = np.asarray(coords, dtype=np.int64)
    out = np.zeros(coords.shape[:-1], dtype=np.int64)
    for pos, (dim, src_bit) in enumerate(bit_placement(bits)):
        out |= ((coords[..., dim] >> src_bit) & 1) << pos
    return out


def morton_decode(idx, bits: Tuple[int, ...]) -> np.ndarray:
    """Vectorized decode. idx: (...) int -> (..., d) int64."""
    idx = np.asarray(idx, dtype=np.int64)
    out = np.zeros(idx.shape + (len(bits),), dtype=np.int64)
    for pos, (dim, src_bit) in enumerate(bit_placement(bits)):
        out[..., dim] |= ((idx >> pos) & 1) << src_bit
    return out


def total_bits(bits: Tuple[int, ...]) -> int:
    return int(sum(bits))


def morton_encode_torch(coords, bits: Tuple[int, ...]):
    """`morton_encode` on an int64 tensor (..., d), on its own device."""
    out = coords.new_zeros(coords.shape[:-1])
    for pos, (dim, src_bit) in enumerate(bit_placement(bits)):
        out |= ((coords[..., dim] >> src_bit) & 1) << pos
    return out


def hilbert_decode_2d(t, order: int):
    """Vectorized 2-d Hilbert curve decode: t -> (x, y) on a 2^order grid.

    Every step of the curve moves to a grid neighbour, the property a
    capacity-1 panel-reuse schedule wants (`kernels/morton_matmul`).
    """
    t = np.asarray(t, dtype=np.int64)
    x = np.zeros_like(t)
    y = np.zeros_like(t)
    tt = t.copy()
    for s in range(order):
        rx = (tt >> 1) & 1
        ry = (tt ^ rx) & 1
        swap = ry == 0  # rotate the quadrant
        flip = swap & (rx == 1)
        side = 1 << s
        x_f = np.where(flip, side - 1 - x, x)
        y_f = np.where(flip, side - 1 - y, y)
        x_r = np.where(swap, y_f, x_f)
        y_r = np.where(swap, x_f, y_f)
        x = x_r + rx * side
        y = y_r + ry * side
        tt >>= 2
    return x, y


def partition_curve(n_cells: int, n_parts: int) -> List[Tuple[int, int]]:
    """Partition [0, n_cells) of the curve into n_parts contiguous segments
    (paper §4.1): the first ``n_cells % n_parts`` take one extra cell."""
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    base, rem = divmod(n_cells, n_parts)
    parts = []
    start = 0
    for i in range(n_parts):
        size = base + (1 if i < rem else 0)
        parts.append((start, start + size))
        start += size
    return parts
