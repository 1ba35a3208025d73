"""N-dimensional Morton (z-order) index: the static cutout plan.

A trimmed copy of the reference curve (OCP, Burns et al. 2013, §3):
cuboids are indexed by bit-interleaving their per-dimension grid offsets,
with unequal per-dimension bit widths for anisotropic grids (exhausted
dimensions drop out of the interleave, so the index stays dense in
``[0, prod(2^bits))``).  Pure numpy on the host — the plan is computed
before any device work, and only the resulting cell list moves to the card.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

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
