"""Cuboid grids and the anisotropic resolution hierarchy (paper §3.1).

A dataset is a dense N-d array cut into fixed-shape *cuboids*.  Per level
X and Y halve while Z does not (serial-section EM anisotropy), and the
cuboid shape changes across levels so cuboids stay roughly isometric in
sample space: flat 128x128x16 at high resolution, cubic 64^3 from level 4.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import morton

# Paper default: cuboids contain 2^18 = 256K voxels (§3.1).
CUBOID_VOXELS = 1 << 18


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class CuboidGrid:
    """One resolution level: volume shape + cuboid shape + morton layout."""
    volume_shape: Tuple[int, ...]   # voxels per dim at this level
    cuboid_shape: Tuple[int, ...]   # voxels per cuboid per dim

    def __post_init__(self):
        if len(self.volume_shape) != len(self.cuboid_shape):
            raise ValueError("rank mismatch")

    @property
    def rank(self) -> int:
        return len(self.volume_shape)

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return tuple(_ceil_div(v, c)
                     for v, c in zip(self.volume_shape, self.cuboid_shape))

    @property
    def bits(self) -> Tuple[int, ...]:
        return morton.grid_bits(self.grid_shape)

    @property
    def n_cells(self) -> int:
        """Size of the (dense, padded-to-pow2) morton index space."""
        return 1 << morton.total_bits(self.bits)

    @property
    def cuboid_voxels(self) -> int:
        return int(np.prod(self.cuboid_shape))

    def cuboid_of_voxel(self, voxel: Sequence[int]) -> int:
        coords = [v // c for v, c in zip(voxel, self.cuboid_shape)]
        return int(morton.morton_encode(np.array(coords), self.bits))

    def cuboid_origin(self, idx: int) -> Tuple[int, ...]:
        coords = morton.morton_decode(idx, self.bits)
        return tuple(int(c) * s for c, s in zip(coords, self.cuboid_shape))

    def box_to_runs(self, lo: Sequence[int], hi: Sequence[int],
                    max_runs: int | None = None) -> morton.Runs:
        """Morton runs of cuboids intersecting voxel box [lo, hi)."""
        glo = [l // c for l, c in zip(lo, self.cuboid_shape)]
        ghi = [_ceil_div(h, c) for h, c in zip(hi, self.cuboid_shape)]
        return morton.range_decompose(glo, ghi, self.bits, max_runs=max_runs)

    def clamp_box(self, lo, hi):
        lo = [max(0, int(l)) for l in lo]
        hi = [min(int(v), int(h)) for v, h in zip(self.volume_shape, hi)]
        return lo, hi


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Dataset configuration (paper §4.2 'Projects and Datasets').

    ``spatial_rank``: the dims in the Morton index (XYZ, or XYZT: a 4-d
    curve for time series, paper §3.1).  Channels are not in the index:
    each channel has cuboids of its own.
    """
    name: str
    volume_shape: Tuple[int, ...]          # full-res spatial shape (X,Y,Z[,T])
    n_channels: int = 1
    n_resolutions: int = 1
    dtype: str = "uint8"
    # dims that downscale per level (X,Y for EM; never Z/T):
    scaled_dims: Tuple[int, ...] = (0, 1)
    base_cuboid: Tuple[int, ...] | None = None  # default: auto per level
    compress_level: int = 1  # zlib level of the host tiers' cuboids

    @property
    def spatial_rank(self) -> int:
        return len(self.volume_shape)

    @functools.cached_property
    def levels(self) -> Dict[int, CuboidGrid]:
        """Resolution hierarchy; level 0 = full resolution."""
        out = {}
        for r in range(self.n_resolutions):
            vol = tuple(max(1, v >> r) if d in self.scaled_dims else v
                        for d, v in enumerate(self.volume_shape))
            out[r] = CuboidGrid(vol, self.cuboid_shape_at(r, vol))
        return out

    def cuboid_shape_at(self, r: int,
                        vol: Tuple[int, ...]) -> Tuple[int, ...]:
        """Anisotropy-aware cuboid shapes (paper Fig 5), ~CUBOID_VOXELS
        each; trailing (time) dims get the Z shape."""
        if self.base_cuboid is not None:
            return tuple(min(c, v) for c, v in zip(self.base_cuboid, vol))
        rank = len(vol)
        if rank == 1:
            return (min(CUBOID_VOXELS, vol[0]),)
        if rank == 2:
            side = int(np.sqrt(CUBOID_VOXELS))
            return tuple(min(side, v) for v in vol)
        if r < 4:
            shape = [128, 128] + [16] * (rank - 2)
        else:
            shape = [64, 64] + [64] * (rank - 2)
        return tuple(min(s, max(1, v)) for s, v in zip(shape, vol))

    def grid(self, r: int) -> CuboidGrid:
        return self.levels[r]


def downsample_block(block: torch.Tensor, scaled_dims: Sequence[int],
                     factor: int = 2) -> torch.Tensor:
    """Average-pool ``scaled_dims`` by ``factor`` (hierarchy construction).

    Bit-exact with the numpy reference: integer blocks average in float64
    (numpy's ``mean`` promotes them) and float blocks in their own dtype,
    one dimension at a time in ascending order, then truncate back to the
    block's dtype.
    """
    out = block if block.is_floating_point() else block.to(torch.float64)
    for d in sorted(scaled_dims):
        n = out.shape[d] - out.shape[d] % factor
        pairs = out.narrow(d, 0, n).unflatten(d, (n // factor, factor))
        acc = pairs.select(d + 1, 0)
        for i in range(1, factor):
            acc = acc + pairs.select(d + 1, i)
        out = acc / factor
    return out.to(block.dtype)


def downsample_labels(block: torch.Tensor, scaled_dims: Sequence[int],
                      factor: int = 2) -> torch.Tensor:
    """Label-preserving (stride) downsample for annotation hierarchies."""
    sl = [slice(None)] * block.ndim
    for d in scaled_dims:
        sl[d] = slice(0, None, factor)
    return block[tuple(sl)]
