"""Device-resident cuboid store: one Morton-ordered tensor per level.

`DeviceCuboidStore` holds, for each resolution level ``r``, a tensor of
shape ``(n_cells, *cuboid_shape)`` on its device whose row ``m`` is the
cuboid with Morton index ``m`` (the layout of `core.distributed`).  This is
the device form of the reference's zlib cuboid store: reads are gathers by
the `cutout_gather` kernel, writes are row scatters.

A level is allocated (zero-filled) when it is first written; reading a
level that was never written returns zeros, like the reference's lazy
cuboids.  That keeps an annotation project registered to a large image
dataset from allocating label levels it never touches.

Label data (``dtype="uint32"``) is held as int32 on the device with the
same bits: PyTorch's uint32 lacks ``index_select`` and ``max``.  Data
movement copies bytes, so the values are unchanged; the numpy boundary
(`carry`) hands back uint32.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .cuboid import DatasetSpec

_DTYPES = {
    "uint8": torch.uint8, "int8": torch.int8, "uint16": torch.uint16,
    "int16": torch.int16, "uint32": torch.int32, "int32": torch.int32,
    "int64": torch.int64, "float32": torch.float32, "float64": torch.float64,
}


def storage_dtype(dtype: str) -> torch.dtype:
    """Device dtype that holds a spec dtype (uint32 labels -> int32)."""
    try:
        return _DTYPES[np.dtype(dtype).name]
    except KeyError:
        raise ValueError(f"unsupported dataset dtype {dtype!r}") from None


class DeviceCuboidStore:
    """Packed ``(n_cells, *cuboid_shape)`` tensor per level, on ``device``."""

    def __init__(self, spec: DatasetSpec, device: DeviceLike = "cuda"):
        if spec.n_channels != 1:
            raise ValueError("the device store holds one channel per dataset")
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = storage_dtype(spec.dtype)
        self._levels: Dict[int, torch.Tensor] = {}
        self._alloc_guard = threading.Lock()
        # Writes are read-modify-write of whole cuboids: one writer at a time.
        self.write_guard = threading.RLock()

    def _check_level(self, r: int) -> None:
        if not 0 <= r < self.spec.n_resolutions:
            raise ValueError(f"resolution {r} outside [0, "
                             f"{self.spec.n_resolutions})")

    def peek(self, r: int) -> Optional[torch.Tensor]:
        """The packed level, or None if it was never written (all zeros)."""
        self._check_level(r)
        return self._levels.get(r)

    def level(self, r: int) -> torch.Tensor:
        """The packed level, allocated zero-filled on first use."""
        self._check_level(r)
        with self._alloc_guard:
            packed = self._levels.get(r)
            if packed is None:
                grid = self.spec.grid(r)
                packed = torch.zeros((grid.n_cells,) + tuple(grid.cuboid_shape),
                                     dtype=self.dtype, device=self.device)
                self._levels[r] = packed
            return packed

    def set_level(self, r: int, packed: torch.Tensor) -> None:
        """Install a whole packed level (bulk load from `carry`)."""
        grid = self.spec.grid(r)
        want = (grid.n_cells,) + tuple(grid.cuboid_shape)
        if tuple(packed.shape) != want or packed.dtype != self.dtype:
            raise ValueError(f"level {r} must be {want} {self.dtype}, got "
                             f"{tuple(packed.shape)} {packed.dtype}")
        with self._alloc_guard:
            self._levels[r] = packed.to(self.device).contiguous()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._levels.values())
