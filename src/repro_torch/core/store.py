"""Device-resident cuboid store: one Morton-ordered tensor per level.

`DeviceCuboidStore` holds, for each resolution level ``r`` and channel
``c``, a tensor of shape ``(n_cells, *cuboid_shape)`` on its device whose
row ``m`` is the cuboid with Morton index ``m`` (the layout of
`core.distributed`).  This is the device form of the reference's zlib
cuboid store: reads are gathers by the `cutout_gather` kernel, writes are
row scatters.  Channels are not in the Morton index: each channel has a
packed tensor of its own, as the reference keeps separate cuboids per
channel.

A (level, channel) is allocated (zero-filled) when it is first written;
reading one that was never written returns zeros, like the reference's
lazy cuboids.  That keeps an annotation project registered to a large
image dataset from allocating label levels it never touches.

Label data (``dtype="uint32"``) is held as int32 on the device with the
same bits: PyTorch's uint32 lacks ``index_select`` and ``max``.  Data
movement copies bytes, so the values are unchanged; the numpy boundary
(`carry`) hands back uint32.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

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
    """Packed ``(n_cells, *cuboid_shape)`` tensor per (level, channel), on
    ``device``."""

    def __init__(self, spec: DatasetSpec, device: DeviceLike = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = storage_dtype(spec.dtype)
        self._levels: Dict[Tuple[int, int], torch.Tensor] = {}
        self._alloc_guard = threading.Lock()
        # Writes are read-modify-write of whole cuboids: one writer at a time.
        self.write_guard = threading.RLock()

    def _key(self, r: int, channel: int) -> Tuple[int, int]:
        if not 0 <= r < self.spec.n_resolutions:
            raise ValueError(f"resolution {r} outside [0, "
                             f"{self.spec.n_resolutions})")
        if not 0 <= channel < self.spec.n_channels:
            raise ValueError(f"channel {channel} outside [0, "
                             f"{self.spec.n_channels})")
        return r, channel

    def peek(self, r: int, channel: int = 0) -> Optional[torch.Tensor]:
        """The packed level, or None if it was never written (all zeros)."""
        return self._levels.get(self._key(r, channel))

    def level(self, r: int, channel: int = 0) -> torch.Tensor:
        """The packed level, allocated zero-filled on first use."""
        key = self._key(r, channel)
        with self._alloc_guard:
            packed = self._levels.get(key)
            if packed is None:
                grid = self.spec.grid(r)
                packed = torch.zeros((grid.n_cells,) + tuple(grid.cuboid_shape),
                                     dtype=self.dtype, device=self.device)
                self._levels[key] = packed
            return packed

    def set_level(self, r: int, packed: torch.Tensor, channel: int = 0) -> None:
        """Install a whole packed level (bulk load from `carry`)."""
        key = self._key(r, channel)
        grid = self.spec.grid(r)
        want = (grid.n_cells,) + tuple(grid.cuboid_shape)
        if tuple(packed.shape) != want or packed.dtype != self.dtype:
            raise ValueError(f"level {r} must be {want} {self.dtype}, got "
                             f"{tuple(packed.shape)} {packed.dtype}")
        with self._alloc_guard:
            self._levels[key] = packed.to(self.device).contiguous()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._levels.values())
