"""Carry a dataset between the reference's numpy world and the device store.

The system's state is data, not weights: a dataset is a set of dense
resolution levels.  `store_from_numpy` packs each level into a
`DeviceCuboidStore` (the reference's dense levels come from its own
``cutout(store, r, 0, shape)``); `store_to_numpy` is the inverse and hands
label datasets back as uint32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .core.cuboid import DatasetSpec
from .core.cutout import as_device_tensor
from .core.distributed import pack_to_cuboids, signed_view, unpack_from_cuboids
from .core.store import DeviceCuboidStore
from .device import DeviceLike


def store_from_numpy(spec: DatasetSpec, levels: Dict[int, np.ndarray],
                     device: DeviceLike = "cuda") -> DeviceCuboidStore:
    """A device store holding the given dense level volumes."""
    store = DeviceCuboidStore(spec, device=device)
    for r, vol in levels.items():
        dense = as_device_tensor(np.asarray(vol, dtype=np.dtype(spec.dtype)),
                           store.device)
        store.set_level(r, pack_to_cuboids(dense, spec.grid(r)))
    return store


def store_to_numpy(store: DeviceCuboidStore) -> Dict[int, np.ndarray]:
    """Dense numpy volume of every level (unwritten levels are zeros)."""
    out = {}
    dtype = np.dtype(store.spec.dtype)
    for r in range(store.spec.n_resolutions):
        grid = store.spec.grid(r)
        packed = store.peek(r)
        if packed is None:
            out[r] = np.zeros(grid.volume_shape, dtype=dtype)
            continue
        dense = signed_view(unpack_from_cuboids(packed, grid)).cpu()
        out[r] = dense.numpy().view(dtype)
    return out
