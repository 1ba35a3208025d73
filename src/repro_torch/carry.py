"""Carry state between the reference's numpy world and the port's device.

A dataset is a set of dense resolution levels.  `store_from_numpy` packs
each level into a `DeviceCuboidStore` (the reference's dense levels come
from its own ``cutout(store, r, 0, shape)``); `store_to_numpy` is the
inverse and hands label datasets back as uint32.

An LM's parameters are a tree of arrays in the JAX package's structure
(blocks stacked on a leading layer axis).  `lm_params_from_numpy` loads it
into the port's `LM`; bfloat16 leaves are taken bit for bit through a
16-bit integer view, so neither side needs ``ml_dtypes``.
`lm_params_to_numpy` is the inverse and hands bfloat16 leaves back as their
uint16 bit patterns.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.cuboid import DatasetSpec
from .core.cutout import as_device_tensor
from .core.distributed import pack_to_cuboids, signed_view, unpack_from_cuboids
from .core.store import DeviceCuboidStore
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models.lm import LM, lm_specs
from .models.params import DTYPES, ParamSpec


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


def _leaf_from_numpy(arr, spec: ParamSpec, path: str) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: jax hands out read-only views
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"{path}: shape {arr.shape}, want {spec.shape}")
    want = DTYPES[spec.dtype]
    if want is torch.bfloat16 and (arr.dtype.name == "bfloat16"
                                   or arr.dtype in (np.uint16, np.int16)):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(want)


def lm_params_from_numpy(cfg: ModelConfig, tree, device: DeviceLike = "cuda") -> LM:
    """The port's `LM` holding the JAX package's parameters ``tree`` (numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``)."""
    specs = lm_specs(cfg)

    def walk(spec_tree, arr_tree, path):
        if isinstance(spec_tree, ParamSpec):
            return _leaf_from_numpy(arr_tree, spec_tree, path)
        if set(spec_tree) != set(arr_tree):
            raise ValueError(f"{path or 'params'}: keys {sorted(arr_tree)}, "
                             f"want {sorted(spec_tree)}")
        return {k: walk(spec_tree[k], arr_tree[k], f"{path}/{k}") for k in spec_tree}

    dev = resolve_device(device)
    params = _map_tree(lambda t: t.to(dev), walk(specs, tree, ""))
    return LM(cfg, params, device=dev)


def lm_params_to_numpy(model: LM):
    """The model's parameters as numpy arrays in the JAX package's
    structure; bfloat16 leaves as their uint16 bit patterns."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return _map_tree(leaf, model.param_tree())


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
