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
uint16 bit patterns.  `opt_state_from_numpy` and `opt_state_to_numpy` do the
same for an AdamW state (``mu``, ``nu``, ``master``, ``step``), so a JAX
state and a port state compute the same step.

A train state (the model and its AdamW state) is checkpointed as the JAX
driver's tree ``{"params": ..., "opt": {"mu", "nu", "master", "step"}}``
(`train_state_to_tree`); `train_state_from_tree` loads a restored tree back
into the live tensors.
"""
from __future__ import annotations

import dataclasses
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
from .models.params import DTYPES, ParamSpec, tree_map


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


def _tree_from_numpy(spec_tree, arr_tree, dev: torch.device, path: str = ""):
    """Tensors on ``dev`` for a numpy tree of the spec tree's structure."""
    if isinstance(spec_tree, ParamSpec):
        return _leaf_from_numpy(arr_tree, spec_tree, path).to(dev)
    if set(spec_tree) != set(arr_tree):
        raise ValueError(f"{path or 'params'}: keys {sorted(arr_tree)}, "
                         f"want {sorted(spec_tree)}")
    return {k: _tree_from_numpy(spec_tree[k], arr_tree[k], dev, f"{path}/{k}")
            for k in spec_tree}


def lm_params_from_numpy(cfg: ModelConfig, tree, device: DeviceLike = "cuda") -> LM:
    """The port's `LM` holding the JAX package's parameters ``tree`` (numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``)."""
    dev = resolve_device(device)
    return LM(cfg, _tree_from_numpy(lm_specs(cfg), tree, dev), device=dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)  # trees hold live weights and state
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def lm_params_to_numpy(model: LM):
    """The model's parameters as numpy arrays in the JAX package's
    structure; bfloat16 leaves as their uint16 bit patterns."""
    return tree_map(_leaf_to_numpy, model.param_tree())


def opt_state_from_numpy(cfg: ModelConfig, state, device: DeviceLike = "cuda") -> Dict:
    """An AdamW state (`optim.adamw_init`'s structure) from the JAX
    package's (numpy arrays): ``mu`` and ``nu`` keep their dtype (bfloat16
    as ml_dtypes' or as uint16 bits, else float32), ``master`` is fp32,
    ``step`` an int32 scalar."""
    dev = resolve_device(device)
    specs = lm_specs(cfg)

    def moments(tree):
        dtypes = tree_map(lambda a: "bfloat16" if np.asarray(a).dtype.name in (
            "bfloat16", "uint16", "int16") else "float32", tree)
        return _tree_from_numpy(_with_dtypes(specs, dtypes), tree, dev)

    return {"mu": moments(state["mu"]), "nu": moments(state["nu"]),
            "master": _tree_from_numpy(_with_dtypes(specs, "float32"), state["master"],
                                       dev),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=dev)}


def opt_state_to_numpy(state: Dict) -> Dict:
    """The inverse of `opt_state_from_numpy`; bfloat16 leaves as uint16 bits."""
    out = {k: tree_map(_leaf_to_numpy, state[k]) for k in ("mu", "nu", "master")}
    out["step"] = np.asarray(int(state["step"]), dtype=np.int32)
    return out


def train_state_to_tree(model: LM, opt: Dict) -> Dict:
    """The train state as the JAX driver's checkpoint tree: the model's
    live Parameters and the live optimizer state (a checkpoint snapshot
    copies them to the host)."""
    return {"params": model.param_tree(), "opt": opt}


@torch.no_grad()
def train_state_from_tree(tree, model: LM, opt: Dict) -> Dict:
    """Copy a restored checkpoint tree (tensors on any device) into the
    model's Parameters and ``opt`` in place, and return ``opt``.  In place
    because `train.make_train_step` closes over ``model.param_tree()`` and
    `optim.adamw_update` updates the state's tensors: new tensors would
    leave the step updating the old ones.  Keys, shapes and dtypes must
    match."""
    _copy_into(tree, train_state_to_tree(model, opt), "")
    return opt


def _copy_into(src, dst, path: str) -> None:
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path or 'state'}: keys {got}, want {sorted(dst)}")
        for k in dst:
            _copy_into(src[k], dst[k], f"{path}/{k}" if path else k)
        return
    if not torch.is_tensor(src) or src.shape != dst.shape or src.dtype != dst.dtype:
        what = (f"{src.dtype} {tuple(src.shape)}" if torch.is_tensor(src)
                else type(src).__name__)
        raise ValueError(f"{path}: {what}, want {dst.dtype} {tuple(dst.shape)}")
    dst.copy_(src)


def _with_dtypes(specs, dtypes):
    """``specs`` with each leaf's dtype from ``dtypes`` (a tree, or one
    dtype for all)."""
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(specs, dtype=dtypes)
    return {k: _with_dtypes(v, dtypes if isinstance(dtypes, str) else dtypes[k])
            for k, v in specs.items()}
