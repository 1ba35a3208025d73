"""Carry state between the reference's numpy world and the port's device.

A dataset is a set of dense resolution levels per channel.
`store_from_numpy` packs each level into a `DeviceCuboidStore` (the
reference's dense levels come from its own ``cutout(store, r, 0, shape,
channel)``); `store_to_numpy` is the inverse and hands label datasets back
as uint32 (`labels_to_numpy` does so for one label tensor).

A host tier is a set of ``(key, blob)`` pairs of zlib-compressed cuboids,
in the same format in both packages: `backend_items` reads them from any
backend of either package and `backend_from_items` puts them into a
backend (a new port `MemoryBackend` by default), so both sides can start
from one tier's contents.  A cluster's state is its node count, its
replication, each resolution's `Partition.bounds` and each node's backend
items: `cluster_items` reads it from either package's `ClusterStore`, and
`cluster_from_items` builds a port cluster holding it (or fills an empty
cluster of either package), so both sides can start from one cluster.

An annotation project's state is its label levels, metadata rows, object
index, exception lists, auto-id counter and dirty levels.
`project_to_numpy` gives it as plain Python and numpy (levels as uint32
arrays, rows as dicts, the index as ``{id: [cells]}``, the exception lists
as ``{(r, m): [(offset, label)]}``); `project_from_numpy` builds a project
holding it.  The reference project can be set from or read into the same
structure, so both sides can start from one state.

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
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core.annotations import Annotation, AnnotationProject
from .core.cuboid import DatasetSpec
from .core.distributed import (as_device_tensor, pack_to_cuboids, signed_view,
                               unpack_from_cuboids)
from .core.store import Backend, DeviceCuboidStore, Key, MemoryBackend
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models import build_model, model_specs
from .models.encdec import EncDecLM
from .models.lm import LM
from .models.params import DTYPES, ParamSpec, tree_map


def store_from_numpy(spec: DatasetSpec,
                     levels: Dict[Union[int, Tuple[int, int]], np.ndarray],
                     device: DeviceLike = "cuda") -> DeviceCuboidStore:
    """A device store holding the given dense level volumes, keyed by level
    ``r`` (channel 0) or by ``(r, channel)``."""
    store = DeviceCuboidStore(spec, device=device)
    for key, vol in levels.items():
        r, channel = key if isinstance(key, tuple) else (key, 0)
        dense = as_device_tensor(np.asarray(vol, dtype=np.dtype(spec.dtype)),
                                 store.device)
        store.set_level(r, pack_to_cuboids(dense, spec.grid(r)), channel)
    return store


def labels_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A label tensor (int32 holding uint32 ids) as a uint32 numpy array."""
    return signed_view(t).cpu().numpy().view(np.uint32)


def store_to_numpy(store: DeviceCuboidStore, channel: int = 0) -> Dict[int, np.ndarray]:
    """Dense numpy volume of every level of ``channel`` (unwritten levels
    are zeros; over a backing, every cuboid is loaded first)."""
    out = {}
    dtype = np.dtype(store.spec.dtype)
    for r in range(store.spec.n_resolutions):
        grid = store.spec.grid(r)
        if store.backing is not None:
            store.ensure_resident(r, channel, np.arange(grid.n_cells))
        packed = store.peek(r, channel)
        if packed is None:
            out[r] = np.zeros(grid.volume_shape, dtype=dtype)
            continue
        dense = signed_view(unpack_from_cuboids(packed, grid)).cpu()
        out[r] = dense.numpy().view(dtype)
    return out


def backend_items(backend) -> List[Tuple[Key, bytes]]:
    """A backend's stored ``(key, blob)`` pairs, sorted by key (a log
    tier's tombstones are absences, as they read)."""
    return sorted((k, backend.get(k)) for k in backend.keys())


def backend_from_items(items: Sequence[Tuple[Key, bytes]],
                       backend: Optional[Backend] = None) -> Backend:
    """``backend`` (a new `MemoryBackend` by default) holding ``items``."""
    backend = MemoryBackend() if backend is None else backend
    backend.put_many([(tuple(int(x) for x in k), bytes(b)) for k, b in items])
    return backend


def cluster_items(cluster) -> Dict[str, Any]:
    """A cluster's state (`ClusterStore` of either package) as numpy data
    and bytes, taken after its flush barrier so no write is still queued:
    ``n_nodes``, ``replication``, ``bounds`` ({r: int64 `Partition.bounds`})
    and ``nodes`` (per node, the items of its ``read`` and ``write``
    backends; ``write`` is None without a write path)."""
    cluster.flush()
    router = cluster.router
    return {
        "n_nodes": cluster.n_nodes,
        "replication": int(cluster.replication),
        "bounds": {r: np.asarray(router.partition(r).bounds, dtype=np.int64)
                   for r in range(cluster.spec.n_resolutions)},
        "nodes": [{"read": backend_items(node.read_backend),
                   "write": (None if node.write_backend is None
                             else backend_items(node.write_backend))}
                  for node in cluster.nodes],
    }


def cluster_from_items(spec: DatasetSpec, items: Dict[str, Any], into=None, **kwargs):
    """A cluster holding ``items`` (`cluster_items`): a new port
    `ClusterStore` built with ``kwargs``, or ``into``, an empty cluster of
    either package with as many nodes, whose router is replaced.  Each
    node's backends get its blobs; its cache and queue start empty."""
    from .cluster.store import ClusterStore

    cluster = into if into is not None else ClusterStore(
        spec, n_nodes=items["n_nodes"], replication=items["replication"], **kwargs)
    nodes = cluster.nodes
    if len(nodes) != items["n_nodes"]:
        raise ValueError(f"cluster has {len(nodes)} nodes, the items {items['n_nodes']}")
    router = cluster.router
    part = type(router.partition(0))
    bounds = items["bounds"]
    cluster._swap_topo(type(cluster._topo)(tuple(nodes), type(router)(
        cluster.spec, len(bounds[0]) - 1, {r: part(tuple(int(b) for b in bounds[r]))
                                           for r in bounds},
        items["replication"])))
    for node, state in zip(nodes, items["nodes"]):
        backend_from_items(state["read"], node.read_backend)
        if state["write"] is not None:
            backend_from_items(state["write"], node.write_backend)
    return cluster


def project_to_numpy(proj: AnnotationProject) -> Dict[str, Any]:
    """An annotation project's state as plain Python and numpy."""
    return {"levels": store_to_numpy(proj.store),
            "rows": [dataclasses.asdict(a) for a in proj.meta._rows.values()],
            "next_id": proj.meta._next_id,
            "index": {i: proj.index.cuboids(i) for i in proj.index.ids()},
            "exceptions": {k: list(v) for k, v in proj._exceptions.items()},
            "dirty": sorted(proj._dirty_levels)}


def project_from_numpy(name: str, image_spec: DatasetSpec, state: Dict[str, Any],
                       enable_exceptions: bool = False, readonly: bool = False,
                       device: DeviceLike = "cuda") -> AnnotationProject:
    """A project holding ``state`` (`project_to_numpy`'s structure)."""
    proj = AnnotationProject(name, image_spec, enable_exceptions=enable_exceptions,
                             readonly=readonly, device=device)
    proj.store = store_from_numpy(proj.spec, state["levels"], device=device)
    for row in state["rows"]:
        proj.meta.create(Annotation(**{k: (tuple(v) if k == "segments" else v)
                                       for k, v in row.items()}))
    proj.meta._next_id = int(state["next_id"])
    if state["index"]:
        proj.index.append_batch(state["index"])
    proj._exceptions = {tuple(k): [tuple(e) for e in v]
                        for k, v in state["exceptions"].items()}
    proj._dirty_levels = set(state["dirty"])
    return proj


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


def lm_params_from_numpy(cfg: ModelConfig, tree, device: DeviceLike = "cuda"
                         ) -> Union[LM, EncDecLM]:
    """The port's model (`LM`, or `EncDecLM` for the encoder-decoder
    family) holding the JAX package's parameters ``tree`` (numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``): the hybrid family's
    ``blocks`` and ``tail``, the encoder-decoder's ``encoder`` and
    ``decoder`` included."""
    dev = resolve_device(device)
    return build_model(cfg, _tree_from_numpy(model_specs(cfg), tree, dev), device=dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)  # trees hold live weights and state
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def lm_params_to_numpy(model: Union[LM, EncDecLM]):
    """The model's parameters as numpy arrays in the JAX package's
    structure; bfloat16 leaves as their uint16 bit patterns."""
    return tree_map(_leaf_to_numpy, model.param_tree())


def opt_state_from_numpy(cfg: ModelConfig, state, device: DeviceLike = "cuda") -> Dict:
    """An AdamW state (`optim.adamw_init`'s structure) from the JAX
    package's (numpy arrays): ``mu`` and ``nu`` keep their dtype (bfloat16
    as ml_dtypes' or as uint16 bits, else float32), ``master`` is fp32,
    ``step`` an int32 scalar."""
    dev = resolve_device(device)
    specs = model_specs(cfg)

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


def train_state_to_tree(model: Union[LM, EncDecLM], opt: Dict) -> Dict:
    """The train state of any family's model (`LM` or `EncDecLM`) as the
    JAX driver's checkpoint tree: the model's live Parameters and the live
    optimizer state (a checkpoint snapshot copies them to the host)."""
    return {"params": model.param_tree(), "opt": opt}


@torch.no_grad()
def train_state_from_tree(tree, model: Union[LM, EncDecLM], opt: Dict) -> Dict:
    """Copy a restored checkpoint tree (tensors on any device) into the
    Parameters of ``model`` (`LM` or `EncDecLM`) and ``opt`` in place, and
    return ``opt``.  In place
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
