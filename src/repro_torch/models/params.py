"""Parameter specs and seeded initialisation (`repro.models.params`).

Models declare parameters as nested dicts of `ParamSpec`; the same
declaration gives the shapes, the initialisation and the parameter
count.  The sharding helpers (`partition_specs`, `named_shardings`) wait
for ROADMAP A13.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

LogicalAxes = Tuple[Optional[str], ...]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: LogicalAxes                      # logical name per dim (or None)
    dtype: str = "bfloat16"
    init: str = "normal"                   # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes rank mismatch {self.shape} {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[ParamSpec], object], specs):
    """Apply ``fn`` to every spec of a nested dict, keys in sorted order
    (the JAX package's tree order)."""
    if is_spec(specs):
        return fn(specs)
    return {k: map_specs(fn, specs[k]) for k in sorted(specs)}


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order (`jax.tree.leaves`)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure, keys in
    sorted order (`jax.tree.map`)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def init_params(specs, generator: Optional[torch.Generator], *,
                device: DeviceLike = "cuda"):
    """Tensors for ``specs``: normal x scale (drawn in fp32 from
    ``generator``, then cast), ones or zeros, on ``device``.  The
    generator must live on that device; specs of zeros and ones need
    none."""
    dev = resolve_device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        dt = DTYPES[s.dtype]
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * s.scale).to(dt)

    return map_specs(one, specs)


def count_params(specs) -> int:
    if is_spec(specs):
        return int(np.prod(specs.shape))
    return sum(count_params(v) for v in specs.values())
