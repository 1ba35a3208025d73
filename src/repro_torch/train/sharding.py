"""Logical-axis -> mesh-axis sharding rules with divisibility fallback
(`repro.train.sharding`).

Every parameter and cache dim carries a logical name (`ParamSpec.axes`);
an ordered candidate list maps names to mesh axes; resolution checks
divisibility and one-mesh-axis-per-leaf uniqueness in two passes
(primary, then fallback), so any of the 10 architectures (9 heads, 10
heads, kv=1, 128 experts, ...) resolves to a legal sharding on the
production mesh without per-arch hand edits.  The host logic is the JAX
package's line for line.

A partition spec is a plain tuple with one mesh-axis candidate per dim
(None, a name, or a tuple of names), the values of JAX's ``P(...)``.
`placements` turns it into DTensor placements on a `DeviceMesh` whose
dim names are the mesh axes: ``Shard(d)`` on every mesh dim that shards
tensor dim d (a dim over ``("pod", "data")`` is sharded on both, pod
major, as JAX lays it out), ``Replicate()`` on the others.

`constrain` is the JAX ``with_sharding_constraint`` by logical names: under
an active plan (`use_plan`) it redistributes a DTensor to the resolved
placements, and its gradient to the same ones; a plain tensor, or any tensor without a plan, passes through
unchanged, so the single-device paths are bit-identical with or without
the calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Candidate = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[Candidate, ...]


def default_rules(multi_pod: bool) -> Dict[str, List[Candidate]]:
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return {
        # weights: FSDP over data(+pod) on the model dim, TP over model
        "embed": [dp, ("data",), None],
        "vocab": [("model",), None],
        "heads": [("model",), None],
        "kv_heads": [("model",), None],
        "ff": [("model",), None],
        "experts": [("model",), None],
        "rnn": [("model",), None],
        "inner": [("model",), None],
        "layers": [None],
        # activations / caches
        "batch": [dp, ("data",), None],
        "kv_len": [None, ("model",)],     # fallback: sequence-shard cache
        "kv_heads_cache": [("model",), None],
        "heads_cache": [("model",), None],
        # activation constraints (see constrain())
        "act_batch": [dp, ("data",), None],
        "act_seq": [None],
        "act_embed": [None],
        "act_heads": [("model",), None],
        "act_ff": [("model",), None],
        "act_vocab": [("model",), None],
        "act_experts": [("model",), None],
    }


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or of any object whose
    ``shape`` is already that mapping, as the tests' shape-only meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.mesh.shape))


@dataclasses.dataclass
class ShardingPlan:
    mesh: object
    rules: Dict[str, List[Candidate]]
    multi_pod: bool

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)


def make_plan(mesh, multi_pod: Optional[bool] = None,
              rules: Optional[Dict[str, List[Candidate]]] = None
              ) -> ShardingPlan:
    if multi_pod is None:
        multi_pod = "pod" in mesh_shape(mesh)
    return ShardingPlan(mesh, rules or default_rules(multi_pod), multi_pod)


def _axes_size(sizes: Dict[str, int], cand: Candidate) -> int:
    if cand is None:
        return 1
    names = (cand,) if isinstance(cand, str) else cand
    return int(np.prod([sizes[n] for n in names]))


def _axes_names(cand: Candidate) -> Tuple[str, ...]:
    if cand is None:
        return ()
    return (cand,) if isinstance(cand, str) else tuple(cand)


def resolve_leaf(spec, plan: ShardingPlan) -> PSpec:
    """Two-pass assignment: primary candidates first, fallbacks second."""
    sizes = plan.axis_sizes
    used: set = set()
    assign: List[Candidate] = [None] * len(spec.shape)

    def try_assign(dim: int, cand: Candidate) -> bool:
        names = _axes_names(cand)
        if any(n in used for n in names):
            return False
        if names and spec.shape[dim] % _axes_size(sizes, cand) != 0:
            return False
        assign[dim] = cand
        used.update(names)
        return True

    # pass 1: primary candidate per named dim
    for dim, name in enumerate(spec.axes):
        if name is None:
            continue
        cands = plan.rules.get(name, [None])
        if cands and _axes_names(cands[0]):
            try_assign(dim, cands[0])
    # pass 2: fallbacks for still-unassigned named dims
    for dim, name in enumerate(spec.axes):
        if name is None or assign[dim] is not None:
            continue
        for cand in plan.rules.get(name, [None])[1:]:
            if cand is None:
                break
            if try_assign(dim, cand):
                break
    return tuple(assign)


def resolve_specs(specs, plan: ShardingPlan):
    """ParamSpec tree -> partition-spec tree."""
    from ..models.params import map_specs

    return map_specs(lambda s: resolve_leaf(s, plan), specs)


def batch_pspec(plan: ShardingPlan, rank: int, batch_size: int) -> PSpec:
    """Activation sharding: batch dim over DP axes (with divisibility
    fallback for e.g. long_500k's global_batch=1)."""
    for cand in [plan.dp_axes, ("data",), None]:
        if cand is None:
            return (None,) * rank
        if batch_size % _axes_size(plan.axis_sizes, cand) == 0:
            return (cand,) + (None,) * (rank - 1)
    return (None,) * rank


def placements(spec: PSpec, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a `DeviceMesh` named by the mesh
    axes) for the partition spec ``spec``: one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, cand in enumerate(spec) if axis in _axes_names(cand)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape: Sequence[int], spec: PSpec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` laid out as ``spec``."""
    return tuple(n // _axes_size(sizes, cand) for n, cand in zip(shape, spec))


# --- activation sharding constraints -----------------------------------
#
# Sharding propagation alone mis-shards activations when params are FSDP-
# sharded on contracting dims (e.g. the embedding lookup into a table
# sharded on the vocab dim leaves a masked partial, and one sharded on
# d_model drops the batch sharding).  Models call ``constrain(x, ...)``
# with logical names, resolved against the active plan (no-op when unset,
# e.g. in single-device runs).

_ACTIVE_PLAN: List[Optional[ShardingPlan]] = [None]


def set_activation_plan(plan: Optional[ShardingPlan]) -> None:
    _ACTIVE_PLAN[0] = plan


class use_plan:
    def __init__(self, plan: ShardingPlan):
        self.plan = plan

    def __enter__(self):
        self.prev = _ACTIVE_PLAN[0]
        _ACTIVE_PLAN[0] = self.plan
        return self.plan

    def __exit__(self, *exc):
        _ACTIVE_PLAN[0] = self.prev
        return False


def redistribute(x, mesh, target: tuple):
    """``x`` (a DTensor) laid out as ``target``.  A partial (a sum, or the
    masked partial a lookup into a vocab-sharded table leaves) is reduced
    first, where its mesh dim is not a shard in ``target``: a partial goes
    straight to a shard only by reduce-scatter, which the masked partial
    does not support."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if tuple(x.placements) == tuple(target):
        return x
    if any(isinstance(p, Partial) for p in x.placements):
        mid = tuple(Replicate() if isinstance(p, Partial)
                    and not (type(p) is Partial and isinstance(t, Shard)) else p
                    for p, t in zip(x.placements, target))
        if mid != tuple(x.placements):
            x = x.redistribute(mesh, mid)
    return x.redistribute(mesh, target)


def zeros(shape, names: Sequence[Optional[str]], dtype, device, like=None):
    """``torch.zeros``; under an active plan, when ``like`` is a DTensor, a
    DTensor of zeros laid out as the logical axes ``names``."""
    import torch

    plan = _ACTIVE_PLAN[0]
    from torch.distributed.tensor import DTensor

    if plan is None or not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dtensor_zeros

    from ..models.params import ParamSpec

    spec = ParamSpec(tuple(shape), tuple(names), dtype="float32")
    return dtensor_zeros(shape, dtype=dtype, device_mesh=plan.mesh,
                         placements=placements(resolve_leaf(spec, plan), plan.mesh))


def constrain(x, names: Sequence[Optional[str]]):
    """The layout of the logical axes ``names`` under the active plan
    (divisibility-safe): a redistribute of a DTensor, else ``x`` itself."""
    plan = _ACTIVE_PLAN[0]
    if plan is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from ..models.params import ParamSpec

    spec = ParamSpec(tuple(x.shape), tuple(names), dtype="float32")
    return relayout(x, plan.mesh, placements(resolve_leaf(spec, plan), plan.mesh))


def relayout(x, mesh, target: tuple):
    """The DTensor ``x`` laid out as ``target``, and its gradient too (JAX
    constrains the cotangent as well): an op that gathered or resharded
    its input would leave its gradient in that layout otherwise."""
    from torch.distributed.tensor import DTensor

    x = redistribute(x, mesh, target)
    return DTensor.from_local(x.to_local(grad_placements=target), mesh, target,
                              run_check=False)
