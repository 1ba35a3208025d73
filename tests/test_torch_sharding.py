"""Port parity: the sharding rules (`repro_torch.train.sharding`) against
the JAX package's, exactly.

Every leaf of every arch's full config (parameters, AdamW state and the
decode cache) resolves to the same mesh axes on the 16 x 16 and
2 x 16 x 16 production meshes, as shape-only meshes (the pattern of
tests/test_sharding.py).  A port partition spec is a tuple of the JAX
``P``'s entries; both sides are compared as tuples of axis-name tuples.
On a 2 x 2 mesh of the fake process group, `placements` lays DTensors out
as the spec says (exact local shapes), and `constrain` is the identity
without a plan.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.params import is_spec as j_is_spec
from repro.optim import adamw_init_specs as j_adamw_init_specs
from repro.train.sharding import batch_pspec as j_batch_pspec
from repro.train.sharding import make_plan as j_make_plan
from repro.train.sharding import resolve_leaf as j_resolve_leaf
from repro_torch.configs import get_config
from repro_torch.models import model_cache_specs, model_specs
from repro_torch.models.params import ParamSpec, tree_leaves
from repro_torch.optim import adamw_init_specs
from repro_torch.train.sharding import (batch_pspec, constrain, local_shape, make_plan,
                                        placements, resolve_leaf, resolve_specs, use_plan)
from torch_fake_world import ShapeMesh, mesh2x2  # noqa: F401

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def norm(spec):
    """A partition spec as a tuple of axis-name tuples."""
    return tuple(() if c is None else (c,) if isinstance(c, str) else tuple(c)
                 for c in spec)


def plans(mesh):
    m = ShapeMesh(MESHES[mesh])
    return j_make_plan(m), make_plan(m)


def jax_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree, is_leaf=j_is_spec)


def spec_trees(arch, B=128, S=32768):
    """(JAX, port) spec trees of the arch's full config: parameters, AdamW
    state, decode cache."""
    jcfg, cfg = j_get_config(arch), get_config(arch, abstract=True)
    jm = j_build_model(jcfg)
    enc = dict(enc_len=min(S, 4096)) if jcfg.family == "encdec" else {}
    jt = {"params": jm.specs(), "opt": j_adamw_init_specs(jm.specs()),
          "cache": jm.cache_specs(B, S, **enc)}
    pt = {"params": model_specs(cfg), "opt": adamw_init_specs(model_specs(cfg)),
          "cache": model_cache_specs(cfg, B, S, enc.get("enc_len"))}
    return jt, pt


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_specs_equal_jax_leaf_for_leaf(arch):
    """Shapes, logical axes, dtypes and inits of every leaf of the full
    config's parameters, AdamW state and decode cache."""
    jt, pt = spec_trees(arch)
    want, got = jax_leaves(jt), tree_leaves(pt)
    assert len(want) == len(got) > 0
    for (path, w), g in zip(want, got):
        assert (tuple(w.shape), tuple(w.axes), w.dtype, w.init) == \
            (tuple(g.shape), tuple(g.axes), g.dtype, g.init), jax.tree_util.keystr(path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_leaf_equals_jax(arch, mesh):
    """Every leaf of every arch's full config resolves to JAX's spec."""
    jplan, plan = plans(mesh)
    jt, pt = spec_trees(arch)
    tree = tree_leaves(resolve_specs(pt, plan))
    for (path, w), g, got in zip(jax_leaves(jt), tree_leaves(pt), tree):
        assert norm(resolve_leaf(g, plan)) == norm(j_resolve_leaf(w, jplan)) == norm(got), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_leaf_equals_jax_on_drawn_specs(mesh):
    """Random logical axes and shapes (the names of the rules and None),
    as tests/test_sharding.py draws them."""
    jplan, plan = plans(mesh)
    names = list(plan.rules) + [None]
    rng = np.random.default_rng(0)
    for _ in range(400):
        rank = int(rng.integers(1, 5))
        axes = tuple(names[i] for i in rng.integers(0, len(names), rank))
        shape = tuple(int(s) for s in rng.choice([1, 2, 9, 16, 56, 128, 256, 4096], rank))
        from repro.models.params import ParamSpec as JParamSpec
        want = j_resolve_leaf(JParamSpec(shape, axes), jplan)
        assert norm(resolve_leaf(ParamSpec(shape, axes), plan)) == norm(want), (shape, axes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_pspec_equals_jax(mesh):
    jplan, plan = plans(mesh)
    for rank in (1, 2, 3):
        for B in (1, 2, 16, 32, 128, 256, 512, 24):
            assert norm(batch_pspec(plan, rank, B)) == norm(j_batch_pspec(jplan, rank, B))


def test_rules_and_plans_equal_jax():
    for mesh in MESHES:
        jplan, plan = plans(mesh)
        assert plan.rules == jplan.rules
        assert plan.multi_pod == jplan.multi_pod and plan.dp_axes == jplan.dp_axes


@pytest.mark.parametrize("shape,spec", [
    ((8, 6), ("data", "model")), ((6, 8), (None, ("data", "model"))),
    ((4, 8, 2), (("data",), None, "model")), ((6,), (None,)),
    ((4, 4, 4), (None, "model", "data"))])
def test_placements_shard_the_local_tensor_as_the_spec(mesh2x2, shape, spec):
    """A DTensor laid out by `placements` holds, on each device, the
    global shape divided as the spec says: on rank 0 (this process; the
    fake group moves no data), the first block of every sharded dim."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    d = distribute_tensor(x, mesh2x2, placements(spec, mesh2x2))
    sizes = {"data": 2, "model": 2}
    assert tuple(d.to_local().shape) == local_shape(shape, spec, sizes)
    assert tuple(d.shape) == shape
    idx = tuple(slice(0, n) for n in local_shape(shape, spec, sizes))
    assert torch.equal(d.to_local(), x[idx])


def test_constrain_is_the_identity_without_a_plan(mesh2x2):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(4, 6, 8)
    assert constrain(x, ("act_batch", "act_seq", "act_embed")) is x
    d = distribute_tensor(x, mesh2x2, (Shard(2), Replicate()))
    assert constrain(d, ("act_batch", "act_seq", "act_embed")) is d
    # a plain tensor passes through under a plan too
    with use_plan(make_plan(mesh2x2)):
        assert constrain(x, ("act_batch", "act_seq", "act_embed")) is x
        c = constrain(d, ("act_batch", "act_seq", "act_embed"))
    assert tuple(c.placements) == (Shard(0), Replicate())
    assert tuple(c.shape) == (4, 6, 8) and tuple(c.to_local().shape) == (2, 6, 8)


def test_port_config_carries_the_jax_fields_a13_needs():
    """`moe_dispatch`, `sub_quadratic`, `q_per_kv` and `SHAPES` as in JAX."""
    from repro.models.config import SHAPES as J_SHAPES
    from repro_torch.models.config import SHAPES

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in ARCH_IDS:
        jcfg, cfg = j_get_config(arch), get_config(arch, abstract=True)
        assert (cfg.moe_dispatch, cfg.sub_quadratic, cfg.q_per_kv) == \
            (jcfg.moe_dispatch, jcfg.sub_quadratic, jcfg.q_per_kv)
