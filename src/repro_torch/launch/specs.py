"""Dry-run input specs (`repro.launch.specs`): fake-tensor DTensors for
every input of a cell's step.

Each input is rank 0's local shard, a `FakeTensor` made under the module's
one `FakeTensorMode` (no storage is allocated), wrapped by
``DTensor.from_local(..., shape=, stride=, run_check=False)`` with the
placements its partition spec resolves to (`train.sharding`).  The shapes,
dtypes and the encoder-decoder and patch-frontend branches are the JAX
package's.  ``input_specs`` returns the argument tuple of the cell's step
(`launch.dryrun.build_step`): train -> (params, opt, batch); prefill ->
(params, *inputs); decode -> (params, cache, token, index).  The decode
``index`` is an int, the cache's last position: the port's decode step
takes a host index where the JAX step is traced over an abstract one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..models import model_cache_specs, model_specs
from ..models.config import ModelConfig, ShapeConfig
from ..models.params import DTYPES, ParamSpec, map_specs
from ..optim import adamw_init_specs
from ..train.sharding import (PSpec, ShardingPlan, batch_pspec, local_shape, placements,
                              resolve_leaf)

INT = torch.int32
BF16 = torch.bfloat16

_FAKE: List[Optional[object]] = [None]


def fake_mode():
    """The one `FakeTensorMode` of the dry run: the inputs' shards and
    everything the traced step makes live in it."""
    if _FAKE[0] is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE[0] = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE[0]


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def fake_dtensor(shape, dtype: torch.dtype, plan: ShardingPlan, pspec: PSpec):
    """A DTensor of global ``shape`` laid out as ``pspec`` on the plan's
    mesh, its local shard a fake tensor (nothing allocated)."""
    from torch.distributed.tensor import DTensor

    with fake_mode():
        local = torch.empty(local_shape(shape, pspec, plan.axis_sizes), dtype=dtype)
    return DTensor.from_local(local, plan.mesh, placements(pspec, plan.mesh),
                              shape=torch.Size(shape), stride=_contiguous_stride(shape),
                              run_check=False)


def abstract_sharded_params(specs, plan: ShardingPlan):
    def one(s: ParamSpec):
        return fake_dtensor(s.shape, DTYPES[s.dtype], plan, resolve_leaf(s, plan))
    return map_specs(one, specs)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic families."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch at 524k context "
                       "(KV cache O(S) per token, attention O(S^2))")
    return True, ""


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan
                ) -> Dict:
    """Training-batch abstract inputs."""
    B, S = shape.global_batch, shape.seq_len
    bp = batch_pspec(plan, 2, B)
    out = {}
    if cfg.family == "encdec":
        # enc frames = S (stub audio), teacher-forced text = S // 4
        Sd = max(S // 4, 16)
        out["frames"] = fake_dtensor((B, S, cfg.d_model), BF16, plan,
                                     batch_pspec(plan, 3, B))
        out["tokens"] = fake_dtensor((B, Sd), INT, plan, bp)
        out["labels"] = fake_dtensor((B, Sd), INT, plan, bp)
    elif cfg.frontend == "patch_stub":
        St = S - cfg.n_frontend_tokens
        out["embeds"] = fake_dtensor((B, cfg.n_frontend_tokens, cfg.d_model),
                                     BF16, plan, batch_pspec(plan, 3, B))
        out["tokens"] = fake_dtensor((B, St), INT, plan, bp)
        out["labels"] = fake_dtensor((B, St), INT, plan, bp)
    else:
        out["tokens"] = fake_dtensor((B, S), INT, plan, bp)
        out["labels"] = fake_dtensor((B, S), INT, plan, bp)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan):
    """(cache, token, index) inputs of the serve step."""
    B, S = shape.global_batch, shape.seq_len
    enc_len = min(S, 4096) if cfg.family == "encdec" else None
    cache = abstract_sharded_params(model_cache_specs(cfg, B, S, enc_len), plan)
    token = fake_dtensor((B, 1), INT, plan, batch_pspec(plan, 2, B))
    return cache, token, S - 1


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan):
    B, S = shape.global_batch, shape.seq_len
    bp = batch_pspec(plan, 2, B)
    if cfg.family == "encdec":
        return (fake_dtensor((B, S, cfg.d_model), BF16, plan,
                             batch_pspec(plan, 3, B)),)
    if cfg.frontend == "patch_stub":
        return (fake_dtensor((B, S - cfg.n_frontend_tokens), INT, plan, bp),
                fake_dtensor((B, cfg.n_frontend_tokens, cfg.d_model), BF16,
                             plan, batch_pspec(plan, 3, B)))
    return (fake_dtensor((B, S), INT, plan, bp),)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan,
                with_optimizer: bool = True, opt_cfg=None):
    """Full abstract argument tuple for the step of this cell."""
    specs = model_specs(cfg)
    params = abstract_sharded_params(specs, plan)
    if shape.kind == "train":
        args = [params]
        if with_optimizer:
            state_dtype = (opt_cfg.state_dtype if opt_cfg is not None
                           else "float32")
            args.append(abstract_sharded_params(
                adamw_init_specs(specs, state_dtype), plan))
        args.append(batch_specs(cfg, shape, plan))
        return tuple(args)
    if shape.kind == "prefill":
        return (params,) + prefill_specs(cfg, shape, plan)
    cache, token, index = decode_specs(cfg, shape, plan)
    return (params, cache, token, index)
