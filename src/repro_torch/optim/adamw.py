"""AdamW with fp32 master weights and moments (`repro.optim.adamw`).

The state is a dict of trees keyed like the LM's parameter tree: ``mu``
and ``nu`` in ``state_dtype``, fp32 ``master`` copies of the parameters,
and ``step`` (an int32 scalar on the parameters' device).  The arithmetic
is the JAX package's, in its order: the clip scale from the global norm,
the moments in fp32 stored in ``state_dtype``, bias correction with
``b ** step`` in fp32, decoupled weight decay on every leaf, and the
working weights recast from the masters.  `adamw_update` writes the
state and the working weights in place (the JAX update returns new
trees), so a step allocates no second copy of either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..models.params import DTYPES, ParamSpec, map_specs, tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # distributed-optimization knobs
    grad_compression: str = "none"   # none | bf16 | int8
    error_feedback: bool = True
    state_dtype: str = "float32"     # moments dtype: float32 | bfloat16
                                     # (masters always fp32)


def adamw_init_specs(model_specs, state_dtype: str = "float32") -> Dict:
    """The state's `ParamSpec` tree (the JAX package's): the moments in
    ``state_dtype`` and the fp32 masters under the parameters' logical
    axes, and the int32 step."""
    def moment_like(s: ParamSpec) -> ParamSpec:
        return dataclasses.replace(s, dtype=state_dtype, init="zeros")

    return {"mu": map_specs(moment_like, model_specs),
            "nu": map_specs(moment_like, model_specs),
            "master": map_specs(lambda s: dataclasses.replace(s, dtype="float32"),
                                model_specs),
            "step": ParamSpec((), (), dtype="int32", init="zeros")}


def adamw_init(params, state_dtype: str = "float32") -> Dict:
    """Zero moments in ``state_dtype``, fp32 masters copied from
    ``params``, step 0."""
    dt = DTYPES[state_dtype]
    step_dev = tree_leaves(params)[0].device
    def zeros(p):  # a DTensor's moments laid out as the DTensor
        return torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)

    return {"mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr_peak``, then a cosine to 0 at
    ``total_steps``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr_peak * warm * 0.5 * (1 + torch.cos(math.pi * t))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state: Dict, params
                 ) -> Tuple[Dict, Dict, Dict]:
    """One step.  Returns (params, opt_state, metrics): the working
    weights ``params`` and the state, both updated in place, and
    ``{"lr", "grad_norm"}`` as fp32 scalars on the device."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.to(F32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for g, mu, nu, master, p in zip(*(tree_leaves(t) for t in (
            grads, opt_state["mu"], opt_state["nu"], opt_state["master"], params))):
        g = g.to(F32) * scale
        m = cfg.b1 * mu.to(F32) + (1 - cfg.b1) * g
        n = cfg.b2 * nu.to(F32) + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(n / bc2) + cfg.eps)
        master.copy_(master - lr * (delta + cfg.weight_decay * master))
        mu.copy_(m)
        nu.copy_(n)
        p.copy_(master)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
