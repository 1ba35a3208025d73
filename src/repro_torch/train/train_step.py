"""Train step (`repro.train.train_step`): loss, gradients, optional
compression, AdamW.

The gradients are autograd's with respect to the model's working weights
in their own dtype (bf16 gradients for bf16 leaves, as `jax.value_and_grad`
gives); the attention kernel's backward is `FlashAttention`'s recompute
through the plain version.  With ``n_microbatches > 1`` the global batch
is split along axis 0 and the gradients add up in fp32.  The JAX step
returns new parameters; here the model's parameters and the optimizer
state are updated in place (`adamw_update`).  Profiler ranges
(``train_step.forward``, ``.backward``, ``.optimizer``) mark the step's
parts; they cost nothing while no profiler runs.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..models.config import ModelConfig
from ..models.params import tree_leaves, tree_map
from ..optim import (AdamWConfig, adamw_update, compress_grads,
                     decompress_grads)

F32 = torch.float32


def loss_fn(model, batch: Dict, cfg: ModelConfig, loss_impl: str = "gather"):
    """Next-token cross-entropy over the positions with ``labels >= 0``,
    plus the MoE aux loss (0 for the dense family).  Returns (loss,
    {"ce", "aux"}).

    ``loss_impl``: ``gather`` takes the label's log-probability from
    `log_softmax`; ``onehot`` contracts the logits with a one-hot of the
    labels and subtracts the logsumexp (the JAX package's layout for
    vocab-sharded logits; one device computes the same number).
    """
    labels = batch["labels"].to(model.device)
    logits, aux = model(batch["tokens"].to(model.device))
    logits = logits.to(F32)
    mask = (labels >= 0).to(F32)
    if loss_impl == "gather":
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    elif loss_impl == "onehot":
        lse = torch.logsumexp(logits, dim=-1)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (labels.long()[..., None] == vocab).to(logits.dtype)
        ll = torch.einsum("bsv,bsv->bs", logits, onehot) - lse
    else:
        raise ValueError(loss_impl)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def loss_and_grads(model, batch: Dict, cfg: ModelConfig, loss_impl: str = "gather"):
    """(loss, metrics, grads): `loss_fn` and its gradients with respect to
    the model's parameters (which must require them), in the parameter
    tree's structure and dtypes, layers stacked (`jax.value_and_grad`)."""
    params = model.param_tree()
    with record_function("train_step.forward"):
        loss, metrics = loss_fn(model, batch, cfg, loss_impl)
    with record_function("train_step.backward"):
        gs = iter(torch.autograd.grad(loss, tree_leaves(params)))
    grads = tree_map(lambda _: next(gs), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_microbatches: int = 1, loss_impl: str = "gather"):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``,
    which updates the model's parameters and ``opt_state`` in place.
    ``metrics`` holds ``loss``, ``lr`` and ``grad_norm`` as fp32 scalars on
    the device (and ``ce``, ``aux`` without microbatches).  Makes the
    model's parameters require gradients."""
    model.requires_grad_(True)
    params = model.param_tree()

    def accumulate(batch):
        micro = {k: v.reshape(n_microbatches, -1, *v.shape[1:])
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                       params)
        loss_sum = 0.0
        for i in range(n_microbatches):
            loss, _, grads = loss_and_grads(model, {k: v[i] for k, v in micro.items()},
                                            cfg, loss_impl)
            with record_function("train_step.backward"):
                acc = tree_map(lambda a, g: a.add_(g.to(F32)), acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / n_microbatches, acc)
        return loss_sum / n_microbatches, {}, grads

    def train_step(opt_state, batch):
        if n_microbatches > 1:
            loss, metrics, grads = accumulate(batch)
        else:
            loss, metrics, grads = loss_and_grads(model, batch, cfg, loss_impl)
        with record_function("train_step.optimizer"):
            if opt_cfg.grad_compression != "none":
                # the round trip a compressed all-reduce would make; the
                # residual starts anew each step, as in the JAX step
                comp, _ = compress_grads(grads, opt_cfg.grad_compression)
                grads = decompress_grads(comp, opt_cfg.grad_compression)
            _, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params)
        return opt_state, dict(metrics, loss=loss, **om)

    return train_step
