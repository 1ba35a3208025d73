"""Train step (`repro.train.train_step`): loss, gradients, optional
compression, AdamW.

The gradients are autograd's with respect to the model's working weights
in their own dtype (bf16 gradients for bf16 leaves, as `jax.value_and_grad`
gives); the attention kernel's backward is `FlashAttention`'s recompute
through the plain version.  With ``n_microbatches > 1`` the global batch
is split along axis 0 (tokens, labels and the ``frames`` or ``embeds``
alike) and the gradients add up in fp32.  The JAX step
returns new parameters; here the model's parameters and the optimizer
state are updated in place (`adamw_update`).  Spans (`obs.trace.span`:
``train_step.forward``, ``.backward``, ``.optimizer``) mark the step's
parts; while a profiler runs they are its ranges.  With no profiler and
no request trace each costs a ContextVar read and a module attribute
read, 0.27-0.65 us a call on the host of an H100 machine, where a bare
profiler range enters the dispatcher: 7.5-11.3 us a call there.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..models.params import tree_leaves, tree_map
from ..models.spmd import label_logprob, logsumexp
from ..obs.trace import span
from ..optim import (AdamWConfig, adamw_update, compress_grads,
                     decompress_grads)

F32 = torch.float32


def loss_fn(model, batch: Dict, cfg: ModelConfig, loss_impl: str = "gather"):
    """Next-token cross-entropy over the positions with ``labels >= 0``,
    plus the MoE aux loss (0 for the other families).  Returns (loss,
    {"ce", "aux"}).  The encoder-decoder family takes the batch's
    ``frames`` (B, S, d) into its encoder; with ``embeds`` (B, S_img, d) in
    the batch (the patch frontend) the model sees them before the tokens
    and the loss is taken on the text positions only.

    ``loss_impl``: ``gather`` takes the label's log-probability from
    `log_softmax`; ``onehot`` contracts the logits with a one-hot of the
    labels and subtracts the logsumexp (the JAX package's layout for
    vocab-sharded logits; one device computes the same number).
    """
    labels = batch["labels"].to(model.device)
    tokens = batch["tokens"].to(model.device)
    if cfg.family == "encdec":
        logits, aux = model(tokens, batch["frames"])
    elif "embeds" in batch:
        logits, aux = model(tokens, embeds=batch["embeds"])
        logits = logits[:, -tokens.shape[1]:]  # the loss on the text positions
    else:
        logits, aux = model(tokens)
    logits = logits.to(F32)
    mask = (labels >= 0).to(F32)
    if loss_impl == "gather":
        ll = label_logprob(logits, labels)
    elif loss_impl == "onehot":
        lse = logsumexp(logits)
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
    with span("train_step.forward"):
        loss, metrics = loss_fn(model, batch, cfg, loss_impl)
    with span("train_step.backward"):
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
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
        loss_sum = 0.0
        for i in range(n_microbatches):
            loss, _, grads = loss_and_grads(model, {k: v[i] for k, v in micro.items()},
                                            cfg, loss_impl)
            with span("train_step.backward"):
                acc = tree_map(lambda a, g: a.add_(g.to(F32)), acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / n_microbatches, acc)
        return loss_sum / n_microbatches, {}, grads

    def train_step(opt_state, batch):
        if n_microbatches > 1:
            loss, metrics, grads = accumulate(batch)
        else:
            loss, metrics, grads = loss_and_grads(model, batch, cfg, loss_impl)
        with span("train_step.optimizer"):
            if opt_cfg.grad_compression != "none":
                # the round trip a compressed all-reduce would make; the
                # residual starts anew each step, as in the JAX step
                comp, _ = compress_grads(grads, opt_cfg.grad_compression)
                grads = decompress_grads(comp, opt_cfg.grad_compression)
            _, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params)
        return opt_state, dict(metrics, loss=loss, **om)

    return train_step
