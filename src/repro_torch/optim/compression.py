"""Gradient compression with error feedback (`repro.optim.compression`).

Before a data-parallel reduction the gradients are cast to bf16, or to
int8 with one scale a tensor (``max |g| / 127``, rounded half to even as
``jnp.round``, clipped to +-127); the residual ``g - decompressed`` is fed
into the next call.  The train step calls it with no residual every step,
as the JAX one does, so the feedback starts anew each step.
"""
from __future__ import annotations

import torch

from ..models.params import tree_map

F32 = torch.float32


def _compress(g: torch.Tensor, r: torch.Tensor, method: str):
    g = g.to(F32) + r
    if method == "bf16":
        q = g.to(torch.bfloat16)
        back = q.to(F32)
    elif method == "int8":
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        back = q.to(F32) * scale
        q = (q, scale)
    else:
        raise ValueError(method)
    return q, g - back


def compress_grads(grads, method: str, residual=None):
    """Returns (compressed tree, new residual); the residual matches
    ``grads`` in fp32.  An int8 leaf is a (codes, scale) pair."""
    if method == "none":
        return grads, residual
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device),
                            grads)
    pairs = tree_map(lambda g, r: _compress(g, r, method), grads, residual)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def decompress_grads(comp, method: str):
    if method == "none":
        return comp
    if method == "bf16":
        return tree_map(lambda q: q.to(F32), comp)
    if method == "int8":
        return tree_map(lambda q: q[0].to(F32) * q[1], comp)
    raise ValueError(method)
