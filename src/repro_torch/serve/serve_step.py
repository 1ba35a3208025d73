"""Serving steps (`repro.serve.serve_step`): batched prefill and one-token
decode with greedy sampling (token in, token out)."""
from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig


def make_serve_step(model, cfg: ModelConfig):
    def serve_step(cache, token: torch.Tensor, index):
        """token (B, 1) int; index an int position or (B,) positions.
        Returns (next_token (B, 1) int32, logits (B, 1, V), cache), the
        cache updated in place."""
        logits, cache = model.decode_step(cache, token, index)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


def make_prefill_step(model, cfg: ModelConfig):
    """Prompt -> (last-token logits, decode cache).  Dense family: the KV
    cache of ``cache_len`` positions, which defaults to the prompt length as
    in the JAX package (a server that decodes next passes prompt +
    generation length).  Ssm family: the logits of the JAX prefill step
    (forward, last position), and the O(1) state cache its server decodes
    from, built by the same forward pass; ``cache_len`` does not size it."""
    def prefill(tokens: torch.Tensor, cache_len: Optional[int] = None):
        return model.prefill(tokens, cache_len=cache_len or tokens.shape[1])

    return prefill
