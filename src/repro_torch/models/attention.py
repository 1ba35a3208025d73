"""GQA/MQA attention with RoPE (`repro.models.attention`).

The full-sequence path (training forward, prefill) goes through
`kernels.flash_attention`, the one-token path through
`kernels.flash_decode`: the hand-written CUDA kernels for tensors on the
card, their plain versions for tensors on the CPU (through `spmd`, which
runs them per device on DTensors).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_decode.ref import as_lens
from .config import ModelConfig
from .layers import per_seq_positions, rotary
from .params import ParamSpec
from .spmd import cache_insert, flash_attention, flash_decode, merge_heads, pad, split_heads


def attention_specs(cfg: ModelConfig) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "w_q": ParamSpec((d, H * hd), ("embed", "heads"), dtype=cfg.dtype),
        "w_k": ParamSpec((d, K * hd), ("embed", "kv_heads"), dtype=cfg.dtype),
        "w_v": ParamSpec((d, K * hd), ("embed", "kv_heads"), dtype=cfg.dtype),
        "w_o": ParamSpec((H * hd, d), ("heads", "embed"), dtype=cfg.dtype),
    }


def qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ p.w_q, H, hd)
    k = split_heads(x @ p.w_k, K, hd)
    v = split_heads(x @ p.w_v, K, hd)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              window: Optional[int] = None, causal: bool = True,
              return_kv: bool = False):
    """Full-sequence (train/prefill) attention. x: (B, S, d).  ``window``
    is the sliding local attention width (a query sees its last
    ``window`` positions), ``causal=False`` the encoder's unmasked
    self-attention.

    ``return_kv=True`` also returns the (k, v) projections, so a prefill
    can build its decode cache without projecting K/V a second time."""
    B, S, _ = x.shape
    q, k, v = qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal, scale=cfg.head_dim ** -0.5,
                          window=window)
    out = merge_heads(out) @ p.w_o
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, index):
    """One-token decode. x (B, 1, d); caches (B, S, K, hd), updated in
    place; index an int or (B,) per-sequence positions.
    Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = per_seq_positions(index, B, x.device)
    q = rotary(split_heads(x @ p.w_q, H, hd), positions, cfg.rope_theta)
    k = rotary(split_heads(x @ p.w_k, K, hd), positions, cfg.rope_theta)
    v = split_heads(x @ p.w_v, K, hd)
    cache_insert(cache_k, k, index)
    cache_insert(cache_v, v, index)
    lens = index + 1 if isinstance(index, int) else as_lens(index, B, x.device) + 1
    out = flash_decode(q, cache_k, cache_v, lens, scale=hd ** -0.5)
    return merge_heads(out) @ p.w_o, cache_k, cache_v


def prefill_kv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               cache_len: int):
    """K/V of the prompt, padded with zeros to ``cache_len`` positions."""
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    k = rotary(split_heads(x @ p.w_k, K, hd), positions, cfg.rope_theta)
    v = split_heads(x @ p.w_v, K, hd)
    widths = (0, 0, 0, 0, 0, cache_len - S)
    return pad(k, widths), pad(v, widths)
