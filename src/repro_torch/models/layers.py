"""Shared building blocks (`repro.models.layers`) with the reference's casts.

Norms and rotary angles are computed in fp32 and cast back; the MLP
activation is taken in fp32 and cast before the gating product.  The
attention itself lives in `kernels.flash_attention` (full sequence) and
`kernels.flash_decode` (one token against a cache).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

F32 = torch.float32


def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones", dtype="float32")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    angles = positions[..., :, None].to(F32) * freqs       # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ff"), dtype=cfg.dtype),
        "w_up": ParamSpec((d, f), ("embed", "ff"), dtype=cfg.dtype),
        "w_down": ParamSpec((f, d), ("ff", "embed"), dtype=cfg.dtype),
    }


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    g = x @ p.w_gate
    u = x @ p.w_up
    if act == "swiglu":
        h = F.silu(g.float()).to(x.dtype) * u
    elif act == "geglu":
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    else:
        raise ValueError(act)
    return h @ p.w_down


def per_seq_positions(index, B: int, device) -> torch.Tensor:
    """Decode position(s) -> (B, 1) int64.  ``index`` is an int (every
    sequence at the same position) or (B,) (continuous batching: every slot
    at its own position)."""
    if isinstance(index, int):
        return torch.full((B, 1), index, dtype=torch.int64, device=device)
    idx = torch.as_tensor(index).to(device=device, dtype=torch.int64)
    return idx.reshape(-1, 1).expand(B, 1)


def cache_insert(cache: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Write one token of K or V at per-sequence positions, IN PLACE.

    cache (B, S, K, D); new (B, 1, K, D); index an int or (B,).  The JAX
    reference returns an updated copy and its batcher donates the old
    cache; here the cache is updated where it lies and returned, so no step
    copies it.
    """
    if isinstance(index, int):
        cache[:, index] = new[:, 0].to(cache.dtype)
        return cache
    B = cache.shape[0]
    idx = torch.as_tensor(index).to(device=cache.device, dtype=torch.int64)
    rows = torch.arange(B, device=cache.device)
    cache[rows, idx.reshape(-1).expand(B)] = new[:, 0].to(cache.dtype)
    return cache
