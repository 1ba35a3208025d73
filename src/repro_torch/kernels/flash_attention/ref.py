"""Plain PyTorch GQA attention with the flash kernel's casts, on any device.

A direct masked softmax (O(Sq * Skv) memory) computing what
``kernel.cu`` computes: fp32 scores from q taken to fp32 and scaled in
fp32, masked entries -1e30, p rounded to the input dtype before the PV
product, fp32 sums, and the output divided by max(l, 1e-30).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """(Sq, Skv) bool: query i sits at key position Skv - Sq + i."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, scale: float,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, K, D), H = K * G -> (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    mask = attention_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    s = s.masked_fill(~mask, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                    # (B, K, G, Sq)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    out = pv / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
