"""Plain PyTorch one-token GQA attention against a cache, on any device.

A direct masked softmax computing what ``kernel.cu`` computes: q taken to
fp32 and scaled in fp32, fp32 scores, positions at or past ``lens[b]``
masked with -1e30, p rounded to the cache dtype before the PV product,
fp32 sums, output divided by max(l, 1e-30).
"""
from __future__ import annotations

import torch

NEG = -1e30


def as_lens(cache_len, B: int, device) -> torch.Tensor:
    """cache_len (int, 0-d or (B,) tensor/array) -> (B,) int32 on ``device``.
    A Python int is filled on the device: no host-to-device copy."""
    if isinstance(cache_len, int):
        return torch.full((B,), cache_len, dtype=torch.int32, device=device)
    lens = torch.as_tensor(cache_len).to(device=device, dtype=torch.int32)
    return lens.reshape(-1).expand(B).contiguous()


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     scale: float) -> torch.Tensor:
    """q (B, 1, H, D); caches (B, S, K, D); cache_len scalar or (B,)."""
    B, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    lens = as_lens(cache_len, B, q.device)
    qf = q.float().reshape(B, K, G, D) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]  # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                    # (B, K, G)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                      v_cache.float())
    out = pv / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
