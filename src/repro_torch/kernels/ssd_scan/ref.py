"""Plain PyTorch chunked SSD scan (Mamba-2), on any device.

The chunked algorithm of `repro.models.ssm._ssd_chunked` in the port's
layout, with the products grouped as ``kernel.cu`` groups them (and as the
TPU kernel does): intra-chunk ``((C . B^T) o L) . (x dt)``, the carried
state's share ``(C exp(cum)) . S``, and the state update ``exp(cum_last) S
+ B^T . (x dt seg)``.  Everything is fp32; S is padded up to a multiple of
the chunk with zero rows (dt = 0 leaves the state unchanged), which the
kernel masks instead.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H); A (H,) < 0; B, C (B, S, N).

    Returns y (B, S, H, P) fp32 and the final state (B, H, P, N) fp32.
    """
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    xf, dtf, Bf, Cf = x.to(F32), dt.to(F32), B.to(F32), C.to(F32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xc = xf.reshape(Bsz, nc, Q, H, P)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    Bc = Bf.reshape(Bsz, nc, Q, N)
    Cc = Cf.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dtc * A.to(F32), dim=2)               # (B, nc, Q, H)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0 (the
    # exponent of i < j is positive and may overflow; `where` drops it)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, nc, Q, Q, H)
    L = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    del diff
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    xdt = xc * dtc[..., None]                                 # (B, nc, Q, H, P)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xdt)
    del L

    # per-chunk states, then the recurrence over chunks
    seg = torch.exp(cum[:, :, -1:, :] - cum)                  # (B, nc, Q, H)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xdt * seg[..., None])
    decay = torch.exp(cum[:, :, -1, :])                       # (B, nc, H)
    s = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    incoming = []
    for c in range(nc):
        incoming.append(s)
        s = s * decay[:, c, :, None, None] + states[:, c]
    incoming = torch.stack(incoming, dim=1)                   # (B, nc, H, P, N)

    # the carried state's share
    ce = Cc[:, :, :, None, :] * torch.exp(cum)[..., None]     # (B, nc, Q, H, N)
    y = y + torch.einsum("bcihn,bchpn->bcihp", ce, incoming)
    return y.reshape(Bsz, nc * Q, H, P)[:, :S], s
