"""Plain PyTorch chunked SSD scan (Mamba-2), on any device.

The chunked algorithm of `repro.models.ssm._ssd_chunked` in the port's
layout, with the products grouped as ``kernel.cu`` groups them (and as the
TPU kernel does): intra-chunk ``((C . B^T) o L) . (x dt)``, the carried
state's share ``(C exp(cum)) . S``, and the state update ``exp(cum_last) S
+ B^T . (x dt seg)``.  Everything is fp32; S is padded up to a multiple of
the chunk with zero rows (dt = 0 leaves the state unchanged), which the
kernel masks instead.

`ssd_scan_split_ref` emulates the roundings of ``kernel.cu``'s bf16 body
(tensor-core products of bf16 operands, fp32 sums): the operands it forms
in fp32 are each split into hi + lo bf16 and multiplied twice.  Tests hold
it to ``ssd_scan_ref``; nothing on the serving path calls it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def causal_decay(diff: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """exp(diff) where ``causal``, else 0.  Above the diagonal diff =
    cum_i - cum_j is positive and may pass fp32's ~88.7, where exp gives
    inf: a `where` after the exp drops it from the forward, but the
    backward multiplies its zero cotangent by inf and gets NaN.  So the
    exponent is -inf there before the exp, whose value and gradient are
    then 0; on the causal part the values are exp's own."""
    return torch.exp(diff.masked_fill(~causal, float("-inf")))


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

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = causal_decay(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                     causal[None, None, :, :, None])          # (B, nc, Q, Q, H)
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


def split_bf16(v: torch.Tensor, lo_terms: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``v`` as hi = bf16(v) and lo = bf16(v - hi), both back in fp32
    (lo is 0 without ``lo_terms``: one rounding)."""
    hi = v.to(torch.bfloat16).to(F32)
    lo = (v - hi).to(torch.bfloat16).to(F32) if lo_terms else torch.zeros_like(v)
    return hi, lo


def ssd_scan_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                       lo_terms: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 body's arithmetic: x, B, C taken as bf16 values (exact
    operands), every other operand of a product split by `split_bf16`:
    - y_i = exp(cum_i) (C_i . S_hi + C_i . S_lo) + sum_j (G'_hi + G'_lo)_ij
      x_j, with G' = (C . B^T) o L o dt_j formed in fp32 for j <= i;
    - S <- exp(total) S + (x o w)_hi^T . B + (x o w)_lo^T . B, with
      w_j = dt_j exp(total - cum_j).
    Sums are fp32, chunk by chunk.  ``lo_terms=False`` rounds each such
    operand to bf16 once.  Same contract as `ssd_scan_ref`."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    bf = torch.bfloat16
    xf, Bf, Cf = (t.to(bf).to(F32) for t in (x, B, C))
    dtf, Af = dt.to(F32), A.to(F32)
    s = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        xc, dtc = xf[:, c0:c0 + q], dtf[:, c0:c0 + q]              # (B, q, H, P), (B, q, H)
        Bc, Cc = Bf[:, c0:c0 + q], Cf[:, c0:c0 + q]                # (B, q, N)
        cum = torch.cumsum(dtc * Af, dim=1)                         # (B, q, H)
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        L = causal_decay(cum[:, :, None, :] - cum[:, None, :, :], causal[None, :, :, None])
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)               # (B, q, q)
        g = scores[..., None] * L * dtc[:, None, :, :]              # (B, q, q, H)
        gh, gl = split_bf16(g, lo_terms)
        y = (torch.einsum("bijh,bjhp->bihp", gh, xc)
             + torch.einsum("bijh,bjhp->bihp", gl, xc))
        sh, sl = split_bf16(s, lo_terms)
        carried = (torch.einsum("bin,bhpn->bihp", Cc, sh)
                   + torch.einsum("bin,bhpn->bihp", Cc, sl))
        ys.append(y + torch.exp(cum)[..., None] * carried)
        total = cum[:, -1]                                          # (B, H)
        w = dtc * torch.exp(total[:, None] - cum)                   # (B, q, H)
        uh, ul = split_bf16(xc * w[..., None], lo_terms)
        s = (s * torch.exp(total)[..., None, None]
             + torch.einsum("bjhp,bjn->bhpn", uh, Bc)
             + torch.einsum("bjhp,bjn->bhpn", ul, Bc))
    return torch.cat(ys, dim=1), s
