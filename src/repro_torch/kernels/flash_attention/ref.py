"""Plain PyTorch GQA attention with the flash kernel's casts, on any device.

A direct masked softmax (O(Sq * Skv) memory) computing what
``kernel.cu`` computes: fp32 scores from q taken to fp32 and scaled in
fp32, masked entries -1e30, p rounded to the input dtype before the PV
product, fp32 sums, and the output divided by max(l, 1e-30).

`flash_attention_grad_ref` is its gradient as ``kernel.cu``'s gradient
kernels compute it, from the forward's output and logsumexp
(`flash_attention_lse_ref`, base 2): P = exp2(s - lse) in fp32, delta =
rowsum(dO o), P rounded to the input dtype before dV and dS = P (dP -
delta) before dQ and dK, fp32 sums.  `flash_attention_grad_f64` is the
same function's gradient in fp64 with nothing rounded: what both bf16
gradients approximate.  `grad_gaps` and `outside_grad_limits` hold the
kernels to the twin on the same tensors, within the ``GRAD_*`` limits.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30
LOG2E = 1.4426950408889634
# the gradient kernels against the twin on the same tensors: each gradient
# within 2^-9 of the twin in norm and every element within 2^-5 of its
# largest |g|; no farther from the fp64 gradient than 1.02 x the twin, and
# neither of them farther than 2^-7 in norm (a sound bf16 gradient reads
# ~2^-8.7, its result's own rounding ~2^-9.2), so that a wrong input the
# kernels and the twin share, such as the logsumexp, cannot pass; the
# logsumexp entry within 1e-4 of `flash_attention_lse_ref`
GRAD_NORM = 2 ** -9
GRAD_MAX = 2 ** -5
GRAD_VS_F64 = 1.02
GRAD_F64 = 2 ** -7
LSE_ATOL = 1e-4


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


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, scale: float,
            window: Optional[int]):
    """(B, K, G, Sq, Skv) fp32 scores of the unscaled q . k products times
    ``scale``, and the mask."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float().reshape(B, Sq, K, H // K, D), k.float())
    mask = attention_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    return s * scale, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool, scale: float,
                            window: Optional[int] = None) -> torch.Tensor:
    """(B, H, Sq) fp32: each (query, head) row's logsumexp of its scaled,
    masked scores in base 2, as the forward's logsumexp entry writes it."""
    B, Sq, H, _ = q.shape
    s, mask = _scores(q, k, causal=causal, scale=scale, window=window)
    lse = torch.logsumexp(s.masked_fill(~mask, NEG), dim=-1) * LOG2E
    return lse.reshape(B, H, Sq)


def flash_attention_grad_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, scale: float, window: Optional[int] = None):
    """The gradient of `flash_attention_ref` at (q, k, v) for the cotangent
    ``dout``, from its output ``out`` and ``lse`` (B, H, Sq): (dq, dk, dv)
    in q's dtype, rounded where the gradient kernels round."""
    dt = q.dtype
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    s, mask = _scores(q, k, causal=causal, scale=scale, window=window)
    p = torch.exp2(s * LOG2E - lse.reshape(B, K, G, Sq)[..., None])
    p = torch.where(mask, p, 0.0)
    do = dout.float().reshape(B, Sq, K, G, D)
    delta = (do * out.float().reshape(B, Sq, K, G, D)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(dt).float(), do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(B, Sq, K, G, D)) * scale
    return dq.reshape(B, Sq, H, D).to(dt), dk.to(dt), dv.to(dt)


def flash_attention_grad_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool, scale: float,
                             window: Optional[int] = None):
    """The gradient of masked softmax attention at the same (bf16 or fp32)
    values for the cotangent ``dout``, in fp64 with nothing rounded: (dq,
    dk, dv) in fp64, one sequence at a time so that the fp64 scores held
    are one sequence's."""
    _, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    mask = attention_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    grads = []
    for b in range(q.shape[0]):
        qb, kb, vb = (t[b:b + 1].detach().double().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            s = torch.einsum("bqkgd,bskd->bkgqs", qb.reshape(1, Sq, K, H // K, D), kb) * scale
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            out = torch.einsum("bkgqs,bskd->bqkgd", p, vb).reshape(1, Sq, H, D)
            grads.append(torch.autograd.grad(out, (qb, kb, vb), dout[b:b + 1].double()))
            del s, p, out
    return tuple(torch.cat(g) for g in zip(*grads))


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in fp64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def grad_gaps(got, twin, exact) -> dict:
    """For each of dq, dk, dv: its distance from the twin's in norm
    (``rel_norm``) and at its worst element as a share of the twin's
    largest |g| (``max_share``), and its and the twin's distances from the
    fp64 gradient ``exact`` in norm (``kernel_vs_f64``, ``twin_vs_f64``)."""
    gaps = {}
    for name, g, w, ex in zip(("dq", "dk", "dv"), got, twin, exact):
        gf, wf = g.float(), w.float()
        gaps[name] = dict(rel_norm=rel_norm(gf, wf),
                          max_share=float((gf - wf).abs().max() / wf.abs().max()),
                          kernel_vs_f64=rel_norm(g, ex), twin_vs_f64=rel_norm(w, ex))
    return gaps


def outside_grad_limits(gaps: dict) -> list:
    """The names in `grad_gaps`'s ``gaps`` outside the ``GRAD_*`` limits."""
    return [name for name, r in gaps.items()
            if not (r["rel_norm"] <= GRAD_NORM and r["max_share"] <= GRAD_MAX
                    and r["kernel_vs_f64"] <= GRAD_VS_F64 * r["twin_vs_f64"]
                    and max(r["kernel_vs_f64"], r["twin_vs_f64"]) <= GRAD_F64)]
