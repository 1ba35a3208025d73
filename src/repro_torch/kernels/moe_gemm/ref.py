"""Plain PyTorch grouped SwiGLU expert GEMM, on any device.

The port's twin of `repro.kernels.moe_gemm.ref.moe_gemm_ref`: g and u in
fp32 from fp32-cast operands, h = silu(g) u rounded to the working dtype,
y = h Wd in fp32, rows at or past ``counts[e]`` set to 0, the result cast
to the working dtype.  ``kernel.cu`` computes the same function.

`moe_gemm_grad_ref` is its gradient as ``kernel.cu``'s backward computes
it: over the live rows only, with autograd's rounding points, and dg and du
entering their products as hi + lo pairs in the working dtype.
`moe_gemm_grad_f64` is the same function's gradient in fp64, h unrounded:
what both bf16 gradients approximate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def moe_gemm_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); w_gate, w_up (E, d, f); w_down (E, f, d); counts (E,)
    int.  Returns y (E, C, d) in x's dtype; rows >= counts[e] are 0."""
    xf = x.to(F32)
    g = torch.bmm(xf, w_gate.to(F32))
    u = torch.bmm(xf, w_up.to(F32))
    h = (F.silu(g) * u).to(x.dtype).to(F32)
    y = torch.bmm(h, w_down.to(F32))
    C = x.shape[1]
    live = torch.arange(C, device=x.device)[None, :] < counts[:, None]
    return torch.where(live[..., None], y, 0.0).to(x.dtype)


def split(v: torch.Tensor, dtype: torch.dtype):
    """fp32 ``v`` as hi + lo in ``dtype``: hi = v rounded, lo = (v - hi)
    rounded (exact, lo 0, when ``dtype`` is fp32)."""
    hi = v.to(dtype)
    return hi, (v - hi.to(F32)).to(dtype)


def moe_gemm_grad_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor, counts: torch.Tensor, dy: torch.Tensor):
    """The gradient of `moe_gemm_ref` at (x, w_gate, w_up, w_down) for the
    cotangent dy (E, C, d): (dx, dw_gate, dw_up, dw_down) in x's dtype.
    Rows at or past ``counts[e]`` take no part: their x and dy are read as
    0, so their dx is 0 and they add nothing to the weights' gradients.
    As autograd through `moe_gemm_ref` rounds: dh = dy Wd^T rounded to the
    dtype; g, u, silu and its derivative in fp32; dx, dWg, dWu and dWd
    fp32 sums rounded once.  dg and du (fp32) enter dx, dWg and dWu as
    split hi + lo pairs, the kernel's operands; the pairs carry ~16 bits of
    the fp32 mantissa in bf16, all of it in fp32."""
    dt = x.dtype
    C = x.shape[1]
    live = (torch.arange(C, device=x.device)[None, :] < counts[:, None])[..., None]
    xf = torch.where(live, x.to(F32), 0.0)
    dyf = torch.where(live, dy.to(F32), 0.0)
    wg, wu, wd = (w.to(F32) for w in (w_gate, w_up, w_down))
    g = torch.bmm(xf, wg)
    u = torch.bmm(xf, wu)
    s = torch.sigmoid(g)
    silu = g * s
    h = (silu * u).to(dt).to(F32)
    dh = torch.bmm(dyf, wd.transpose(1, 2)).to(dt).to(F32)
    du = dh * silu
    dg = dh * u * s * (1 + g * (1 - s))
    parts = [p.to(F32) for p in (*split(dg, dt), *split(du, dt))]
    dx = torch.bmm(torch.cat(parts, -1), torch.cat([wg, wg, wu, wu], -1).transpose(1, 2))
    xt = torch.cat([xf, xf], 1).transpose(1, 2)
    dwg = torch.bmm(xt, torch.cat(parts[:2], 1))
    dwu = torch.bmm(xt, torch.cat(parts[2:], 1))
    dwd = torch.bmm(h.transpose(1, 2), dyf)
    return tuple(t.to(dt) for t in (dx, dwg, dwu, dwd))


def moe_gemm_grad_f64(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor, counts: torch.Tensor, dy: torch.Tensor):
    """The gradient of the expert GEMM at the same (bf16 or fp32) values
    for the cotangent dy, in fp64 with h unrounded: (dx, dw_gate, dw_up,
    dw_down) in fp64."""
    x, wg, wu, wd = (t.detach().double().requires_grad_() for t in (x, w_gate, w_up, w_down))
    with torch.enable_grad():
        g, u = torch.bmm(x, wg), torch.bmm(x, wu)
        y = torch.bmm(F.silu(g) * u, wd)
        live = torch.arange(x.shape[1], device=x.device)[None, :] < counts[:, None]
        return torch.autograd.grad(torch.where(live[..., None], y, 0.0), (x, wg, wu, wd),
                                   dy.double())
