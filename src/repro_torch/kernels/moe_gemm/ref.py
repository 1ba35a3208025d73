"""Plain PyTorch grouped SwiGLU expert GEMM, on any device.

The port's twin of `repro.kernels.moe_gemm.ref.moe_gemm_ref`: g and u in
fp32 from fp32-cast operands, h = silu(g) u rounded to the working dtype,
y = h Wd in fp32, rows at or past ``counts[e]`` set to 0, the result cast
to the working dtype.  ``kernel.cu`` computes the same function.
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
