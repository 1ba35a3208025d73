"""Mamba-2 mixer (`repro.models.ssm`), with the reference's casts.

A whole sequence goes through the chunked SSD scan
(`kernels.ssd_scan`: the CUDA kernel for tensors on the card, the plain
version on the CPU); decode is the O(1) recurrent state update.  The
mixer is cut in three so a caller can hold the scan to account on the
same inputs: `ssm_inputs` (projections and the causal conv), the scan, and
`ssm_output` (skip, gate, norm and out-projection).

x, B and C are slices of one projection and go to the scan as strided
views, without a copy.  `ssm_block` can also return what decode needs next:
the final state and the conv tail, so a prefill builds its cache from the
forward pass.  `ssm_decode_step` updates the cache in place.

Spans (`obs.trace.span`): `ssm_block` enters ``ssm.inputs``, ``ssm.scan``
and ``ssm.output`` once a call, around its three parts; `ssm_decode_step`
enters ``ssm.decode`` once a call.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..obs.trace import span
from .config import ModelConfig
from .layers import rms_norm
from ..train.sharding import constrain
from .params import ParamSpec
from .spmd import pad, ssd_scan, state_readout

F32 = torch.float32


def ssm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    dconv = di + 2 * N
    return {
        "w_z": ParamSpec((d, di), ("embed", "inner"), dtype=cfg.dtype),
        "w_xBC": ParamSpec((d, dconv), ("embed", "inner"), dtype=cfg.dtype),
        "w_dt": ParamSpec((d, H), ("embed", None), dtype=cfg.dtype),
        "conv_w": ParamSpec((cfg.conv_width, dconv), (None, "inner"),
                            dtype=cfg.dtype),
        "conv_b": ParamSpec((dconv,), ("inner",), init="zeros",
                            dtype=cfg.dtype),
        "A_log": ParamSpec((H,), (None,), init="zeros", dtype="float32"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros", dtype="float32"),
        "D": ParamSpec((H,), (None,), init="ones", dtype="float32"),
        "norm": ParamSpec((di,), ("inner",), init="ones", dtype="float32"),
        "w_out": ParamSpec((di, d), ("inner", "embed"), dtype=cfg.dtype),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (B, S, C), w (W, C), b (C,)."""
    W, S = w.shape[0], x.shape[1]
    xp = pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def ssm_inputs(p, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, d) -> (z, xBC before the conv, and the scan's inputs xs
    (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, B and C (B, S, N))."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    z = x @ p.w_z                                          # (B, S, di)
    xbc = x @ p.w_xBC                                      # (B, S, di + 2N)
    conv = F.silu(causal_conv(xbc, p.conv_w, p.conv_b).float()).to(x.dtype)
    xs = conv[..., :di].unflatten(-1, (H, P))
    Bm = conv[..., di:di + N]
    Cm = conv[..., di + N:]
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias)
    A = -torch.exp(p.A_log)                                # (H,) < 0
    return z, xbc, xs, dt, A, Bm, Cm


def ssm_output(p, cfg: ModelConfig, z: torch.Tensor, xs: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """The scan's y (B, S, H, P) fp32 -> the mixer's output (B, S, d)."""
    Bsz, S = y.shape[:2]
    y = y + p.D[:, None] * xs.float()
    y = y.reshape(Bsz, S, cfg.d_inner).to(z.dtype)
    # the norm's width whole on each device (under a plan)
    y = constrain(y * F.silu(z.float()).to(z.dtype), ("act_batch", "act_seq", None))
    y = rms_norm(y, p.norm, cfg.norm_eps)
    return y @ p.w_out


def conv_tail(xbc: torch.Tensor, conv_width: int) -> torch.Tensor:
    """The last ``conv_width - 1`` rows of xBC before the conv, left-padded
    with zeros for a shorter sequence: what `ssm_decode_step` leaves in the
    conv cache after stepping through the same tokens."""
    keep = conv_width - 1
    tail = xbc[:, max(xbc.shape[1] - keep, 0):]
    return pad(tail, (0, 0, keep - tail.shape[1], 0))


def ssm_block(p, cfg: ModelConfig, x: torch.Tensor, *, return_cache: bool = False):
    """Full-sequence Mamba-2 mixer.  x (B, S, d) -> (B, S, d); with
    ``return_cache`` also the final state (B, H, P, N) fp32 and the conv
    tail (B, conv_width - 1, d_inner + 2N)."""
    with span("ssm.inputs"):
        z, xbc, xs, dt, A, Bm, Cm = ssm_inputs(p, cfg, x)
    with span("ssm.scan"):
        y, state = ssd_scan(xs, dt, A, Bm, Cm,
                            chunk=min(cfg.ssm_chunk, x.shape[1]))
    with span("ssm.output"):
        out = ssm_output(p, cfg, z, xs, y)
    if not return_cache:
        return out
    return out, state, conv_tail(xbc, cfg.conv_width)


def ssm_decode_step(p, cfg: ModelConfig, x: torch.Tensor, state: torch.Tensor,
                    conv_state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) recurrent decode.  x (B, 1, d); state (B, H, P, N) fp32;
    conv_state (B, conv_width - 1, d_inner + 2N).  Returns (y, state,
    conv_state), the two caches updated IN PLACE (the JAX reference returns
    new arrays; here no step copies the cache)."""
    with span("ssm.decode"):
        Bsz = x.shape[0]
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        di = cfg.d_inner
        z = x @ p.w_z
        xbc_t = (x @ p.w_xBC)[:, 0]                            # (B, d_conv)
        hist = torch.cat([conv_state, xbc_t[:, None]], dim=1)
        conv = (hist * p.conv_w[None]).sum(dim=1) + p.conv_b
        conv = F.silu(conv.float()).to(x.dtype)                # (B, d_conv)
        xs = conv[:, :di].reshape(Bsz, H, P).float()
        Bv = conv[:, di:di + N].float()
        Cv = conv[:, di + N:].float()
        dt = F.softplus((x[:, 0] @ p.w_dt).float() + p.dt_bias)
        A = -torch.exp(p.A_log)
        decay = torch.exp(dt * A)                              # (B, H)
        state.mul_(decay[..., None, None]).add_(
            (dt[..., None] * xs)[..., None] * Bv[:, None, None, :])
        y = state_readout(state, Cv)                           # (B, H, P)
        y = y + p.D[:, None] * xs
        y = y.reshape(Bsz, 1, di).to(x.dtype)
        y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.norm, cfg.norm_eps)
        conv_state.copy_(hist[:, 1:])
        return y @ p.w_out, state, conv_state
