"""RG-LRU recurrent block (`repro.models.rglru`; Griffin / RecurrentGemma,
arXiv:2402.19427).

The full-sequence path runs the gated linear recurrence h_t = a_t h_{t-1}
+ b_t as a scan over the sequence in fp32 (`rglru_scan`), the decode path
as an O(1) state update.  The JAX package scans with
`jax.lax.associative_scan`; here the same associative operator runs as a
Hillis-Steele doubling scan: ceil(log2 S) steps, each a few elementwise
kernels over the whole (B, S, d_rnn) tensor, so a prefill of 2,048
positions takes 11 steps where a loop over positions would take 2,048.
The two sum in different orders, within fp32 rounding of each other.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..train.sharding import constrain
from .config import ModelConfig
from .params import ParamSpec
from .spmd import along_sequence, pad

F32 = torch.float32
_C = 8.0
GATE = ("act_batch", "act_seq", "act_ff")  # Griffin's fixed recurrence sharpness constant


def rglru_specs(cfg: ModelConfig) -> dict:
    d, dr = cfg.d_model, cfg.d_rnn
    return {
        "w_x": ParamSpec((d, dr), ("embed", "rnn"), dtype=cfg.dtype),
        "w_y": ParamSpec((d, dr), ("embed", "rnn"), dtype=cfg.dtype),
        "conv_w": ParamSpec((cfg.conv_width, dr), (None, "rnn"), dtype=cfg.dtype),
        "conv_b": ParamSpec((dr,), ("rnn",), init="zeros", dtype=cfg.dtype),
        "w_a": ParamSpec((dr, dr), ("rnn", None), dtype=cfg.dtype),
        "b_a": ParamSpec((dr,), (None,), init="zeros", dtype="float32"),
        "w_i": ParamSpec((dr, dr), ("rnn", None), dtype=cfg.dtype),
        "b_i": ParamSpec((dr,), (None,), init="zeros", dtype="float32"),
        "lam": ParamSpec((dr,), ("rnn",), init="ones", dtype="float32"),
        "w_o": ParamSpec((dr, d), ("rnn", "embed"), dtype=cfg.dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along the sequence: x (B, S, dr), w
    (W, dr), b (dr,)."""
    W, S = w.shape[0], x.shape[1]
    xp = pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _gates(p, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's fp32 decay a and input b for the conv output u."""
    # the products' partial sums reduced onto the channels (under a plan)
    r = torch.sigmoid(constrain(u @ p.w_a, GATE).float() + p.b_a)
    i = torch.sigmoid(constrain(u @ p.w_i, GATE).float() + p.b_i)
    log_a = -_C * F.softplus(p.lam) * r                  # (B, S, dr) <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0))
    return a, beta * i * u.float()


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for fp32 a and
    b of one shape (B, S, ...): every h_t.  Step d combines each position
    with the one d before it, (a1, b1) then (a2, b2) giving (a1 a2, a2 b1
    + b2), the operator `jax.lax.associative_scan` is given."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(p, cfg: ModelConfig, x: torch.Tensor, return_cache: bool = False):
    """Full-sequence recurrent mixer.  x (B, S, d) -> (B, S, d).

    ``return_cache=True`` also returns the decode state the sequence
    leaves: the last h (B, d_rnn) in fp32 and the conv tail (B, W - 1,
    d_rnn), the last W - 1 rows of ``x @ w_x`` before the convolution
    (zero rows in front of a shorter sequence), which is what
    `rglru_decode_step` keeps."""
    ux = x @ p.w_x
    u = _causal_conv(ux, p.conv_w, p.conv_b)
    y = F.gelu((x @ p.w_y).float(), approximate="tanh")
    a, b = _gates(p, u)
    h = along_sequence(rglru_scan, a, b)
    out = (h * y).to(x.dtype) @ p.w_o
    if not return_cache:
        return out
    W = p.conv_w.shape[0]
    conv = pad(ux, (0, 0, W - 1, 0))[:, ux.shape[1]:]
    return out, h[:, -1], conv


def rglru_decode_step(p, cfg: ModelConfig, x: torch.Tensor, h_state: torch.Tensor,
                      conv_state: torch.Tensor):
    """x (B, 1, d); h_state (B, d_rnn) fp32; conv_state (B, W - 1, d_rnn).
    Returns (out (B, 1, d), new h, new conv state)."""
    u_t = (x @ p.w_x)[:, 0]                               # (B, dr)
    hist = torch.cat([conv_state, u_t[:, None]], dim=1)
    u = ((hist * p.conv_w[None]).sum(dim=1) + p.conv_b)[:, None]
    y = F.gelu((x @ p.w_y).float(), approximate="tanh")[:, 0]
    a, b = _gates(p, u)
    h = a[:, 0] * h_state + b[:, 0]                       # (B, dr)
    out = (h * y).to(x.dtype)[:, None]                    # (B, 1, dr)
    return out @ p.w_o, h, hist[:, 1:]
