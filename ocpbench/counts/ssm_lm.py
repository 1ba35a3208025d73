"""Operation and byte counts of the attention-free Mamba-2 language model,
frozen here (copied from the port's smoke script, not imported).

`ssd_scan_call` is one chunked scan's need: per chunk of q steps the
intra-chunk products over the causal pairs (C B^T against the N state
lanes and the P head lanes), and the chunk's state in and out (2 q N P
each way); x, B and C read once in the configuration's dtype, dt, A read
once in fp32, y and the final state written once in fp32.
`train_step_flops` is the model's own work in one step: 6 x the
parameters x the tokens (the tied head counted once, as a parameter of
the embedding) and the SSD's products at the chunk the model states,
with no recompute.

``m`` is a configuration's ``model`` block; the card's peaks are
`moe_lm.peaks`'.
"""
from __future__ import annotations

from typing import Dict, Tuple


def _elem(m: Dict) -> int:
    return {"bfloat16": 2, "float32": 4}[m.get("dtype", "bfloat16")]


def widths(m: Dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state size)."""
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"]


def ssd_scan_call(m: Dict, B: int, S: int):
    """One scan over (B, S) tokens at the model's chunk: (FLOPs, bytes)."""
    _, H, P, N = widths(m)
    Q = min(m["ssm_chunk"], S)
    qs = [min(Q, S - c) for c in range(0, S, Q)]
    flops = B * H * sum(2 * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P) for q in qs)
    nbytes = (_elem(m) * (B * S * H * P + 2 * B * S * N) + 4 * B * S * H * P
              + 4 * B * S * H + 4 * H + 4 * B * H * P * N)
    return flops, nbytes


def params(m: Dict) -> int:
    """Every parameter: the embedding (the tied head), the norms, and each
    layer's projections, conv, A, dt bias, D and gated norm."""
    L, d, V, W = m["n_layers"], m["d_model"], m["vocab"], m["conv_width"]
    di, H, _, N = widths(m)
    conv = di + 2 * N
    layer = d + d * di + d * conv + d * H + W * conv + conv + 3 * H + di + di * d
    head = 0 if m["tie_embeddings"] else d * V
    return V * d + d + L * layer + head


def train_step_flops(m: Dict, B: int, S: int) -> int:
    """One training step over B sequences of S tokens."""
    _, H, P, N = widths(m)
    Q = min(m["ssm_chunk"], S)
    ssd = 6 * m["n_layers"] * B * (S * (Q + 1) // 2 * (N + H * P) + 2 * S * H * P * N)
    return 6 * params(m) * B * S + ssd
