"""Operation and byte counts of the MoE language model, frozen here.

Each kernel call's count is what its inputs need: every input byte read
once and every output byte written once, whatever the kernel reads again,
and work that depends on the data (the expert GEMM's live rows and the
experts it touches) as the call's own counts give it.  The whole step's
count (`train_step_flops`, `prefill_flops`, `decode_step_cost`) is the
model's own work from the configuration's shapes, whichever kernels do
it: the top k experts of each token and no capacity padding, no
recompute, the logits only where the path computes them, and for a
decode step the bytes of every weight it reads (the experts touched
alone), of the cache read once and of the new keys and values.

``m`` is a configuration's ``model`` block.  The bf16 peak and the memory
rate are NVIDIA's data sheet's for the H100 SXM (dense, without sparsity).
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence


def peaks(device_name: str) -> Dict[str, float]:
    """{"flops": bf16 FLOP/s, "bytes": HBM bytes/s} of the H100 SXM by its
    name; any other card is refused."""
    if "H100" not in device_name or "PCIe" in device_name or "NVL" in device_name:
        raise ValueError(f"no peaks for {device_name!r}: the benchmark runs on the H100 SXM")
    return {"flops": 989e12, "bytes": 3.35e12}


def least_s(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    """The least time the card takes: its operations or its bytes."""
    return max(flops / pk["flops"], nbytes / pk["bytes"])


def bound_by(flops: float, nbytes: float, pk: Dict[str, float]) -> str:
    return "operations" if flops / pk["flops"] >= nbytes / pk["bytes"] else "bytes"


def _hd(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def _elem(m: Dict) -> int:
    return {"bfloat16": 2, "float32": 4}[m.get("dtype", "bfloat16")]


def attention_weights(m: Dict) -> int:
    """A layer's q, k, v and o projections' parameters."""
    d, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], _hd(m)
    return 2 * d * H * hd + 2 * d * K * hd


def expert_weights(m: Dict) -> int:
    """One SwiGLU expert's parameters (the dense residual MLP's alike)."""
    return 3 * m["d_model"] * m["d_ff"]


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


# ------------------------------------------------------------- kernels ----

def flash_attention_call(m: Dict, B: int, S: int):
    """One causal self-attention call over (B, S) tokens: (FLOPs, bytes).
    QK^T and PV over the pairs at or below the diagonal; q, k, v read and
    the output written once."""
    H, K, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    flops = 4 * B * H * hd * causal_pairs(S)
    nbytes = _elem(m) * (2 * B * S * H * hd + 2 * B * S * K * hd)
    return flops, nbytes


def flash_decode_call(m: Dict, B: int, lens: Sequence[int]):
    """One decode attention call of B queries against their caches of
    ``lens`` positions: (FLOPs, bytes).  The live keys and values read
    once, q read and the output written, the lengths read."""
    H, K, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    live = sum(lens)
    flops = 4 * H * hd * live
    nbytes = _elem(m) * (2 * live * K * hd + 2 * B * H * hd) + 4 * B
    return flops, nbytes


def moe_gemm_call(m: Dict, C: int, counts: Iterable[int]):
    """One grouped expert GEMM over an (E, C, d) buffer with ``counts``
    picks an expert: (FLOPs, bytes).  The live rows' three products; the
    live rows read, the whole (E, C, d) output written, the weights of the
    experts with a pick read, the counts read."""
    counts = list(counts)
    E, d, f = len(counts), m["d_model"], m["d_ff"]
    rows = sum(min(int(c), C) for c in counts)
    active = sum(1 for c in counts if c > 0)
    flops = 6 * d * f * rows
    nbytes = _elem(m) * (rows * d + E * C * d + active * expert_weights(m)) + 4 * E
    return flops, nbytes


# ---------------------------------------------------------- whole steps ----

def _token_flops(m: Dict) -> int:
    """A token's products in one layer, attention's scores aside: the
    projections, the router, its k experts and the dense residual MLP."""
    per = attention_weights(m) + m["d_model"] * m["n_experts"]
    per += m["top_k"] * expert_weights(m)
    if m.get("moe_dense_residual"):
        per += expert_weights(m)
    return 2 * per


def train_step_flops(m: Dict, B: int, S: int) -> int:
    """One training step over B sequences of S tokens: the forward's
    products and twice them in the backward (no recompute), the head over
    every position."""
    L, H, hd = m["n_layers"], m["n_heads"], _hd(m)
    fwd = L * B * S * _token_flops(m) + 2 * B * S * m["d_model"] * m["vocab"]
    fwd += L * 4 * B * H * hd * causal_pairs(S)
    return 3 * fwd


def prefill_flops(m: Dict, B: int, S: int) -> int:
    """One prefill of B prompts of S tokens, the head at the last position."""
    L, H, hd = m["n_layers"], m["n_heads"], _hd(m)
    return (L * B * S * _token_flops(m) + L * 4 * B * H * hd * causal_pairs(S)
            + 2 * B * m["d_model"] * m["vocab"])


def decode_step_cost(m: Dict, B: int, lens: Sequence[int], touched: Sequence[int]):
    """One decode step of B tokens whose caches hold ``lens`` positions
    after the step's own, the experts with a pick in each layer
    ``touched``: (FLOPs, bytes).  The bytes: every attention and dense MLP
    weight, the routers (fp32), the norms (fp32), the head, the embedding
    rows looked up, the touched experts, each layer's live cache read once
    and its new keys and values written."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    H, K, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    live = sum(lens)
    flops = L * B * _token_flops(m) + L * 4 * H * hd * live + 2 * B * d * V
    weights = L * attention_weights(m) + d * V + B * d
    if m.get("moe_dense_residual"):
        weights += L * expert_weights(m)
    weights += sum(touched) * expert_weights(m)
    cache = L * (2 * live * K * hd + 2 * B * K * hd)
    nbytes = _elem(m) * (weights + cache) + 4 * (L * d * m["n_experts"] + (2 * L + 1) * d)
    return flops, nbytes
