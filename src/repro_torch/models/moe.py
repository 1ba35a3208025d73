"""Top-k Mixture-of-Experts with sort-based dispatch (`repro.models.moe`).

No (T, E, C) one-hot dispatch tensor is made: the token picks are sorted
by expert id (a stable sort, as ``jnp.argsort``, so an expert keeps the
same tokens as in the JAX package), scattered into a capacity-bounded
(E, C, d) buffer, run through the grouped expert GEMM
(`kernels.moe_gemm`: the hand-written CUDA kernel on the card, its plain
version on the CPU), and gathered back weighted by the router's gates.
Picks over an expert's capacity are dropped (GShard).  Where the JAX
package runs the expert GEMMs as three einsums, the port runs the
`moe_gemm` kernel, which computes the same function and keeps g and u in
fp32 where the JAX model rounds them to the working dtype first.

One dispatch takes all the tokens of a call (the JAX ``gspmd`` mode; its
``local`` mode needs a data-parallel mesh).  Nothing here syncs with the
host: the counts stay on the device, scatters take a clipped slot and a
source zeroed by ``keep`` instead of a boolean mask, and the combine adds
each token's k contributions in a fixed order (ascending expert id, the
order the JAX scatter-add sees them) in the working dtype, where an
atomic ``index_add_`` would sum bf16 in an order that varies by run.

The router's load-balancing loss is computed on every call, as in the JAX
package, and the LM discards it outside ``forward``.  Instruments read
the routing through `observe` (a callback on every dispatch).

Training differentiates all of it: on the card the expert GEMM through
`MoeGemm` (the kernel's forward, the plain version's gradient), the
dispatch's scatter and the combine's gather through autograd.  Their
backwards are deterministic on the card: the combine's gather becomes an
atomic add over the (E * C) slots, but each slot takes one kept pick's
gradient plus zeros from dropped picks (their gate weight is 0), so the
order of the adds does not change the sum.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, List, Tuple

import torch

from ..kernels.moe_gemm.ops import moe_gemm
from .config import ModelConfig
from .params import ParamSpec

F32 = torch.float32


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "w_router": ParamSpec((d, E), ("embed", None), dtype="float32"),
        "w_gate": ParamSpec((E, d, f), ("experts", "embed", "ff"), dtype=cfg.dtype),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "ff"), dtype=cfg.dtype),
        "w_down": ParamSpec((E, f, d), ("experts", "ff", "embed"), dtype=cfg.dtype),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a dispatch of ``n_tokens`` tokens."""
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cfg.top_k, min(c, n_tokens))


@dataclasses.dataclass
class Dispatch:
    """The routing of T tokens.  Per token, its k picks in ascending expert
    id: ``expert_ids`` (T, k), ``gates`` (T, k) fp32 (renormalised over the
    top k), ``keep`` (T, k) (False where the expert's capacity was full)
    and ``slot`` (T, k) (row of the flattened (E * C) buffer; clipped to
    the expert's last row where dropped).  ``counts`` (E,) int32 counts
    every pick, dropped ones too; ``grouped`` is the (E, C, d) buffer;
    ``aux`` the load-balancing loss (fp32 scalar)."""
    expert_ids: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    grouped: torch.Tensor
    aux: torch.Tensor


_observers: List[Callable] = []


@contextlib.contextmanager
def observe(fn: Callable) -> Iterator[None]:
    """Within the block, every `moe` call also calls ``fn(p, xt, dispatch)``
    with its parameters, its (T, d) tokens and their `Dispatch`, before the
    expert GEMM.  For instruments (routing, drop shares); ``fn`` must not
    change what it is given."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router's picks: (probabilities, expert ids), each (T, k), the
    first k of a stable descending sort, so that among equal probabilities
    the lower expert id wins, as in lax.top_k (torch.topk makes no
    promise).  `dispatch` looks it up at each call, so an instrument can
    record the picks or route the same tokens as another run did."""
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gates[:, :k], ids[:, :k]


def dispatch(p, cfg: ModelConfig, xt: torch.Tensor) -> Dispatch:
    """Route the tokens xt (T, d) and fill the capacity buffer."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    dev = xt.device

    logits = xt.to(F32) @ p.w_router.to(F32)                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = top_k(probs, k)                                 # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)  # renorm

    # Switch/GShard load-balancing loss
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=F32, device=dev).index_add_(
        0, ids.reshape(-1), torch.full((T * k,), 1.0 / (T * k), device=dev))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # a token's picks in ascending expert id: the stable sort below sees
    # one pick per (token, expert), so it orders each expert's picks by
    # token either way, and the combine adds in this order
    ids, by_id = ids.sort(dim=-1)
    gates = gates.gather(-1, by_id)

    flat = ids.reshape(T * k)
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    counts = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
        0, sorted_ids, torch.ones(T * k, dtype=torch.int32, device=dev))
    offsets = torch.cumsum(counts, 0) - counts                  # exclusive
    pos = torch.arange(T * k, device=dev) - offsets[sorted_ids]
    keep_s = pos < C
    slot_s = sorted_ids * C + pos.clamp(0, C - 1)

    # a dropped pick adds zeros to its clipped slot, so every slot sums one
    # value at most, in any order
    src = xt[order // k] * keep_s[:, None].to(xt.dtype)
    buf = torch.zeros((E * C, d), dtype=xt.dtype, device=dev).index_add_(0, slot_s, src)

    keep = torch.empty_like(keep_s)
    keep[order] = keep_s
    slot = torch.empty_like(slot_s)
    slot[order] = slot_s
    return Dispatch(expert_ids=ids, gates=gates, keep=keep.view(T, k),
                    slot=slot.view(T, k), counts=counts,
                    grouped=buf.view(E, C, d), aux=aux)


def combine(y: torch.Tensor, disp: Dispatch) -> torch.Tensor:
    """Gather each token's k expert outputs from y (E, C, d), weight them by
    their gates (dropped picks by 0) in the working dtype, and add them in
    ascending expert id.  Returns (T, d)."""
    T, k = disp.slot.shape
    d = y.shape[-1]
    picked = y.reshape(-1, d).index_select(0, disp.slot.reshape(-1)).view(T, k, d)
    w = (disp.gates * disp.keep).to(y.dtype)
    picked.mul_(w[..., None])
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    return out


def moe(p, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss).  All B * S tokens go
    through one dispatch."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    disp = dispatch(p, cfg, xt)
    for fn in _observers:
        fn(p, xt, disp)
    y = moe_gemm(disp.grouped, p.w_gate, p.w_up, p.w_down, disp.counts)
    return combine(y, disp).reshape(B, S, d), disp.aux
