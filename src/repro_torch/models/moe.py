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

On plain tensors one dispatch takes all the tokens of a call, whatever
``moe_dispatch``: the JAX ``local`` mode falls back to its one global
dispatch too where no plan shards the batch.

On DTensors (a sharded step under a plan, `models.spmd`) the dispatch and
the combine run per device on its own tokens and the expert GEMM per
device on its own experts, with the layouts of expert parallelism in
between.  In the ``gspmd`` mode each device's tokens (split further over
the mesh dims that shard the experts, where they divide) fill a buffer
that an all-to-all hands to the experts' devices and another brings back;
the capacity is then a device's (``capacity(cfg, T_device)``), where
GSPMD's global capacity would need a prefix sum across devices, and the
load-balancing loss is the global one, from the devices' router
statistics averaged.  ``moe_dispatch="local"`` is the JAX ``_moe_local``:
the tokens stay where the batch's data-parallel sharding puts them, each
data-parallel group dispatches its own (T/dp) tokens into its own buffer
of capacity ``capacity(cfg, T/dp)``, that buffer is sliced by expert on
each device of the group (no all-to-all) and the outputs are gathered
back; the loss is the mean of the groups'.  The GEMM runs every row of
those buffers (their rows past a count are zeros, which give zeros).

Nothing here syncs with the
host: the counts stay on the device, scatters take a clipped slot and a
source zeroed by ``keep`` instead of a boolean mask, and the combine adds
each token's k contributions in a fixed order (ascending expert id, the
order the JAX scatter-add sees them) in the working dtype, where an
atomic ``index_add_`` would sum bf16 in an order that varies by run.

The router's load-balancing loss is computed on every call, as in the JAX
package, and the LM discards it outside ``forward``.  Instruments read
the routing through `observe` (a callback on every dispatch) and, under
a profiler, the spans (`obs.trace.span`) that each call enters once on
either path: ``moe.route`` (router, softmax, top-k, the loss),
``moe.dispatch`` (the sort, the counts, the buffer's scatter),
``moe.experts`` (the expert GEMM) and ``moe.combine``.

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
from types import SimpleNamespace
from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from ..kernels.moe_gemm.ops import moe_gemm
from ..obs.trace import span
from ..train.sharding import relayout
from .config import ModelConfig
from .params import ParamSpec
from .spmd import is_dtensor, kernel_call, layout, run_local, shard_dims

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
    ``aux`` the load-balancing loss (fp32 scalar), ``router_aux_coef * E``
    times the sum of ``me * ce``: each expert's mean router probability
    and its share of the picks, (E,) fp32 each."""
    expert_ids: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    grouped: torch.Tensor
    aux: torch.Tensor
    me: torch.Tensor
    ce: torch.Tensor


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

    with span("moe.route"):
        logits = xt.to(F32) @ p.w_router.to(F32)                     # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gates, ids = top_k(probs, k)                                 # (T, k)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)  # renorm

        # Switch/GShard load-balancing loss
        me = probs.mean(dim=0)
        ce = torch.zeros(E, dtype=F32, device=dev).index_add_(
            0, ids.reshape(-1), torch.full((T * k,), 1.0 / (T * k), device=dev))
        aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    with span("moe.dispatch"):
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

        # a dropped pick adds zeros to its clipped slot, so every slot sums
        # one value at most, in any order
        src = xt[order // k] * keep_s[:, None].to(xt.dtype)
        buf = torch.zeros((E * C, d), dtype=xt.dtype, device=dev).index_add_(0, slot_s, src)

        keep = torch.empty_like(keep_s)
        keep[order] = keep_s
        slot = torch.empty_like(slot_s)
        slot[order] = slot_s
    return Dispatch(expert_ids=ids, gates=gates, keep=keep.view(T, k),
                    slot=slot.view(T, k), counts=counts,
                    grouped=buf.view(E, C, d), aux=aux, me=me, ce=ce)


def combine(y: torch.Tensor, disp: Dispatch) -> torch.Tensor:
    """Gather each token's k expert outputs from y (E, C, d), weight them by
    their gates (dropped picks by 0) in the working dtype, and add them in
    ascending expert id.  Returns (T, d)."""
    T, k = disp.slot.shape
    d = y.shape[-1]
    with span("moe.combine"):
        picked = y.reshape(-1, d).index_select(0, disp.slot.reshape(-1)).view(T, k, d)
        w = (disp.gates * disp.keep).to(y.dtype)
        picked.mul_(w[..., None])
        out = picked[:, 0]
        for j in range(1, k):
            out = out + picked[:, j]
    return out


def _moe_tokens(p, cfg: ModelConfig, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dispatch of the tokens xt (T, d): (out (T, d), aux)."""
    disp = dispatch(p, cfg, xt)
    for fn in _observers:
        fn(p, xt, disp)
    with span("moe.experts"):
        y = moe_gemm(disp.grouped, p.w_gate, p.w_up, p.w_down, disp.counts)
    return combine(y, disp), disp.aux


def moe(p, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss).  All B * S tokens go
    through one dispatch; on DTensors one a device (``gspmd``) or a
    data-parallel group (``local``)."""
    B, S, d = x.shape
    if is_dtensor(x):
        return _moe_sharded(p, cfg, x)
    out, aux = _moe_tokens(p, cfg, x.reshape(B * S, d))
    return out.reshape(B, S, d), aux


def _moe_sharded(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe` on DTensors: dispatch and combine per device, the expert GEMM
    per device on its experts, and the all-to-alls of expert parallelism
    between them (see the module's docstring)."""
    mesh = x.device_mesh
    d, E = x.shape[-1], cfg.n_experts
    tok = {i: 0 for i in shard_dims(x, 0)}
    tok.update({i: 1 for i in shard_dims(x, 1)})
    ep = shard_dims(p.w_gate, 0)
    if cfg.moe_dispatch != "local":  # split the tokens over the expert dims too
        for i in ep:
            if i in tok:
                continue
            n_b = x.shape[0] // int(np.prod([mesh.size(j) for j, t in tok.items() if t == 0]))
            n_s = x.shape[1] // int(np.prod([mesh.size(j) for j, t in tok.items() if t == 1]))
            if n_b % mesh.size(i) == 0:
                tok[i] = 0
            elif n_s % mesh.size(i) == 0:
                tok[i] = 1
    xpl = layout(mesh.ndim, tok)
    bpl = layout(mesh.ndim, {i: 1 for i in tok})      # the buffer: tokens' slots
    gpl = layout(mesh.ndim, {**{i: 1 for i in tok}, **{i: 0 for i in ep}})
    wpl = layout(mesh.ndim, {i: 0 for i in ep})
    state = {}

    def route(xl, w_router):
        xt = xl.reshape(-1, d)
        disp = dispatch(SimpleNamespace(w_router=w_router), cfg, xt)
        for fn in _observers:
            fn(p, xt, disp)
        state.update(disp=disp, shape=xl.shape)
        return disp.grouped, disp.aux.reshape(1), disp.me[None], disp.ce[None]

    per_device = layout(mesh.ndim, {i: 0 for i in tok})
    grouped, aux, me, ce = run_local(route, (x, p.w_router), (xpl, layout(mesh.ndim, {})),
                                     (bpl, per_device, per_device, per_device), mesh)
    if cfg.moe_dispatch != "local":  # the loss over all the tokens, as one dispatch's
        aux = cfg.router_aux_coef * E * torch.sum(me.mean(0) * ce.mean(0))

    def experts(g, wg, wu, wd):
        full = torch.full((g.shape[0],), g.shape[1], dtype=torch.int32, device=g.device)
        E_l, C, dl = g.shape
        with span("moe.experts"):
            return kernel_call(moe_gemm, (g, wg, wu, wd, full), [(g.shape, g.dtype)],
                               6.0 * E_l * C * dl * wg.shape[-1])

    y = run_local(experts, (grouped, p.w_gate, p.w_up, p.w_down),
                  (gpl, wpl, wpl, wpl), gpl, mesh)
    out = run_local(lambda yl: combine(yl, state["disp"]).reshape(state["shape"]),
                    (y,), (bpl,), xpl, mesh)
    # back to the tokens' own layout, the gradient too
    return relayout(out, mesh, tuple(x.placements)), aux.mean()

