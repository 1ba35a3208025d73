"""Plain reference of the decoder-only MoE language model, in fp32.

The model the configurations under ``configs/`` state, written from its
equations with plain torch operations: token embedding; per layer an RMS
norm, grouped-query causal attention with rotary positions (the two
halves of a head rotated against each other), a residual; an RMS norm, a
top-k mixture of SwiGLU experts with capacity dispatch (plus a dense SwiGLU
MLP on the same input where ``moe_dense_residual``), a residual; a final
RMS norm and the head (the embedding's transpose where tied).

The routing is GShard's: a softmax over the router's fp32 logits, the k
most probable experts (the lower id first among equal probabilities),
their gates renormalised over the k, and each expert's capacity of
``max(k, min(int(capacity_factor * k * T / E), T))`` slots for a dispatch
of T tokens; an expert keeps its picks in the order of the dispatch's
tokens and drops the rest.  A dispatch is one call of the layer: all the
tokens of a training microbatch, of a prompt batch, or of one decode step
of a batch.  The load-balancing loss of a dispatch is ``router_aux_coef *
E * sum(mean probability * share of the picks)`` over the experts, summed
over the layers.

Weights may be given in bf16 (as served): each is taken to fp32 where it
is used.  With ``precision="fp8"`` every product with a weight runs on
operands rounded to float8 e4m3 under a per-tensor scale (the gradients
of training to e5m2), accumulated in fp32: the control that a lower
precision than the configuration's has to fail.  The router and the
attention's scores stay in fp32.

Nothing here imports the program; matrix products never use TF32
(`no_tf32`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ------------------------------------------------------------ precision ----

def fp8_round(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """t rounded to ``dtype`` under one scale for the tensor (its largest
    magnitude to the format's largest), back in fp32."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = amax / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(F32) * scale


class _Fp8Product(torch.autograd.Function):
    """x (n, a) @ w (a, b) on e4m3 operands; the backward's products on
    the e4m3 operands and the e5m2 gradient."""

    @staticmethod
    def forward(ctx, x, w):
        qx, qw = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = fp8_round(g, torch.float8_e5m2)
        return qg @ qw.T, qx.T @ qg


def product(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., a) @ w (a, b) in fp32, w taken to fp32 first."""
    w = w.to(F32)
    if precision == "fp32":
        return x @ w
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    lead = x.shape[:-1]
    return _Fp8Product.apply(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[-1])


# --------------------------------------------------------------- layers ----

def head_dim(c: Dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["n_heads"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, D), position s at index s."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, S, K, D), H = K * G: a plain softmax
    over each query's keys at or before it, one sequence at a time."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = []
    for b in range(B):
        s = torch.einsum("qkgd,skd->kgqs", q[b].reshape(S, K, G, D) * scale, k[b])
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("kgqs,skd->qkgd", p, v[b]).reshape(S, H, D))
    return torch.stack(out)


def attention(c: Dict, p: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    H, K, D = c["n_heads"], c["n_kv_heads"], head_dim(c)
    q = rotary(product(x, p["w_q"], precision).view(B, S, H, D), c["rope_theta"])
    k = rotary(product(x, p["w_k"], precision).view(B, S, K, D), c["rope_theta"])
    v = product(x, p["w_v"], precision).view(B, S, K, D)
    out = causal_attention(q, k, v, D ** -0.5)
    return product(out.reshape(B, S, H * D), p["w_o"], precision)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, precision: str) -> torch.Tensor:
    h = F.silu(product(x, w_gate, precision)) * product(x, w_up, precision)
    return product(h, w_down, precision)


def capacity(c: Dict, n_tokens: int) -> int:
    k = c["top_k"]
    return max(k, min(int(c["capacity_factor"] * k * n_tokens / c["n_experts"]), n_tokens))


def route(c: Dict, xt: torch.Tensor, w_router: torch.Tensor, sizes: Sequence[int]):
    """The dispatches of xt (T, d), consecutive groups of ``sizes`` tokens:
    (expert ids (T, k), gates (T, k), keep (T, k), load-balancing loss
    summed over the dispatches)."""
    T = xt.shape[0]
    E, k = c["n_experts"], c["top_k"]
    dev = xt.device
    probs = torch.softmax(xt @ w_router.to(F32), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    n_groups = len(sizes)
    group = torch.repeat_interleave(torch.arange(n_groups, device=dev),
                                    torch.tensor(list(sizes), device=dev))
    token = torch.arange(T, device=dev).repeat_interleave(k)
    key = group[token] * E + ids.reshape(-1)                    # (group, expert)
    order = torch.argsort(key * T + token)                      # by key, then token
    skey = key[order]
    seg = torch.bincount(skey, minlength=n_groups * E)
    start = torch.cumsum(seg, 0) - seg
    rank = torch.arange(T * k, device=dev) - start[skey]
    cap = torch.tensor([capacity(c, n) for n in sizes], device=dev)
    keep = torch.empty(T * k, dtype=torch.bool, device=dev)
    keep[order] = rank < cap[skey // E]

    n = torch.tensor(list(sizes), dtype=F32, device=dev)
    me = torch.zeros((n_groups, E), dtype=F32, device=dev).index_add(0, group, probs) / n[:, None]
    ce = seg.view(n_groups, E).to(F32) / (n[:, None] * k)
    aux = c["router_aux_coef"] * E * (me * ce).sum()
    return ids, gates, keep.view(T, k), aux


def moe(c: Dict, p: Dict, xt: torch.Tensor, sizes: Sequence[int], precision: str):
    """The expert layer over xt (T, d) in dispatches of ``sizes`` tokens:
    (out (T, d), load-balancing loss)."""
    ids, gates, keep, aux = route(c, xt, p["w_router"], sizes)
    tok, slot = keep.nonzero(as_tuple=True)
    expert = ids[tok, slot]
    by_expert = torch.argsort(expert, stable=True)
    tok, slot, expert = tok[by_expert], slot[by_expert], expert[by_expert]
    per = torch.bincount(expert, minlength=c["n_experts"]).tolist()
    out = torch.zeros_like(xt)
    lo = 0
    for e, n in enumerate(per):
        if n:
            t, j = tok[lo:lo + n], slot[lo:lo + n]
            y = swiglu(xt[t], p["w_gate"][e], p["w_up"][e], p["w_down"][e], precision)
            y = y * gates[t, j][:, None]
            out = out.index_add(0, t, y) if torch.is_grad_enabled() else out.index_add_(0, t, y)
        lo += n
    return out, aux


def dispatch_order(x: torch.Tensor, P: int) -> Tuple[torch.Tensor, List[int]]:
    """The tokens of x (B, S, d) in the program's dispatches: the first P
    positions of every sequence as one dispatch (sequence-major), then
    each later position's B tokens as a dispatch of its own."""
    B, S, d = x.shape
    tail = x[:, P:].transpose(0, 1).reshape(-1, d)
    return torch.cat([x[:, :P].reshape(B * P, d), tail]), [B * P] + [B] * (S - P)


def undo_order(y: torch.Tensor, B: int, S: int, P: int) -> torch.Tensor:
    d = y.shape[-1]
    head = y[:B * P].view(B, P, d)
    tail = y[B * P:].view(S - P, B, d).transpose(0, 1)
    return torch.cat([head, tail], dim=1)


def layer_params(params: Dict, i: int) -> Dict:
    """Layer i's slices of the stacked ``blocks`` leaves."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]

    return take(params["blocks"])


def block(c: Dict, p: Dict, x: torch.Tensor, P: int, precision: str, rows: int = 8):
    """One layer over x (B, S, d); returns (x, load-balancing loss).
    Without autograd x is updated in place, the attention ``rows``
    sequences and the dense MLP ``rows * S`` tokens at a time, so that a
    served model's reference fits beside its weights."""
    B, S, _ = x.shape
    eps = c["norm_eps"]
    dense = p.get("mlp") if c.get("moe_dense_residual") else None
    if torch.is_grad_enabled():
        x = x + attention(c, p["attn"], rms_norm(x, p["ln1"], eps), precision)
        ht, sizes = dispatch_order(rms_norm(x, p["ln2"], eps), P)
        y, aux = moe(c, p["moe"], ht, sizes, precision)
        if dense is not None:
            y = y + swiglu(ht, dense["w_gate"], dense["w_up"], dense["w_down"], precision)
        return x + undo_order(y, B, S, P), aux
    for b in range(0, B, rows):
        xb = x[b:b + rows]
        xb += attention(c, p["attn"], rms_norm(xb, p["ln1"], eps), precision)
    ht, sizes = dispatch_order(rms_norm(x, p["ln2"], eps), P)
    y, aux = moe(c, p["moe"], ht, sizes, precision)
    if dense is not None:
        n = rows * S
        for t in range(0, ht.shape[0], n):
            y[t:t + n] += swiglu(ht[t:t + n], dense["w_gate"], dense["w_up"], dense["w_down"],
                                 precision)
    del ht
    x += undo_order(y, B, S, P)
    return x, aux


def head_weight(c: Dict, params: Dict) -> torch.Tensor:
    return params["embed"].T if c["tie_embeddings"] else params["lm_head"]


def logits(c: Dict, params: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], c["norm_eps"])
    return product(h, head_weight(c, params), precision)


# ------------------------------------------------------------- serving ----

@torch.no_grad()
def served_logits(c: Dict, params: Dict, tokens: torch.Tensor, P: int,
                  precision: str = "fp32") -> torch.Tensor:
    """tokens (B, S): prompts of P tokens and the tokens served after
    them.  The logits (B, S - P + 1, V) at positions P - 1 .. S - 1 (those
    that chose each served token), the prompt as one dispatch and each
    later position as one, as the program's prefill and decode steps
    dispatch them."""
    with no_tf32():
        x = params["embed"][tokens.long()].to(F32)
        B, S, _ = x.shape
        for i in range(c["n_layers"]):
            x, _ = block(c, layer_params(params, i), x, P, precision)
        return logits(c, params, x[:, P - 1:], precision)


def token_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the best one, (B, G)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, served.long()[..., None])[..., 0]


# ------------------------------------------------------------ training ----

def _ce_rows(c: Dict, params: Dict, x: torch.Tensor, labels: torch.Tensor,
             precision: str) -> torch.Tensor:
    """The sum of -log p(label) over rows of x (n, d)."""
    lg = logits(c, params, x, precision)
    return (torch.logsumexp(lg, -1) - lg.gather(-1, labels[:, None])[:, 0]).sum()


def train_loss(c: Dict, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
               precision: str = "fp32", rows: int = 2048):
    """One microbatch: (cross-entropy + load-balancing loss, cross-entropy),
    every layer and every ``rows`` rows of the head recomputed in the
    backward (`checkpoint`) so that the fp32 model fits beside its
    optimizer state."""
    x = params["embed"][tokens.long()]
    B, S, d = x.shape
    aux = torch.zeros((), dtype=F32, device=x.device)
    for i in range(c["n_layers"]):
        x, a = checkpoint(lambda x, i=i: block(c, layer_params(params, i), x, S, precision),
                          x, use_reentrant=False)
        aux = aux + a
    flat, lab = x.reshape(B * S, d), labels.reshape(-1).long()
    ce = sum(checkpoint(_ce_rows, c, params, flat[r:r + rows], lab[r:r + rows], precision,
                        use_reentrant=False) for r in range(0, B * S, rows)) / (B * S)
    return ce + aux, ce


def tree_paths(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out += tree_paths(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def cosine_lr(hp: Dict, step: int) -> float:
    warm = min(step / max(hp["warmup_steps"], 1), 1.0)
    t = min(max((step - hp["warmup_steps"]) / max(hp["total_steps"] - hp["warmup_steps"], 1),
                0.0), 1.0)
    return hp["lr_peak"] * warm * 0.5 * (1 + math.cos(math.pi * t))


def train_steps(c: Dict, hp: Dict, params: Dict, batches, microbatches: int,
                precision: str = "fp32", keep_rows=None) -> Dict:
    """AdamW (fp32 moments, decoupled weight decay, the update clipped by
    the global norm) over ``batches``, each (tokens, labels) (B, S), the
    gradient the mean of its ``microbatches`` microbatches' (the loss a
    microbatch's mean).  ``params`` (fp32 leaves) is updated in place.
    ``keep_rows`` (a fault for the control's tests) trains on those rows
    of each batch alone.  Returns ``losses`` and ``grad_norms``: each
    leaf's norm of the first step's clipped gradient."""
    leaves = tree_paths(params)
    ws = [w for _, w in leaves]
    mu = [torch.zeros_like(w) for w in ws]
    nu = [torch.zeros_like(w) for w in ws]
    losses, grad_norms = [], {}
    with no_tf32():
        for step, (tokens, labels) in enumerate(batches, start=1):
            if keep_rows is not None:
                tokens, labels = tokens[keep_rows], labels[keep_rows]
            grads = [torch.zeros_like(w) for w in ws]
            loss = 0.0
            for tk, lb in zip(tokens.chunk(microbatches), labels.chunk(microbatches)):
                for w in ws:
                    w.requires_grad_(True)
                total, _ = train_loss(c, params, tk, lb, precision)
                gs = torch.autograd.grad(total, ws)
                for w in ws:
                    w.requires_grad_(False)
                for acc, g in zip(grads, gs):
                    acc.add_(g)
                loss += float(total.detach()) / microbatches
                del gs, total
            with torch.no_grad():
                grads = [g / microbatches for g in grads]
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(hp["clip_norm"] / (gnorm + 1e-9), max=1.0)
                lr = cosine_lr(hp, step)
                b1, b2 = hp["b1"], hp["b2"]
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for (path, w), g, m, n in zip(leaves, grads, mu, nu):
                    g = g * scale
                    if step == 1:
                        grad_norms[path] = float(torch.linalg.vector_norm(g))
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    n.mul_(b2).add_(g * g, alpha=1 - b2)
                    delta = (m / bc1) / (torch.sqrt(n / bc2) + hp["eps"])
                    w.sub_(lr * (delta + hp["weight_decay"] * w))
            losses.append(loss)
    return {"losses": losses, "grad_norms": grad_norms}
