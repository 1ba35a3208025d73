"""Plain reference of the attention-free Mamba-2 language model, in fp32.

The model the configuration states, written from its equations with plain
torch operations: token embedding; per layer an RMS norm and a Mamba-2
mixer, a residual; a final RMS norm and the head (the embedding's
transpose: the embeddings are tied).

The mixer (Mamba-2, arXiv:2405.21060, with ngroups 1): from the normed
input u, the gate z = u W_z, the conv input xBC = u W_xBC and the step's
logits u W_dt; xBC through a depthwise causal conv of width ``conv_width``
(`F.conv1d`, left padding) and SiLU, cut into x (heads of ``ssm_head_dim``),
B and C (``ssm_state`` each); dt = softplus(u W_dt + dt_bias) and A =
-exp(A_log) per head.  The SSD, in its dual, quadratic form (§§4-6):

    y = (L o C B^T) (dt x) + D x,  L_ij = exp(dt_{j+1} A + ... + dt_i A), i >= j,

over the whole sequence at once, with no chunks and no carried state:
this form is independent of the chunked scan the program runs.  Then the
gated norm after the gate (``norm_before_gate=False``): RMSNorm(y SiLU(z))
and the out-projection.

The segment sums of L are cumulative sums of a masked (S, S) matrix per
head, so an entry near the diagonal sums its own few terms (not the
difference of two long prefix sums).  L is formed one sequence at a time,
all heads together ((heads, S, S) fp32), and each layer is recomputed in
the backward (`checkpoint`), so that one such L at a time is alive beside
the saved ones of the layer in hand.

``carry=False`` keeps L only within blocks of ``ssm_chunk`` positions (the
state carried from one chunk to the next dropped): a fault for the
limits' readings, never a run's check.

Weights may be given in bf16 (as trained): each is taken to fp32 where
it is used.  With ``precision="fp8"`` every product with a weight runs on
operands rounded to float8 (`moe_lm.product`): the control that a lower
precision than the configuration's has to fail.  The conv, the SSD and
the norms stay in fp32.

Nothing here imports the program; matrix products never use TF32
(`moe_lm.train_steps` runs under `moe_lm.no_tf32`).  AdamW, its schedule,
the leaves' order, the head's loss and the products are `moe_lm`'s.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ocpbench.reference import moe_lm as base
from ocpbench.reference.moe_lm import product, rms_norm, tree_paths  # noqa: F401

F32 = torch.float32


def widths(c: Dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state size)."""
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_head_dim"], c["ssm_head_dim"], c["ssm_state"]


def shapes(c: Dict) -> List[Tuple[str, tuple, str, str]]:
    """(path, shape, dtype, init) of each leaf of the model ``c`` states.
    ``A_log`` and ``dt_bias`` are drawn as ones; a traffic kind may set
    them by the published init."""
    L, d, V, W = c["n_layers"], c["d_model"], c["vocab"], c["conv_width"]
    di, H, _, N = widths(c)
    wdt = c.get("dtype", "bfloat16")
    conv = di + 2 * N
    out = [("embed", (V, d), wdt, "normal"), ("final_norm", (d,), "float32", "ones"),
           ("blocks/ln", (L, d), "float32", "ones"),
           ("blocks/ssm/w_z", (L, d, di), wdt, "normal"),
           ("blocks/ssm/w_xBC", (L, d, conv), wdt, "normal"),
           ("blocks/ssm/w_dt", (L, d, H), wdt, "normal"),
           ("blocks/ssm/conv_w", (L, W, conv), wdt, "normal"),
           ("blocks/ssm/conv_b", (L, conv), wdt, "normal"),
           ("blocks/ssm/A_log", (L, H), "float32", "ones"),
           ("blocks/ssm/dt_bias", (L, H), "float32", "ones"),
           ("blocks/ssm/D", (L, H), "float32", "ones"),
           ("blocks/ssm/norm", (L, di), "float32", "ones"),
           ("blocks/ssm/w_out", (L, di, d), wdt, "normal")]
    if not c["tie_embeddings"]:
        out.append(("lm_head", (d, V), wdt, "normal"))
    return sorted(out)


# ------------------------------------------------------------------ SSD ----

def kept(S: int, chunk: Optional[int], device) -> torch.Tensor:
    """(S, S) bool: the pairs (i, j) with j <= i, within one block of
    ``chunk`` positions where given."""
    i = torch.arange(S, device=device)
    keep = i[:, None] >= i[None, :]
    if chunk:
        keep &= (i[:, None] // chunk) == (i[None, :] // chunk)
    return keep


def segment_sums(a: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """a (H, S) -> (H, S, S): [h, i, j] = a[h, j+1] + ... + a[h, i] where
    ``keep``, else -inf (so that exp gives 0, and a 0 gradient)."""
    S = a.shape[-1]
    below = torch.ones((S, S), dtype=torch.bool, device=a.device).tril(-1)
    terms = a[:, :, None].expand(-1, S, S).masked_fill(~below, 0.0)
    return terms.cumsum(dim=1).masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """The quadratic form over x (b, S, H, P), dt (b, S, H), A (H,), B and
    C (b, S, N), all fp32: y (b, S, H, P), without the skip D x.  One
    sequence at a time, all heads at once."""
    b, S = x.shape[:2]
    keep = kept(S, chunk, x.device)
    out = []
    for r in range(b):
        L = torch.exp(segment_sums((dt[r] * A).T, keep))          # (H, S, S)
        M = L * (C[r] @ B[r].T)                                    # (H, S, S)
        u = (x[r] * dt[r][..., None]).transpose(0, 1)              # (H, S, P)
        out.append((M @ u).transpose(0, 1))                        # (S, H, P)
    return torch.stack(out)


# --------------------------------------------------------------- layers ----

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (b, S, C) by w (W, C) and b (C,)."""
    S, C = x.shape[1], x.shape[2]
    W = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.to(F32).T[:, None, :], b.to(F32), padding=W - 1,
                 groups=C)
    return y[..., :S].transpose(1, 2)


def mixer(c: Dict, p: Dict, u: torch.Tensor, precision: str, carry: bool = True
          ) -> torch.Tensor:
    """The Mamba-2 mixer over the normed u (b, S, d)."""
    b, S, _ = u.shape
    di, H, P, N = widths(c)
    z = product(u, p["w_z"], precision)
    conv = F.silu(causal_conv(product(u, p["w_xBC"], precision), p["conv_w"], p["conv_b"]))
    x = conv[..., :di].reshape(b, S, H, P)
    B, C = conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(product(u, p["w_dt"], precision) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(x, dt, A, B, C, chunk=None if carry else c["ssm_chunk"])
    y = (y + p["D"][:, None] * x).reshape(b, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], c["norm_eps"])
    return product(y, p["w_out"], precision)


def block(c: Dict, p: Dict, x: torch.Tensor, precision: str, carry: bool = True):
    return x + mixer(c, p["ssm"], rms_norm(x, p["ln"], c["norm_eps"]), precision, carry)


# ------------------------------------------------------------ training ----

def train_loss(c: Dict, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
               precision: str = "fp32", rows: int = 2048, carry: bool = True):
    """One microbatch: (cross-entropy, cross-entropy): there is no auxiliary
    loss.  Every layer and every ``rows`` rows of the head recomputed in the
    backward (`checkpoint`)."""
    x = params["embed"][tokens.long()].to(F32)
    B, S, d = x.shape
    for i in range(c["n_layers"]):
        x = checkpoint(lambda x, i=i: block(c, base.layer_params(params, i), x, precision,
                                            carry), x, use_reentrant=False)
    flat, lab = x.reshape(B * S, d), labels.reshape(-1).long()
    ce = sum(checkpoint(base._ce_rows, c, params, flat[r:r + rows], lab[r:r + rows], precision,
                        use_reentrant=False) for r in range(0, B * S, rows)) / (B * S)
    return ce, ce


def train_steps(c: Dict, hp: Dict, params: Dict, batches, microbatches: int,
                precision: str = "fp32", keep_rows=None, carry: bool = True) -> Dict:
    """`moe_lm.train_steps` (AdamW, its schedule and clipping, the first
    gradient's norms) over this model's loss: ``losses`` and
    ``grad_norms``; ``params`` (fp32 leaves) updated in place."""
    saved = base.train_loss
    base.train_loss = functools.partial(train_loss, carry=carry)
    try:
        return base.train_steps(c, hp, params, batches, microbatches, precision,
                                keep_rows=keep_rows)
    finally:
        base.train_loss = saved
