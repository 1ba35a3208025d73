"""``flash_attention_grad_roofline.*``: the attention gradient kernels'
share of their roofline in the traced iteration.  Each of the traffic's
``calls["flash_attention"]`` (one a step: the sequences of a microbatch
and their length) stands for ``n_layers x microbatches`` gradient calls;
a call's least time is its 10 x hd operations per live (query head, key)
pair (S = q k^T again, dP, dV, dQ, dK), or its bytes (q, out, dO, dq;
k, v, dk, dv; the fp32 logsumexp), whichever is longer.  Over the device
time of the ops named ``attn_grad*`` (the kernels' prefix) in the train
phase; None where none ran."""
from ocpbench.counts import moe_lm as counts
from ocpbench.rooflines import kernel_share

NAMES = ("attn_grad",)
PHASE = "train"


def grad_call(m, B: int, S: int):
    """One causal self-attention gradient over (B, S) tokens: (FLOPs, bytes)."""
    H, K, hd = m["n_heads"], m["n_kv_heads"], counts._hd(m)
    flops = 10 * B * H * hd * counts.causal_pairs(S)
    nbytes = counts._elem(m) * (4 * B * S * H * hd + 4 * B * S * K * hd) + 4 * B * H * S
    return flops, nbytes


def read(name, run):
    shapes = run.calls.get("flash_attention")
    if run.peaks is None or run.model is None or not shapes:
        return None
    per_step = run.model["n_layers"] * run.mix.get("microbatches", 1)
    least = sum(per_step * counts.least_s(*grad_call(run.model, B, S), run.peaks)
                for B, S in shapes)
    return kernel_share(run, "flash_attention_grad", least, PHASE, NAMES)
