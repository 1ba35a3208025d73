"""Weights drawn from the seed, on the device, in the dtype they are served in.

The tree is the one `repro_torch.models.LM` takes (the layers' leaves
stacked on a leading axis).  A configuration's plain reference that
defines ``shapes(m)`` lists its tree itself; otherwise `shapes` here lists
the MoE LM's from the ``model`` block alone.  The harness holds the tree
to the program's own specs before handing it over.  Every normal leaf is
N(0, 0.02) (the program's own initial scale), the norms' weights ones.
The bf16 leaves are views of one buffer and the fp32 ones of another, each
filled by a few calls of a generator on the device (at most 2**30 values a
call); the reference draws the same tree again from the same seed.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

SCALE = 0.02
CHUNK = 1 << 30
ALIGN = 64  # elements: every leaf starts 128 bytes into its buffer or more


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (``tag``) from its seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def shapes(m: Dict) -> List[Tuple[str, tuple, str, str]]:
    """(path, shape, dtype, init) of each leaf of the model ``m`` states."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    H, K = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // H
    E, f = m["n_experts"], m["d_ff"]
    wdt = m.get("dtype", "bfloat16")
    out = [("embed", (V, d), wdt, "normal"), ("final_norm", (d,), "float32", "ones"),
           ("blocks/ln1", (L, d), "float32", "ones"), ("blocks/ln2", (L, d), "float32", "ones"),
           ("blocks/attn/w_q", (L, d, H * hd), wdt, "normal"),
           ("blocks/attn/w_k", (L, d, K * hd), wdt, "normal"),
           ("blocks/attn/w_v", (L, d, K * hd), wdt, "normal"),
           ("blocks/attn/w_o", (L, H * hd, d), wdt, "normal"),
           ("blocks/moe/w_router", (L, d, E), "float32", "normal"),
           ("blocks/moe/w_gate", (L, E, d, f), wdt, "normal"),
           ("blocks/moe/w_up", (L, E, d, f), wdt, "normal"),
           ("blocks/moe/w_down", (L, E, f, d), wdt, "normal")]
    if m.get("moe_dense_residual"):
        out += [("blocks/mlp/w_gate", (L, d, f), wdt, "normal"),
                ("blocks/mlp/w_up", (L, d, f), wdt, "normal"),
                ("blocks/mlp/w_down", (L, f, d), wdt, "normal")]
    if not m["tie_embeddings"]:
        out.append(("lm_head", (d, V), wdt, "normal"))
    return sorted(out)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(m: Dict, seed: int, device, reference=None) -> Dict:
    """The weights of the model ``m`` states, drawn from ``seed``: a nested
    dict of tensors on ``device``; the leaves are ``reference.shapes(m)``
    where the reference module defines it."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    leaves = getattr(reference, "shapes", shapes)(m)
    offsets, total = {}, {}
    for path, shape, dt, init in leaves:
        if init == "normal":
            at = total.get(dt, 0)
            offsets[path] = at
            total[dt] = at + -(-_numel(shape) // ALIGN) * ALIGN
    bufs = {}
    for dt in sorted(total):
        buf = torch.empty(total[dt], dtype=getattr(torch, dt), device=device)
        for lo in range(0, total[dt], CHUNK):
            buf[lo:lo + CHUNK].normal_(generator=gen)
        bufs[dt] = buf.mul_(SCALE)
    tree: Dict = {}
    for path, shape, dt, init in leaves:
        if init == "normal":
            at = offsets[path]
            t = bufs[dt][at:at + _numel(shape)].view(shape)
        else:
            t = torch.ones(shape, dtype=getattr(torch, dt), device=device)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree
