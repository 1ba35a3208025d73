"""Decoder-only LM (`repro.models.lm.LM`): dense, MoE, hybrid and ssm
families.

The module holds its parameters in the JAX package's tree: the token
embedding, the final norm, an untied head where the config asks for one
(``top``), and the layers' parameters stacked on a leading axis
(``stack``).  The JAX package scans the layers; here they are a Python
loop over `blocks`, each layer's views of the stacked tensors.  Weights
keep the JAX layout (``x @ W`` with W of shape (d_in, d_out)), so the JAX
package's parameters load unchanged (`carry.lm_params_from_numpy`).
`param_tree` hands out the Parameters themselves: an in-place update of
the tree (the optimizer's) is an update of the model.

Parameters do not require gradients until the caller asks for them with
``model.requires_grad_(True)`` (`train.make_train_step` does).  Autograd's
leaves are then the tree's tensors, in their own dtype, and the gradients
come in the tree's stacked shapes.  While autograd records them, each
layer of `forward` (each repeat of the hybrid pattern, and the tail) runs
under the config's ``remat`` policy (`layers.maybe_remat`), as the JAX
package's scan body does.  ``forward(tokens, embeds=)`` puts the patch
frontend stub's embeddings before the tokens.

The dense and MoE families' cache is the JAX tree ``{"blocks": {"k": (L,
B, S, K, hd), "v": ...}}``; the ssm family's is ``{"blocks": {"state": (L, B, H, P,
N) fp32, "conv": (L, B, conv_width - 1, d_inner + 2N)}}``, O(1) in the
sequence.  `decode_step` writes either in place.

The hybrid family (Griffin: RG-LRU recurrent units R and local-attention
units A in ``hybrid_pattern``) stacks whole repeats of the pattern under
``blocks``, each unit under its own key ("a", "b", ...), and the layers
left over under ``tail`` (one repeat of the pattern's first units), as
the JAX package does.  Its cache holds, per R unit, the fp32 state ``h``
and the conv tail, and per A unit a rotating window of ``wlen =
min(local_window, cache_len)`` keys and values, position p at slot p mod
wlen.  `decode_step` attends to the window through `flash_decode` with
lengths min(index + 1, wlen): every slot under that length holds one of
the window's positions, and the softmax does not depend on their order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..kernels.flash_decode.ref import as_lens
from ..train.sharding import constrain, relayout, zeros
from .attention import attention, attention_decode, attention_specs, prefill_kv
from .config import ModelConfig
from .layers import (maybe_remat, mlp, mlp_specs, per_seq_positions, rms_norm, rms_norm_spec,
                     rotary)
from .moe import moe, moe_specs
from .params import DTYPES, ParamSpec, init_params, map_specs
from .rglru import rglru_block, rglru_decode_step, rglru_specs
from .spmd import (cache_insert, copy_into, embedding, flash_decode, is_dtensor,
                   merge_heads, own_grad, pad, roll, split_heads)
from .ssm import ssm_block, ssm_decode_step, ssm_specs

F32 = torch.float32
UNIT_KEYS = "abcdefgh"  # the hybrid units' keys within a repeat of the pattern
ACT = ("act_batch", "act_seq", "act_embed")  # the layout of the residual stream


def _write_prefix(c: torch.Tensor, k: torch.Tensor) -> None:
    """``c[:, :S] = k`` for k (B, S, ...); a DTensor cache takes k padded
    to its length."""
    if is_dtensor(c):
        copy_into(c, pad(k, (0, 0, 0, 0, 0, c.shape[1] - k.shape[1])))
    else:
        c[:, :k.shape[1]] = k


def _write_window(c: torch.Tensor, k: torch.Tensor, wlen: int) -> None:
    """The rotating window of the last ``wlen`` of k's S positions,
    position p at slot p mod wlen (a roll, for a DTensor cache)."""
    S = k.shape[1]
    if S <= wlen:
        _write_prefix(c, k)
    elif is_dtensor(c):
        copy_into(c, roll(k[:, S - wlen:], S % wlen, 1))
    else:
        keep = torch.arange(S - wlen, S, device=k.device)
        c[:, keep % wlen] = k[:, keep]


def stack_specs(tree, n: int):
    return map_specs(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=("layers",) + s.axes), tree)


def block_specs(cfg: ModelConfig) -> dict:
    """One layer's parameters."""
    if cfg.family == "ssm":
        return {"ln": rms_norm_spec(cfg.d_model), "ssm": ssm_specs(cfg)}
    out = {"ln1": rms_norm_spec(cfg.d_model),
           "attn": attention_specs(cfg),
           "ln2": rms_norm_spec(cfg.d_model)}
    if cfg.family == "moe":
        out["moe"] = moe_specs(cfg)
    if cfg.family == "dense" or cfg.moe_dense_residual:
        out["mlp"] = mlp_specs(cfg)
    return out


def hybrid_unit_specs(cfg: ModelConfig, kind: str) -> dict:
    """One hybrid unit: an RG-LRU (``"R"``) or local attention (``"A"``)
    mixer and an MLP, both pre-norm residual."""
    temporal = rglru_specs(cfg) if kind == "R" else attention_specs(cfg)
    return {"ln1": rms_norm_spec(cfg.d_model), "temporal": temporal,
            "ln2": rms_norm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


def hybrid_layout(cfg: ModelConfig):
    """(whole repeats of the pattern, layers left over for the tail)."""
    plen = len(cfg.hybrid_pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


def _hybrid_stacks(cfg: ModelConfig, unit) -> dict:
    """``{"blocks": repeats stacked, "tail": the leftover units}`` of
    ``unit(kind)`` trees (no tail when the pattern divides the layers)."""
    n_rep, n_left = hybrid_layout(cfg)
    out = {"blocks": stack_specs({k: unit(kind) for k, kind in
                                  zip(UNIT_KEYS, cfg.hybrid_pattern)}, n_rep)}
    if n_left:
        out["tail"] = stack_specs({k: unit(kind) for k, kind in
                                   zip(UNIT_KEYS, cfg.hybrid_pattern[:n_left])}, 1)
    return out


def lm_specs(cfg: ModelConfig) -> dict:
    """The LM's parameters, layers stacked on a leading axis (the JAX
    package's `LM.specs`)."""
    out = {"embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              dtype=cfg.dtype),
           "final_norm": rms_norm_spec(cfg.d_model)}
    if cfg.family == "hybrid":
        out.update(_hybrid_stacks(cfg, lambda kind: hybrid_unit_specs(cfg, kind)))
    else:
        out["blocks"] = stack_specs(block_specs(cfg), cfg.n_layers)
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                   dtype=cfg.dtype)
    return out


def lm_cache_specs(cfg: ModelConfig, B: int, cache_len: int) -> dict:
    """The decode cache: (L, B, cache_len, K, hd) K and V for the dense
    and MoE families; for the ssm family O(1) states, whatever
    ``cache_len``; for the hybrid family O(1) states and a window of at
    most ``local_window`` positions."""
    if cfg.family == "hybrid":
        return _hybrid_stacks(cfg, lambda kind: _unit_cache_spec(cfg, kind, B, cache_len))
    if cfg.family == "ssm":
        st = {"state": ParamSpec((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                 ("batch", "heads_cache", None, None),
                                 dtype="float32", init="zeros"),
              "conv": ParamSpec((B, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                ("batch", None, "inner"), dtype=cfg.dtype,
                                init="zeros")}
        return {"blocks": stack_specs(st, cfg.n_layers)}
    kv = ParamSpec((B, cache_len, cfg.n_kv_heads, cfg.head_dim),
                   ("batch", "kv_len", "kv_heads_cache", None),
                   dtype=cfg.dtype, init="zeros")
    return {"blocks": stack_specs({"k": kv, "v": kv}, cfg.n_layers)}


def _unit_cache_spec(cfg: ModelConfig, kind: str, B: int, cache_len: int) -> dict:
    if kind == "R":
        return {"h": ParamSpec((B, cfg.d_rnn), ("batch", "rnn"), dtype="float32",
                               init="zeros"),
                "conv": ParamSpec((B, cfg.conv_width - 1, cfg.d_rnn),
                                  ("batch", None, "rnn"), dtype=cfg.dtype, init="zeros")}
    kv = ParamSpec((B, min(cfg.local_window, cache_len), cfg.n_kv_heads, cfg.head_dim),
                   ("batch", "kv_len", "kv_heads_cache", None), dtype=cfg.dtype,
                   init="zeros")
    return {"k": kv, "v": kv}


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become (gradient-free)
    Parameters, dicts submodules, under the same keys."""

    def __init__(self, tree: Dict):
        super().__init__()
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> Dict:
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


class Layer(dict):
    """One layer's parameters: a dict with attribute access."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None


def _unbind(v: torch.Tensor) -> tuple:
    """The layers of a stacked leaf; on a DTensor each layer's gradient is
    brought to its slice's layout, so that the backward stacks them in
    the leaf's layout whatever the depth."""
    if not is_dtensor(v):
        return v.unbind(0)
    return tuple(relayout(s, s.device_mesh, tuple(s.placements)) for s in v.unbind(0))


def _layers(tree, n: int) -> list:
    """``n`` `Layer`s, layer i holding index i of each stacked leaf: one
    `unbind` a leaf, whose backward stacks the layers' gradients."""
    per = {k: _layers(v, n) if isinstance(v, dict) else _unbind(v)
           for k, v in tree.items()}
    return [Layer({k: v[i] for k, v in per.items()}) for i in range(n)]


def stack_views(stack: "ParamTree", n: int, cache: Dict, key: str) -> list:
    """The ``n`` `Layer`s of a stacked ``stack``, views of its tensors.
    Taken anew while autograd records (so the layers' gradients reach the
    stacked leaves), else once and kept in ``cache`` under ``key``."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in stack.parameters()):
        return _layers(stack.tree(), n)
    if key not in cache:
        cache[key] = _layers(stack.tree(), n)
    return cache[key]


def remat_policy(model: nn.Module) -> str:
    """``model.cfg.remat`` while autograd records ``model``'s parameters
    (training), else ``"none"``: a forward that differentiates nothing
    keeps no activations to begin with (the serving paths)."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters()):
        return model.cfg.remat
    return "none"


def _as_index(index):
    """A decode position as an int where it is one on the host, else a
    tensor (kept on its device: no sync)."""
    if isinstance(index, (int, np.integer)):
        return int(index)
    if torch.is_tensor(index) and index.dim() == 0 and not index.is_cuda:
        return int(index)
    if isinstance(index, np.ndarray) and index.ndim == 0:
        return int(index)
    return index


class LM(nn.Module):
    """Decoder-only language model over a ModelConfig (dense, MoE, hybrid
    or ssm family).

    ``params`` is a tree in the JAX package's structure (blocks stacked on
    a leading layer axis); without it the parameters are drawn by
    `init_params` from ``generator`` (default: seed 0 on ``device``).
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
            raise ValueError(f"LM does not handle family {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(self.specs(), generator, device=self.device)
        top = {k: v for k, v in params.items() if k not in ("blocks", "tail")}
        self.top = ParamTree(top)
        self.stack = ParamTree(params["blocks"])
        self.tail_stack = ParamTree(params["tail"]) if "tail" in params else None
        self._n_stacked = (hybrid_layout(cfg)[0] if cfg.family == "hybrid"
                           else cfg.n_layers)
        self._views: Dict[str, list] = {}

    # ---------------------------------------------------------- specs ----
    def specs(self) -> dict:
        return lm_specs(self.cfg)

    def param_tree(self) -> Dict:
        """The parameters in the JAX package's structure (blocks stacked),
        not copied."""
        out = self.top.tree()
        out["blocks"] = self.stack.tree()
        if self.tail_stack is not None:
            out["tail"] = self.tail_stack.tree()
        return out

    @property
    def blocks(self) -> list:
        """Each layer's parameters (a repeat of the pattern's units in the
        hybrid family), views of the stacked ones (`stack_views`)."""
        return stack_views(self.stack, self._n_stacked, self._views, "blocks")

    @property
    def tail(self) -> list:
        """The hybrid family's leftover units (one entry, or none)."""
        if self.tail_stack is None:
            return []
        return stack_views(self.tail_stack, 1, self._views, "tail")

    def _units(self):
        """The hybrid units in order: (tree key, stacked index, unit key,
        kind, parameters)."""
        pattern = self.cfg.hybrid_pattern
        for where, layers in (("blocks", self.blocks), ("tail", self.tail)):
            for i, layer in enumerate(layers):
                for key, kind in zip(UNIT_KEYS, pattern):
                    if key in layer:
                        yield where, i, key, kind, layer[key]

    # -------------------------------------------------------- forward ----
    def _ffn(self, p, x: torch.Tensor):
        """The feed-forward half of a layer on the normed x: the MLP, or the
        MoE (plus the MLP under ``moe_dense_residual``).  Returns (out, aux
        or None)."""
        cfg = self.cfg
        if cfg.family == "dense":
            return mlp(p.mlp, x, cfg.act), None
        y, aux = moe(p.moe, cfg, x)
        if cfg.moe_dense_residual:
            y = y + mlp(p.mlp, x, cfg.act)
        return y, aux

    def _apply_unit(self, p, x: torch.Tensor, positions: torch.Tensor, kind: str,
                    window: Optional[int] = None, return_cache: bool = False):
        """One hybrid unit: the temporal mixer and the MLP, both pre-norm
        residual.  ``window`` (default ``local_window``) bounds the A
        unit's attention.  With ``return_cache`` also the unit's decode
        state: (h, conv) for R, the (k, v) of every position for A."""
        cfg = self.cfg
        xin = rms_norm(x, p.ln1, cfg.norm_eps)
        if kind == "R":
            out = rglru_block(p.temporal, cfg, xin, return_cache=return_cache)
            h, state = (out[0], out[1:]) if return_cache else (out, None)
        else:
            out = attention(p.temporal, cfg, xin, positions,
                            window=window or cfg.local_window, return_kv=return_cache)
            h, state = out if return_cache else (out, None)
        x = constrain(x + h, ACT)
        x = constrain(x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.act), ACT)
        return (x, state) if return_cache else x

    def _block_fwd(self, p, x: torch.Tensor, positions: torch.Tensor):
        """One layer; returns (x, the MoE aux loss or None)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return constrain(x + ssm_block(p.ssm, cfg, rms_norm(x, p.ln, cfg.norm_eps)),
                             ACT), None
        x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps), positions)
        # the heads' partial sums reduced before the MLP (under a plan)
        x = constrain(x, ACT)
        y, aux = self._ffn(p, rms_norm(x, p.ln2, cfg.norm_eps))
        return constrain(x + y, ACT), aux

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = embedding(tokens.to(self.device), self.top.embed)
        # under a plan: the lookup's partial sums reduced, the batch
        # layout pinned (see spmd.embedding)
        return constrain(x, ACT)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        out = x @ (own_grad(self.top.embed).T if self.cfg.tie_embeddings else self.top.lm_head)
        return constrain(out, ("act_batch", "act_seq", "act_vocab"))

    def _positions(self, S: int) -> torch.Tensor:
        """(1, S): the rotary tables broadcast over the batch (under a plan
        a plain (B, S) would make the whole batch's on every device)."""
        return torch.arange(S, device=self.device)[None]

    def _repeat_fwd(self, p, x: torch.Tensor, positions: torch.Tensor, pattern: str):
        """One repeat of the hybrid pattern (or the tail's units)."""
        for key, kind in zip(UNIT_KEYS, pattern):
            x = self._apply_unit(p[key], x, positions, kind)
        return x

    def forward(self, tokens: torch.Tensor, embeds: Optional[torch.Tensor] = None):
        """tokens (B, S_text) int; ``embeds`` (B, S_img, d), the patch
        frontend stub's output, is prepended to the sequence in the
        activations' dtype.  Returns (logits over all S_img + S_text
        positions, aux); aux is the sum of the layers' MoE router losses
        (fp32), 0 for the other families.

        Each layer (each repeat of the hybrid pattern, and the tail's) runs
        under the config's ``remat`` policy (`maybe_remat`), as the
        reference's scan body does."""
        x = self.embed_tokens(tokens)
        if embeds is not None:
            x = torch.cat([embeds.to(device=self.device, dtype=x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = self._positions(S)
        aux = torch.zeros((), dtype=F32, device=self.device)
        if self.cfg.family == "hybrid":
            body = maybe_remat(self._repeat_fwd, remat_policy(self))
            pattern = self.cfg.hybrid_pattern
            for p in self.blocks:
                x = body(p, x, positions, pattern)
            for p in self.tail:
                x = body(p, x, positions, pattern[:hybrid_layout(self.cfg)[1]])
            return self.logits(x), aux
        body = maybe_remat(self._block_fwd, remat_policy(self))
        for p in self.blocks:
            x, a = body(p, x, positions)
            if a is not None:
                aux = aux + a
        return self.logits(x), aux

    # ---------------------------------------------------------- decode ----
    def cache_specs(self, B: int, cache_len: int) -> dict:
        return lm_cache_specs(self.cfg, B, cache_len)

    def _unit_decode(self, p, c: Dict, i: int, x: torch.Tensor, index, kind: str):
        """One hybrid unit at one token; its cache ``c`` (the stacked
        leaves, entry ``i``) is updated in place."""
        cfg = self.cfg
        xin = rms_norm(x, p.ln1, cfg.norm_eps)
        if kind == "R":
            h, hs, conv = rglru_decode_step(p.temporal, cfg, xin, c["h"][i], c["conv"][i])
            copy_into(c["h"][i], hs)
            copy_into(c["conv"][i], conv)
        else:
            # the rotating window: position p at slot p mod wlen
            ck, cv = c["k"][i], c["v"][i]
            B, wlen = x.shape[0], ck.shape[1]
            H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            positions = per_seq_positions(index, B, x.device)
            q = rotary(split_heads(xin @ p.temporal.w_q, H, hd), positions, cfg.rope_theta)
            k = rotary(split_heads(xin @ p.temporal.w_k, K, hd), positions, cfg.rope_theta)
            v = split_heads(xin @ p.temporal.w_v, K, hd)
            if isinstance(index, int):
                slot, n_valid = index % wlen, min(index + 1, wlen)
            else:
                pos = as_lens(index, B, x.device)
                slot, n_valid = pos % wlen, torch.clamp(pos + 1, max=wlen)
            cache_insert(ck, k, slot)
            cache_insert(cv, v, slot)
            out = flash_decode(q, ck, cv, n_valid, scale=hd ** -0.5)
            h = merge_heads(out) @ p.temporal.w_o
        x = constrain(x + h, ACT)
        return constrain(x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.act), ACT)

    def _block_decode(self, p, cache_k: torch.Tensor, cache_v: torch.Tensor,
                      x: torch.Tensor, index) -> torch.Tensor:
        cfg = self.cfg
        h, _, _ = attention_decode(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                                   cache_k, cache_v, index)
        x = constrain(x + h, ACT)
        y, _ = self._ffn(p, rms_norm(x, p.ln2, cfg.norm_eps))
        return constrain(x + y, ACT)

    def decode_step(self, cache: Dict, token: torch.Tensor, index):
        """token (B, 1) int; index an int position or (B,) per-sequence
        positions (continuous batching).  Returns (logits (B, 1, V), cache),
        the cache updated in place."""
        x = self.embed_tokens(token)
        if self.cfg.family == "hybrid":
            index = _as_index(index)
            for where, i, key, kind, p in self._units():
                x = self._unit_decode(p, cache[where][key], i, x, index, kind)
            return self.logits(x), cache
        if self.cfg.family == "ssm":  # the recurrence has no positions
            st, conv = cache["blocks"]["state"], cache["blocks"]["conv"]
            for i, p in enumerate(self.blocks):
                h, _, _ = ssm_decode_step(p.ssm, self.cfg,
                                          rms_norm(x, p.ln, self.cfg.norm_eps),
                                          st[i], conv[i])
                x = constrain(x + h, ACT)
            return self.logits(x), cache
        index = _as_index(index)
        ck, cv = cache["blocks"]["k"], cache["blocks"]["v"]
        for i, p in enumerate(self.blocks):
            x = self._block_decode(p, ck[i], cv[i], x, index)
        return self.logits(x), cache

    # --------------------------------------------------------- prefill ----
    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """Run the prompt and build its decode cache of ``cache_len``
        positions.  Returns (last-token logits (B, 1, V), cache).  With
        ``fused_prefill_kv`` the forward pass's K/V fill the cache; without
        it they are projected a second time (`prefill_kv`), as the JAX
        package's two bodies do.  The ssm family's cache is the chunked
        forward pass's final states and conv tails (`ssm_block` with
        ``return_cache``), where the JAX package steps the prompt through
        `decode_step` token by token; the two agree (the duality), and
        ``cache_len`` does not size it.  The hybrid family's is built the
        same way, from one forward pass (`_hybrid_prefill`)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        if cfg.family == "hybrid":
            return self._hybrid_prefill(x, cache_len)
        if cfg.family == "ssm":
            states, convs = [], []
            for p in self.blocks:
                h, st, conv = ssm_block(p.ssm, cfg, rms_norm(x, p.ln, cfg.norm_eps),
                                        return_cache=True)
                x = constrain(x + h, ACT)
                states.append(st)
                convs.append(conv)
            return self.logits(x[:, -1:]), {"blocks": {"state": torch.stack(states),
                                                       "conv": torch.stack(convs)}}
        positions = self._positions(S)
        shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads, cfg.head_dim)
        names = ("layers", "batch", "kv_len", "kv_heads_cache", None)
        ck = zeros(shape, names, x.dtype, self.device, like=x)
        cv = zeros(shape, names, x.dtype, self.device, like=x)
        for i, p in enumerate(self.blocks):
            xin = rms_norm(x, p.ln1, cfg.norm_eps)
            if cfg.fused_prefill_kv:
                h, (k, v) = attention(p.attn, cfg, xin, positions, return_kv=True)
                x = constrain(x + h, ACT)
                x = constrain(x + self._ffn(p, rms_norm(x, p.ln2, cfg.norm_eps))[0], ACT)
                _write_prefix(ck[i], k)
                _write_prefix(cv[i], v)
            else:
                k, v = prefill_kv(p.attn, cfg, xin, positions, cache_len)
                x, _ = self._block_fwd(p, x, positions)
                copy_into(ck[i], k)
                copy_into(cv[i], v)
        return self.logits(x[:, -1:]), {"blocks": {"k": ck, "v": cv}}

    def _hybrid_prefill(self, x: torch.Tensor, cache_len: int):
        """The hybrid prompt in one forward pass, and the cache stepping it
        through `decode_step` would leave: each R unit's last h and conv
        tail (`rglru_block` with ``return_cache``), each A unit's keys and
        values of the last wlen positions at their slots.  The A units
        attend within ``wlen = min(local_window, cache_len)``, the window
        the decode steps see (``local_window`` itself once the cache is at
        least that long)."""
        cfg = self.cfg
        B, S, _ = x.shape
        positions = self._positions(S)
        wlen = min(cfg.local_window, cache_len)
        cache = map_specs(lambda s: zeros(s.shape, s.axes, DTYPES[s.dtype], self.device,
                                          like=x), self.cache_specs(B, cache_len))
        for where, i, key, kind, p in self._units():
            x, state = self._apply_unit(p, x, positions, kind, window=wlen,
                                        return_cache=True)
            c = cache[where][key]
            if kind == "R":
                copy_into(c["h"][i], state[0])
                copy_into(c["conv"][i], state[1])
            else:
                _write_window(c["k"][i], state[0], wlen)
                _write_window(c["v"][i], state[1], wlen)
        return self.logits(x[:, -1:]), cache
