"""Decoder-only LM (`repro.models.lm.LM`), dense, MoE and ssm families.

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
come in the tree's stacked shapes.

The dense and MoE families' cache is the JAX tree ``{"blocks": {"k": (L,
B, S, K, hd), "v": ...}}``; the ssm family's is ``{"blocks": {"state": (L, B, H, P,
N) fp32, "conv": (L, B, conv_width - 1, d_inner + 2N)}}``, O(1) in the
sequence.  `decode_step` writes either in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .attention import attention, attention_decode, attention_specs, prefill_kv
from .config import ModelConfig
from .layers import mlp, mlp_specs, rms_norm, rms_norm_spec
from .moe import moe, moe_specs
from .params import ParamSpec, init_params, map_specs
from .ssm import ssm_block, ssm_decode_step, ssm_specs

F32 = torch.float32

_LATER_FAMILIES = {"hybrid": "ROADMAP A10 (hybrid family)"}


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


def lm_specs(cfg: ModelConfig) -> dict:
    """The LM's parameters, layers stacked on a leading axis (the JAX
    package's `LM.specs`)."""
    out = {"embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              dtype=cfg.dtype),
           "final_norm": rms_norm_spec(cfg.d_model),
           "blocks": stack_specs(block_specs(cfg), cfg.n_layers)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                   dtype=cfg.dtype)
    return out


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


def _layers(tree, n: int) -> list:
    """``n`` `Layer`s, layer i holding index i of each stacked leaf: one
    `unbind` a leaf, whose backward stacks the layers' gradients."""
    per = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in tree.items()}
    return [Layer({k: v[i] for k, v in per.items()}) for i in range(n)]


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
    """Decoder-only language model over a ModelConfig (dense, MoE or ssm
    family).

    ``params`` is a tree in the JAX package's structure (blocks stacked on
    a leading layer axis); without it the parameters are drawn by
    `init_params` from ``generator`` (default: seed 0 on ``device``).
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family in _LATER_FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is not in the port "
                                      f"yet; see {_LATER_FAMILIES[cfg.family]}")
        if cfg.family not in ("dense", "moe", "ssm"):
            raise ValueError(f"LM does not handle family {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(self.specs(), generator, device=self.device)
        top = {k: v for k, v in params.items() if k != "blocks"}
        self.top = ParamTree(top)
        self.stack = ParamTree(params["blocks"])
        self._views = None

    # ---------------------------------------------------------- specs ----
    def specs(self) -> dict:
        return lm_specs(self.cfg)

    def param_tree(self) -> Dict:
        """The parameters in the JAX package's structure (blocks stacked),
        not copied."""
        out = self.top.tree()
        out["blocks"] = self.stack.tree()
        return out

    @property
    def blocks(self) -> list:
        """Each layer's parameters, views of the stacked ones.  Taken anew
        while autograd records (so the layers' gradients reach the stacked
        leaves), else once."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.stack.parameters()):
            return _layers(self.stack.tree(), self.cfg.n_layers)
        if self._views is None:
            self._views = _layers(self.stack.tree(), self.cfg.n_layers)
        return self._views

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

    def _block_fwd(self, p, x: torch.Tensor, positions: torch.Tensor):
        """One layer; returns (x, the MoE aux loss or None)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return x + ssm_block(p.ssm, cfg, rms_norm(x, p.ln, cfg.norm_eps)), None
        x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps), positions)
        y, aux = self._ffn(p, rms_norm(x, p.ln2, cfg.norm_eps))
        return x + y, aux

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.to(self.device), self.top.embed)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ self.top.embed.T
        return x @ self.top.lm_head

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device).expand(B, S)

    def forward(self, tokens: torch.Tensor):
        """tokens (B, S) int.  Returns (logits, aux); aux is the sum of the
        layers' MoE router losses (fp32), 0 for the dense and ssm families."""
        x = self.embed_tokens(tokens)
        B, S, _ = x.shape
        positions = self._positions(B, S)
        aux = torch.zeros((), dtype=F32, device=self.device)
        for p in self.blocks:
            x, a = self._block_fwd(p, x, positions)
            if a is not None:
                aux = aux + a
        return self.logits(x), aux

    # ---------------------------------------------------------- decode ----
    def cache_specs(self, B: int, cache_len: int) -> dict:
        """The decode cache: (L, B, cache_len, K, hd) K and V for the dense
        and MoE families; for the ssm family O(1) states, whatever ``cache_len``."""
        cfg = self.cfg
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

    def _block_decode(self, p, cache_k: torch.Tensor, cache_v: torch.Tensor,
                      x: torch.Tensor, index) -> torch.Tensor:
        cfg = self.cfg
        h, _, _ = attention_decode(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                                   cache_k, cache_v, index)
        x = x + h
        y, _ = self._ffn(p, rms_norm(x, p.ln2, cfg.norm_eps))
        return x + y

    def decode_step(self, cache: Dict, token: torch.Tensor, index):
        """token (B, 1) int; index an int position or (B,) per-sequence
        positions (continuous batching).  Returns (logits (B, 1, V), cache),
        the cache updated in place."""
        x = self.embed_tokens(token)
        if self.cfg.family == "ssm":  # the recurrence has no positions
            st, conv = cache["blocks"]["state"], cache["blocks"]["conv"]
            for i, p in enumerate(self.blocks):
                h, _, _ = ssm_decode_step(p.ssm, self.cfg,
                                          rms_norm(x, p.ln, self.cfg.norm_eps),
                                          st[i], conv[i])
                x = x + h
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
        ``cache_len`` does not size it."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        if cfg.family == "ssm":
            states, convs = [], []
            for p in self.blocks:
                h, st, conv = ssm_block(p.ssm, cfg, rms_norm(x, p.ln, cfg.norm_eps),
                                        return_cache=True)
                x = x + h
                states.append(st)
                convs.append(conv)
            return self.logits(x[:, -1:]), {"blocks": {"state": torch.stack(states),
                                                       "conv": torch.stack(convs)}}
        positions = self._positions(B, S)
        shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads, cfg.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=self.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=self.device)
        for i, p in enumerate(self.blocks):
            xin = rms_norm(x, p.ln1, cfg.norm_eps)
            if cfg.fused_prefill_kv:
                h, (k, v) = attention(p.attn, cfg, xin, positions, return_kv=True)
                x = x + h
                x = x + self._ffn(p, rms_norm(x, p.ln2, cfg.norm_eps))[0]
                ck[i, :, :S] = k
                cv[i, :, :S] = v
            else:
                k, v = prefill_kv(p.attn, cfg, xin, positions, cache_len)
                x, _ = self._block_fwd(p, x, positions)
                ck[i].copy_(k)
                cv[i].copy_(v)
        return self.logits(x[:, -1:]), {"blocks": {"k": ck, "v": cv}}
