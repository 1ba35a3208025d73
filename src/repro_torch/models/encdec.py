"""Encoder-decoder transformer (`repro.models.encdec`; the SeamlessM4T
backbone, arXiv:2308.11596).

The audio frontend is a stub: the encoder takes precomputed frame
embeddings.  The decoder is a causal transformer with cross-attention.
Its decode step keeps a self-attention KV cache and attends to cross K/V
precomputed from the encoder's memory (`build_cross_cache`), both through
`flash_decode` (the self-attention with lengths index + 1, the
cross-attention with the memory's length).  The encoder's self-attention
and the teacher-forced decoder's cross-attention go through
`flash_attention` with ``causal=False``.

The parameters are the JAX package's tree: ``embed``, ``enc_final_norm``,
``final_norm``, the layers stacked under ``encoder`` and ``decoder``, and
an untied ``lm_head`` where the config asks for one.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..kernels.flash_decode.ref import as_lens
from ..train.sharding import constrain, zeros
from .attention import attention, attention_specs
from .config import ModelConfig
from .layers import (maybe_remat, mlp, mlp_specs, per_seq_positions, rms_norm, rms_norm_spec,
                     rotary)
from .lm import ACT, ParamTree, _as_index, remat_policy, stack_specs, stack_views
from .params import ParamSpec, init_params
from .spmd import (cache_insert, embedding, flash_attention, flash_decode, merge_heads,
                   own_grad, split_heads)

F32 = torch.float32


def encdec_specs(cfg: ModelConfig) -> dict:
    """The JAX package's `EncDecLM.specs`."""
    enc = {"ln1": rms_norm_spec(cfg.d_model), "attn": attention_specs(cfg),
           "ln2": rms_norm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}
    dec = {"ln1": rms_norm_spec(cfg.d_model), "self_attn": attention_specs(cfg),
           "ln_x": rms_norm_spec(cfg.d_model), "cross_attn": attention_specs(cfg),
           "ln2": rms_norm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}
    out = {"embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), dtype=cfg.dtype),
           "enc_final_norm": rms_norm_spec(cfg.d_model),
           "final_norm": rms_norm_spec(cfg.d_model),
           "encoder": stack_specs(enc, cfg.n_enc_layers),
           "decoder": stack_specs(dec, cfg.n_dec_layers)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                   dtype=cfg.dtype)
    return out


def encdec_cache_specs(cfg: ModelConfig, B: int, cache_len: int, enc_len: int) -> dict:
    """The self-attention KV cache of ``cache_len`` positions and the
    cross K/V of ``enc_len`` memory positions, per decoder layer."""
    K, hd = cfg.n_kv_heads, cfg.head_dim

    def kv(n):
        return ParamSpec((B, n, K, hd), ("batch", "kv_len", "kv_heads_cache", None),
                         dtype=cfg.dtype, init="zeros")

    return {"decoder": stack_specs({"k": kv(cache_len), "v": kv(cache_len),
                                    "xk": kv(enc_len), "xv": kv(enc_len)},
                                   cfg.n_dec_layers)}


class EncDecLM(nn.Module):
    """Encoder-decoder model over a ModelConfig of the ``encdec`` family.

    ``params`` is a tree in the JAX package's structure; without it the
    parameters are drawn by `init_params` from ``generator`` (default:
    seed 0 on ``device``)."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM does not handle family {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(self.specs(), generator, device=self.device)
        self.top = ParamTree({k: v for k, v in params.items()
                              if k not in ("encoder", "decoder")})
        self.enc_stack = ParamTree(params["encoder"])
        self.dec_stack = ParamTree(params["decoder"])
        self._views: Dict[str, list] = {}

    def specs(self) -> dict:
        return encdec_specs(self.cfg)

    def param_tree(self) -> Dict:
        """The parameters in the JAX package's structure, not copied."""
        out = self.top.tree()
        out["encoder"] = self.enc_stack.tree()
        out["decoder"] = self.dec_stack.tree()
        return out

    @property
    def encoder(self) -> list:
        """Each encoder layer's parameters (`stack_views`)."""
        return stack_views(self.enc_stack, self.cfg.n_enc_layers, self._views, "encoder")

    @property
    def decoder(self) -> list:
        return stack_views(self.dec_stack, self.cfg.n_dec_layers, self._views, "decoder")

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = embedding(tokens.to(self.device), self.top.embed)
        return constrain(x, ACT)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ own_grad(self.top.embed).T
        return x @ self.top.lm_head

    def _positions(self, S: int) -> torch.Tensor:
        """(1, S): the rotary tables broadcast over the batch (under a plan
        a plain (B, S) would make the whole batch's on every device)."""
        return torch.arange(S, device=self.device)[None]

    # ---------------------------------------------------------- encoder ----
    def encode(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """frame_embeds (B, T, d), the stub frontend's output -> the
        encoder's memory (B, T, d)."""
        cfg = self.cfg
        x = constrain(frame_embeds.to(self.device), ACT)
        B, S, _ = x.shape
        positions = self._positions(S)
        body = maybe_remat(self._enc_layer, remat_policy(self))
        for p in self.encoder:
            x = body(p, x, positions)
        return rms_norm(x, self.top.enc_final_norm, cfg.norm_eps)

    def _enc_layer(self, p, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps), positions,
                          causal=False)
        x = constrain(x, ACT)
        return constrain(x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.act), ACT)

    # ------------------------------------------------------- cross attn ----
    def _cross(self, p, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """Non-causal attention of the decoder's x to the memory (no
        rotary, as the JAX package's)."""
        cfg = self.cfg
        B, Sq, _ = x.shape
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        Sm = memory.shape[1]
        q = split_heads(x @ p.w_q, H, hd)
        k = split_heads(memory @ p.w_k, K, hd)
        v = split_heads(memory @ p.w_v, K, hd)
        out = flash_attention(q, k, v, causal=False, scale=hd ** -0.5)
        return merge_heads(out) @ p.w_o

    # ---------------------------------------------------------- decoder ----
    def forward(self, tokens: torch.Tensor, frame_embeds: torch.Tensor):
        """Teacher-forced pass.  Returns (logits, aux = 0).  Each encoder and
        decoder layer runs under the config's ``remat`` policy
        (`maybe_remat`), as the reference's scan bodies do."""
        memory = self.encode(frame_embeds)
        x = self.embed_tokens(tokens)
        B, S, _ = x.shape
        positions = self._positions(S)
        body = maybe_remat(self._dec_layer, remat_policy(self))
        for p in self.decoder:
            x = body(p, x, positions, memory)
        return self.logits(x), torch.zeros((), dtype=F32, device=self.device)

    def _dec_layer(self, p, x: torch.Tensor, positions: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = constrain(x + attention(p.self_attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                                    positions), ACT)
        x = constrain(x + self._cross(p.cross_attn, rms_norm(x, p.ln_x, cfg.norm_eps), memory),
                      ACT)
        return constrain(x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.act), ACT)

    # ----------------------------------------------------------- decode ----
    def cache_specs(self, B: int, cache_len: int, enc_len: int) -> dict:
        return encdec_cache_specs(self.cfg, B, cache_len, enc_len)

    def decode_step(self, cache: Dict, token: torch.Tensor, index):
        """One decoder token against the self cache (written in place) and
        the fixed cross K/V.  token (B, 1); index an int or (B,) positions.
        Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        x = self.embed_tokens(token)
        B = x.shape[0]
        index = _as_index(index)
        positions = per_seq_positions(index, B, x.device)
        lens = index + 1 if isinstance(index, int) else as_lens(index, B, x.device) + 1
        c = cache["decoder"]
        enc_len = c["xk"].shape[2]
        for i, p in enumerate(self.decoder):
            xin = rms_norm(x, p.ln1, cfg.norm_eps)
            a = p.self_attn
            q = rotary(split_heads(xin @ a.w_q, H, hd), positions, cfg.rope_theta)
            k = rotary(split_heads(xin @ a.w_k, K, hd), positions, cfg.rope_theta)
            v = split_heads(xin @ a.w_v, K, hd)
            cache_insert(c["k"][i], k, index)
            cache_insert(c["v"][i], v, index)
            h = flash_decode(q, c["k"][i], c["v"][i], lens, scale=hd ** -0.5)
            x = constrain(x + merge_heads(h) @ a.w_o, ACT)
            # cross-attention against the precomputed memory K/V (all valid)
            xq = rms_norm(x, p.ln_x, cfg.norm_eps)
            q2 = split_heads(xq @ p.cross_attn.w_q, H, hd)
            h2 = flash_decode(q2, c["xk"][i], c["xv"][i], enc_len, scale=hd ** -0.5)
            x = constrain(x + merge_heads(h2) @ p.cross_attn.w_o, ACT)
            x = constrain(x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.act), ACT)
        return self.logits(x), cache

    def decode_cache(self, xk: torch.Tensor, xv: torch.Tensor, cache_len: int) -> Dict:
        """The decode cache over cross K/V from `build_cross_cache`: a zero
        self cache of ``cache_len`` positions beside them (not copied)."""
        L, B, _, K, hd = xk.shape
        names = ("layers", "batch", "kv_len", "kv_heads_cache", None)
        k, v = (zeros((L, B, cache_len, K, hd), names, xk.dtype, xk.device, like=xk)
                for _ in range(2))
        return {"decoder": {"k": k, "v": v, "xk": xk, "xv": xv}}

    def build_cross_cache(self, memory: torch.Tensor):
        """Each decoder layer's cross K/V of the memory (B, Sm, d): (xk, xv),
        each (L, B, Sm, K, hd)."""
        cfg = self.cfg
        B, Sm, _ = memory.shape
        K, hd = cfg.n_kv_heads, cfg.head_dim
        xk = torch.stack([split_heads(memory @ p.cross_attn.w_k, K, hd)
                          for p in self.decoder])
        xv = torch.stack([split_heads(memory @ p.cross_attn.w_v, K, hd)
                          for p in self.decoder])
        return xk, xv
