"""Port parity: the hybrid family (RG-LRU recurrent units and sliding-window
attention units, recurrentgemma-2b at smoke widths) against the JAX
package on carried weights, fp32.

The JAX model runs its default path (jnp blockwise and decode attention,
`jax.lax.associative_scan`); the port runs the plain versions of its
kernels and the doubling scan `rglru_scan`.  Tolerances: the mixers and
the scan at atol/rtol 1e-5 (fp32, sums in another order); logits and
caches through 4 layers and a tied head at 1e-4 (as tests/test_torch_lm.py);
greedy tokens exactly.  The JAX prefill steps the prompt through its
decode step; the port's runs one forward pass and must leave the same
cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve_cli
from repro.models import build_model as j_build_model
from repro.models import rglru as jrglru
from repro.models.params import init_params as j_init_params
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import make_serve_step as j_make_serve_step
from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import rglru
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Layer
from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step

TIGHT = dict(atol=1e-5, rtol=1e-5)
FP32 = dict(atol=1e-4, rtol=1e-4)
RNG = np.random.default_rng(24)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


def hybrid(seed=0, dtype="float32", **kw):
    """(JAX cfg, JAX model, JAX params, the port's model) on one set of
    weights: recurrentgemma-2b's smoke widths (an RRA repeat and an R
    tail), fp32."""
    jcfg = j_get_config("recurrentgemma_2b").scaled(
        **dict(dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
                    vocab=256, d_rnn=64, local_window=32, dtype=dtype), **kw))
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm


def layer(tree):
    """A nested dict of numpy arrays as the port's attribute-access layer."""
    return Layer({k: layer(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
                  for k, v in tree.items()})


def rglru_params(jcfg, seed):
    """One RG-LRU mixer's JAX parameters, with nonzero biases and a spread
    of decays (the init's zeros and ones would leave them untested)."""
    jp = j_init_params(jrglru.rglru_specs(jcfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    dr = jcfg.d_rnn
    jp["b_a"] = jnp.asarray(rng.normal(size=dr), jnp.float32)
    jp["b_i"] = jnp.asarray(rng.normal(size=dr), jnp.float32)
    jp["lam"] = jnp.asarray(rng.uniform(-3, 2, size=dr), jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.normal(size=dr) * 0.1, jnp.float32)
    return jp


def np_(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_rglru_scan_is_the_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t stepped in order,
    at lengths below, at and past powers of two."""
    for S in (1, 2, 7, 16, 33):
        a = torch.rand((2, S, 5), generator=torch.Generator().manual_seed(S))
        b = torch.randn((2, S, 5), generator=torch.Generator().manual_seed(S + 1))
        h, want = torch.zeros(2, 5), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rglru.rglru_scan(a, b), torch.stack(want, 1), **TIGHT)


def test_rglru_block_matches_jax():
    jcfg = hybrid()[0]
    jp = rglru_params(jcfg, 3)
    x = RNG.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    want = jrglru.rglru_block(jp, jcfg, jnp.asarray(x))
    got, h, conv = rglru.rglru_block(layer(jp), port_cfg(jcfg), torch.from_numpy(x),
                                     return_cache=True)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TIGHT)
    # the cache it leaves is the one stepping the sequence leaves
    hs = jnp.zeros((2, jcfg.d_rnn), jnp.float32)
    cs = jnp.zeros((2, jcfg.conv_width - 1, jcfg.d_rnn), jnp.float32)
    for t in range(x.shape[1]):
        _, hs, cs = jrglru.rglru_decode_step(jp, jcfg, jnp.asarray(x[:, t:t + 1]), hs, cs)
    np.testing.assert_allclose(np_(h), np.asarray(hs), **TIGHT)
    np.testing.assert_allclose(np_(conv), np.asarray(cs), **TIGHT)
    # a sequence shorter than the conv: zero rows in front of the tail
    short = rglru.rglru_block(layer(jp), port_cfg(jcfg), torch.from_numpy(x[:, :2]),
                              return_cache=True)[2]
    assert short.shape == (2, jcfg.conv_width - 1, jcfg.d_rnn)
    assert not short[:, 0].any() and torch.equal(short[:, 1:], conv.new_tensor(
        np_(torch.from_numpy(x[:, :2]) @ layer(jp).w_x)))


def test_rglru_decode_step_matches_jax():
    jcfg = hybrid()[0]
    jp = rglru_params(jcfg, 4)
    x = RNG.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    h0 = RNG.normal(size=(3, jcfg.d_rnn)).astype(np.float32)
    c0 = RNG.normal(size=(3, jcfg.conv_width - 1, jcfg.d_rnn)).astype(np.float32)
    want = jrglru.rglru_decode_step(jp, jcfg, *map(jnp.asarray, (x, h0, c0)))
    got = rglru.rglru_decode_step(layer(jp), port_cfg(jcfg), *map(torch.from_numpy, (x, h0, c0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), **TIGHT)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hybrid_params_round_trip_bit_exact(dtype):
    """The `blocks` and `tail` trees cross both ways bit for bit."""
    _, _, jp, tm = hybrid(dtype=dtype)
    want = jax.tree.map(np.asarray, jp)
    got = lm_params_to_numpy(tm)
    assert set(got) == set(want) == {"embed", "final_norm", "blocks", "tail"}
    assert set(got["blocks"]) == {"a", "b", "c"} and set(got["tail"]) == {"a"}
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[path]
        bits = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(g, bits, err_msg=str(path))
    again = lm_params_to_numpy(lm_params_from_numpy(tm.cfg, got, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, again, got)


def test_hybrid_forward_matches_jax():
    jcfg, jm, jp, tm = hybrid(seed=1)
    tok = RNG.integers(0, jcfg.vocab, size=(2, 45)).astype(np.int32)  # past the window
    want, _ = jm.forward(jp, jnp.asarray(tok))
    got, aux = tm(torch.from_numpy(tok))
    np.testing.assert_allclose(np_(got), np.asarray(want), **FP32)
    assert float(aux) == 0.0


@pytest.mark.parametrize("S,cache_len", [(40, 48), (30, 24), (5, 16)])
def test_hybrid_prefill_cache_matches_jax(S, cache_len):
    """The port's one-pass prefill leaves the cache and the last logits of
    the JAX prefill, which steps the prompt: with the window rotated
    (40 > 32), with a cache shorter than the window (wlen 24 < 32) and
    with a prompt shorter than both."""
    jcfg, jm, jp, tm = hybrid(seed=2)
    tok = RNG.integers(0, jcfg.vocab, size=(2, S)).astype(np.int32)
    want_lg, want_c = jm.prefill(jp, jnp.asarray(tok), cache_len)
    got_lg, got_c = make_prefill_step(tm, tm.cfg)(torch.from_numpy(tok), cache_len=cache_len)
    np.testing.assert_allclose(np_(got_lg), np.asarray(want_lg), **FP32)
    want_flat = jax.tree_util.tree_leaves_with_path(want_c)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np_, got_c)))
    assert len(want_flat) == len(got_flat) == 8  # a, b, tail a: h, conv; c: k, v
    for path, w in want_flat:
        np.testing.assert_allclose(got_flat[path], np.asarray(w), err_msg=str(path), **FP32)
    assert got_c["blocks"]["c"]["k"].shape[2] == min(32, cache_len)


def test_hybrid_decode_matches_jax():
    """Prefill then greedy steps through the serving steps: the same
    tokens as the JAX steps, and logits within 1e-4 at each."""
    jcfg, jm, jp, tm = hybrid(seed=3)
    B, S, gen = 3, 28, 12  # the steps rotate the window of 32
    tok = RNG.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    j_step = jax.jit(j_make_serve_step(jm, jcfg))
    lg, jc = jm.prefill(jp, jnp.asarray(tok), S + gen)
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    prefill, step = make_prefill_step(tm, tm.cfg), make_serve_step(tm, tm.cfg)
    tlg, tc = prefill(torch.from_numpy(tok), cache_len=S + gen)
    tnxt = torch.argmax(tlg[:, -1:], dim=-1).to(torch.int32)
    for i in range(gen):
        np.testing.assert_array_equal(np_(tnxt), np.asarray(nxt))
        nxt, jlog, jc = j_step(jp, jc, nxt, jnp.int32(S + i))
        tnxt, tlog, tc = step(tc, tnxt, S + i)
        np.testing.assert_allclose(np_(tlog), np.asarray(jlog), **FP32)


def test_hybrid_per_seq_index():
    """Vector positions equal the scalar position where they agree, and a
    batch of sequences at different positions equals each alone."""
    jcfg, jm, jp, tm = hybrid(seed=4, local_window=8)
    cache = serve_cli.zero_cache(tm, tm.cfg, 2, 16)
    tok = torch.tensor([[5], [9]])
    lg_s, _ = tm.decode_step({k: jax.tree.map(torch.clone, v) for k, v in cache.items()},
                             tok, 0)
    lg_v, _ = tm.decode_step(cache, tok, torch.tensor([0, 0]))
    torch.testing.assert_close(lg_s, lg_v, **TIGHT)
    # the JAX model's vector-index step on the same weights
    jcache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                          jax.tree.map(np_, serve_cli.zero_cache(tm, tm.cfg, 2, 16)))
    jlg, _ = jm.decode_step(jp, jcache, jnp.asarray([[5], [9]]), jnp.asarray([0, 0]))
    np.testing.assert_allclose(np_(lg_v), np.asarray(jlg), **FP32)


def solo_decode(model, prompt, max_new, cache_len):
    cache = serve_cli.zero_cache(model, model.cfg, 1, cache_len)
    out, tok = [], prompt[0]
    for pos in range(len(prompt) + max_new - 1):
        logits, cache = model.decode_step(cache, torch.tensor([[tok]]), pos)
        nxt = int(torch.argmax(logits[0, -1]))
        if pos + 1 < len(prompt):
            tok = prompt[pos + 1]
        else:
            out.append(nxt)
            tok = nxt
    return out


def test_hybrid_continuous_batching_matches_jax():
    """The batcher's per-slot reset of h, conv and the rotating window:
    the JAX batcher's tokens, request for request, and each request's
    tokens decoded alone (window 8 < the requests' lengths)."""
    jcfg, jm, jp, tm = hybrid(seed=5, local_window=8)
    prompts = [RNG.integers(0, jcfg.vocab, size=n).tolist() for n in (3, 9, 12, 4)]
    jeng = JBatcher(jm, jcfg, jp, n_slots=2, cache_len=24)
    teng = ContinuousBatcher(tm, tm.cfg, n_slots=2, cache_len=24, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid, p, 6))
        teng.submit(Request(rid, p, 6))
    want, got = jeng.run(), teng.run()
    assert got == want
    assert teng.occupancy == jeng.occupancy > 0.5
    for rid, p in enumerate(prompts):
        assert got[rid] == solo_decode(tm, p, 6, 24)


def test_serve_driver_tokens_match_jax(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke
    --device cpu` on the JAX driver's weights (seed 0) serves the JAX
    driver's tokens."""
    args = ["--arch", "recurrentgemma-2b", "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "6"]
    want = np.asarray(j_serve_cli.main(args))
    jcfg = j_get_config("recurrentgemma_2b")
    from repro.configs import get_smoke_config as j_smoke
    jcfg = j_smoke("recurrentgemma-2b")
    jp = j_init_params(j_build_model(jcfg).specs(), jax.random.key(0))
    monkeypatch.setattr(serve_cli, "build_model", lambda cfg, device: lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device))
    got = serve_cli.main(args + ["--device", "cpu"])
    assert "on CPU" in capsys.readouterr().out
    np.testing.assert_array_equal(got.numpy(), want)
