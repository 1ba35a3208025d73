"""Port parity: the encoder-decoder family (seamless-m4t-medium at smoke
widths) against the JAX package on carried weights, fp32.

The JAX model runs its default path (jnp blockwise attention for the
encoder and the cross-attention, jnp decode attention); the port runs the
plain versions of `flash_attention` (``causal=False``) and `flash_decode`.
Tolerances: the encoder's memory, the cross K/V and logits at atol/rtol
1e-4 (fp32 through 2 + 2 layers and a tied head, as
tests/test_torch_lm.py); greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as j_serve_cli
from repro.models import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.serve import make_prefill_step as j_make_prefill_step
from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serve import make_prefill_step, make_serve_step

FP32 = dict(atol=1e-4, rtol=1e-4)
RNG = np.random.default_rng(25)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


def encdec(seed=0, dtype="float32", **kw):
    """(JAX cfg, JAX model, JAX params, the port's model) on one set of
    weights at seamless-m4t-medium's smoke widths."""
    jcfg = j_smoke("seamless_m4t_medium").scaled(dtype=dtype, **kw)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm


def frames(B, T, d):
    return RNG.normal(size=(B, T, d)).astype(np.float32)


def np_(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_config_and_model_class():
    cfg = get_smoke_config("seamless-m4t-medium")
    assert cfg == port_cfg(j_smoke("seamless_m4t_medium"))
    assert isinstance(build_model(cfg, device="cpu"), EncDecLM)
    with pytest.raises(ValueError, match="family"):
        EncDecLM(get_smoke_config("smollm-135m"), device="cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encdec_params_round_trip_bit_exact(dtype):
    """The ``encoder`` and ``decoder`` trees cross both ways bit for bit."""
    _, _, jp, tm = encdec(dtype=dtype)
    want = jax.tree.map(np.asarray, jp)
    got = lm_params_to_numpy(tm)
    assert set(got) == set(want) == {"embed", "enc_final_norm", "final_norm", "encoder",
                                     "decoder"}
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        bits = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(flat_g[path], bits, err_msg=str(path))
    again = lm_params_to_numpy(lm_params_from_numpy(tm.cfg, got, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, again, got)


def test_encode_and_cross_cache_match_jax():
    jcfg, jm, jp, tm = encdec(seed=1)
    fr = frames(2, 24, jcfg.d_model)
    want = jm.encode(jp, jnp.asarray(fr))
    got = tm.encode(torch.from_numpy(fr))
    np.testing.assert_allclose(np_(got), np.asarray(want), **FP32)
    jxk, jxv = jm.build_cross_cache(jp, want)
    xk, xv = tm.build_cross_cache(got)
    np.testing.assert_allclose(np_(xk), np.asarray(jxk), **FP32)
    np.testing.assert_allclose(np_(xv), np.asarray(jxv), **FP32)
    assert xk.shape == (jcfg.n_dec_layers, 2, 24, jcfg.n_kv_heads, jcfg.head_dim)


@pytest.mark.parametrize("S,T", [(10, 24), (24, 10)])
def test_forward_matches_jax(S, T):
    """Teacher-forced logits, with more frames than tokens and fewer (the
    cross-attention's queries outnumber its keys)."""
    jcfg, jm, jp, tm = encdec(seed=2)
    tok = RNG.integers(0, jcfg.vocab, size=(2, S)).astype(np.int32)
    fr = frames(2, T, jcfg.d_model)
    want, _ = jm.forward(jp, jnp.asarray(tok), jnp.asarray(fr))
    got, aux = tm(torch.from_numpy(tok), torch.from_numpy(fr))
    np.testing.assert_allclose(np_(got), np.asarray(want), **FP32)
    assert float(aux) == 0.0


def test_prefill_step_then_decode_matches_jax():
    """`make_prefill_step` on frames (encode, then the cross K/V), then
    greedy decode from one BOS token: the JAX steps' memory, cross cache,
    logits and tokens."""
    jcfg, jm, jp, tm = encdec(seed=3)
    B, T, gen, bos = 3, 20, 10, 1
    fr = frames(B, T, jcfg.d_model)
    jlast, (jxk, jxv) = j_make_prefill_step(jm, jcfg)(jp, jnp.asarray(fr))
    last, (xk, xv) = make_prefill_step(tm, tm.cfg)(torch.from_numpy(fr))
    np.testing.assert_allclose(np_(last), np.asarray(jlast), **FP32)
    np.testing.assert_allclose(np_(xk), np.asarray(jxk), **FP32)
    _, cache = make_prefill_step(tm, tm.cfg)(torch.from_numpy(fr), cache_len=gen + 1)
    assert cache["decoder"]["k"].shape == (2, B, gen + 1, 4, 16) and not cache["decoder"]["k"].any()
    jcache = {"decoder": {"k": jnp.zeros((2, B, gen + 1, 4, 16)),
                          "v": jnp.zeros((2, B, gen + 1, 4, 16)), "xk": jxk, "xv": jxv}}
    step = make_serve_step(tm, tm.cfg)
    jtok = jnp.full((B, 1), bos, jnp.int32)
    tok = torch.full((B, 1), bos, dtype=torch.int32)
    for i in range(gen):
        jlg, jcache = jm.decode_step(jp, jcache, jtok, jnp.int32(i))
        jtok = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
        tok, lg, cache = step(cache, tok, i)
        np.testing.assert_allclose(np_(lg), np.asarray(jlg), **FP32)
        np.testing.assert_array_equal(np_(tok), np.asarray(jtok))


def test_encdec_per_seq_index():
    """Vector positions equal the scalar position where they agree, on
    the JAX case's setup (tests/test_serving.py:122), and equal the JAX
    model's vector-position step."""
    jcfg, jm, jp, tm = encdec(seed=5)
    mem = RNG.normal(size=(2, 8, jcfg.d_model)).astype(np.float32)
    xk, xv = tm.build_cross_cache(torch.from_numpy(mem))
    jxk, jxv = jm.build_cross_cache(jp, jnp.asarray(mem))
    cache = tm.decode_cache(xk, xv, 12)
    jcache = {"decoder": {"k": jnp.zeros((2, 2, 12, 4, 16)), "v": jnp.zeros((2, 2, 12, 4, 16)),
                          "xk": jxk, "xv": jxv}}
    for i in range(3):  # fill positions 0-2 identically
        t = np.asarray([[i + 1], [i + 7]], np.int32)
        tm.decode_step(cache, torch.from_numpy(t), i)
        _, jcache = jm.decode_step(jp, jcache, jnp.asarray(t), jnp.int32(i))
    tok = np.asarray([[5], [9]], np.int32)
    snapshot = {k: v.clone() for k, v in cache["decoder"].items()}
    lg_s, _ = tm.decode_step(cache, torch.from_numpy(tok), 3)
    lg_v, _ = tm.decode_step({"decoder": snapshot}, torch.from_numpy(tok), torch.tensor([3, 3]))
    torch.testing.assert_close(lg_s, lg_v, atol=1e-5, rtol=1e-5)
    jlg, _ = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray([3, 3], jnp.int32))
    np.testing.assert_allclose(np_(lg_v), np.asarray(jlg), **FP32)


def test_serve_driver_tokens_match_jax(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --arch seamless-m4t-medium --smoke
    --device cpu` on the JAX driver's weights (seed 0) serves the JAX
    driver's tokens: the decoder stepped over the prompt against an
    all-zero cross cache of ``cache_len`` positions, as the JAX driver
    does."""
    args = ["--arch", "seamless-m4t-medium", "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "6"]
    want = np.asarray(j_serve_cli.main(args))
    jp = j_init_params(j_build_model(j_smoke("seamless-m4t-medium")).specs(),
                       jax.random.key(0))
    monkeypatch.setattr(serve_cli, "build_model", lambda cfg, device: lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device))
    got = serve_cli.main(args + ["--device", "cpu"])
    assert "on CPU" in capsys.readouterr().out
    np.testing.assert_array_equal(got.numpy(), want)
    cache = serve_cli.zero_cache(build_model(get_smoke_config("seamless-m4t-medium"),
                                             device="cpu"),
                                 get_smoke_config("seamless-m4t-medium"), 2, 12)
    assert cache["decoder"]["xk"].shape[2] == 12 and not cache["decoder"]["xk"].any()
