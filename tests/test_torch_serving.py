"""Port parity: serving steps, the continuous batcher and the serve driver.

Greedy decoding is deterministic, so in fp32 the port must serve exactly
the JAX package's tokens on the same weights, request for request
(the setup of `tests/test_serving.py:49`, dense arch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import make_serve_step as j_make_serve_step
from repro_torch.carry import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                               make_serve_step)

RNG = np.random.default_rng(7)


def small(arch="minitron_8b", seed=0, **kw):
    """JAX cfg, model, params and the port's model on the same weights."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=97, dtype="float32", use_flash_kernel=True,
                use_flash_decode=True)
    base.update(kw)
    jcfg = j_get_config(arch).scaled(**base)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    return jcfg, jm, jp, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def solo_decode(model, prompt, max_new, cache_len):
    """One request alone through the port's decode_step (B = 1)."""
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


@pytest.mark.parametrize("arch", ["minitron_8b", "smollm_135m"])
def test_continuous_batching_matches_jax(arch):
    jcfg, jm, jp, tm = small(arch)
    prompts = [RNG.integers(0, jcfg.vocab, size=n).tolist() for n in (3, 5, 8, 4)]
    jeng = JBatcher(jm, jcfg, jp, n_slots=2, cache_len=32)
    teng = ContinuousBatcher(tm, tm.cfg, n_slots=2, cache_len=32, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid, p, 6))
        teng.submit(Request(rid, p, 6))
    want, got = jeng.run(), teng.run()
    assert got == want
    assert teng.occupancy == jeng.occupancy > 0.5
    # and each request as if it had been decoded alone
    for rid, p in enumerate(prompts):
        assert got[rid] == solo_decode(tm, p, 6, 32)


def test_continuous_batching_eos_frees_slot():
    _, _, _, tm = small(seed=1)
    probe = [5, 11, 23]
    first = solo_decode(tm, probe, 1, 32)[0]
    eng = ContinuousBatcher(tm, tm.cfg, n_slots=1, cache_len=32, device="cpu")
    eng.submit(Request(0, probe, max_new=8, eos_id=first))
    eng.submit(Request(1, [4, 2], max_new=2))
    got = eng.run()
    assert got[0] == [first]            # stopped at EOS, not max_new
    assert len(got[1]) == 2             # the queued request got the slot
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(Request(2, [1] * 30, max_new=8))


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_then_serve_steps_match_jax(fused):
    jcfg, jm, jp, tm = small("smollm_135m", seed=2, fused_prefill_kv=fused)
    B, S, gen = 3, 10, 6
    tok = RNG.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    j_step = jax.jit(j_make_serve_step(jm, jcfg))
    lg, jc = jm.prefill(jp, jnp.asarray(tok), cache_len=S + gen)
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    want = [np.asarray(nxt)]
    for i in range(gen - 1):
        nxt, _, jc = j_step(jp, jc, nxt, jnp.int32(S + i))
        want.append(np.asarray(nxt))

    prefill, step = make_prefill_step(tm, tm.cfg), make_serve_step(tm, tm.cfg)
    lg, tc = prefill(torch.from_numpy(tok), cache_len=S + gen)
    assert tc["blocks"]["k"].shape == (2, B, S + gen, 2, jcfg.head_dim)
    nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    got = [nxt.numpy()]
    for i in range(gen - 1):
        nxt, logits, tc = step(tc, nxt, S + i)
        assert nxt.dtype == torch.int32 and logits.shape == (B, 1, jcfg.vocab)
        got.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))


def test_prefill_step_defaults_to_prompt_length():
    _, _, _, tm = small("smollm_135m")
    lg, cache = make_prefill_step(tm, tm.cfg)(torch.zeros((2, 7), dtype=torch.int32))
    assert lg.shape == (2, 1, 97) and cache["blocks"]["v"].shape[2] == 7


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_driver_runs_on_cpu(continuous, capsys):
    args = ["--arch", "smollm-135m", "--smoke", "--batch", "2",
            "--prompt-len", "6", "--gen", "6", "--device", "cpu"]
    out = serve_cli.main(args + (["--continuous"] if continuous else []))
    text = capsys.readouterr().out
    assert "on CPU" in text and "smoke scale" not in text
    if continuous:
        assert len(out) == 5 and all(len(v) == 6 for v in out.values())
    else:
        assert out.shape == (2, 6) and out.dtype == torch.int32
