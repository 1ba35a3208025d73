"""Port parity: arctic-480b (128-expert top-2 MoE with the dense residual
MLP) at its smoke widths, against the JAX package on the same numpy
inputs, with weights carried by `carry.lm_params_from_numpy`.

The forward logits, the prefill's cache and the decode step's logits
(fp32, atol/rtol 1e-4), the loss and every leaf's gradient against
`jax.grad` (within 1e-4 of each leaf's max |g| in fp32, 2e-2 in bf16; the
router's aux loss in the loss), three train steps against the JAX step
(losses and grad norms within rtol 1e-4, parameters within 2 x the sum of
the steps' lr), the CPU driver's run (the loss falls) and a restart that
ends bit-equal to the run without the failure.  The tolerances are
tests/test_torch_train.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.train_step import loss_fn as j_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.carry import lm_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy
from repro_torch.launch import train
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_prefill_step, make_serve_step
from repro_torch.train import loss_and_grads, make_train_step
from test_torch_ckpt import assert_same_bits
from test_torch_train import (as_torch, assert_grads_close, batch, f32, family_pair,
                              j_grads, j_opt_state)

ARCH = "arctic_480b"


def test_arctic_smoke_config_is_the_jax_one():
    from repro.configs import get_smoke_config as j_get_smoke_config
    from repro_torch.configs import get_smoke_config
    from test_torch_lm import port_cfg

    assert port_cfg(j_get_smoke_config(ARCH)) == get_smoke_config("arctic-480b")
    cfg = get_smoke_config("arctic-480b")
    assert cfg.moe_dense_residual and cfg.n_experts == 8 and cfg.top_k == 2


def test_forward_prefill_and_decode_match_jax():
    jcfg, jm, jp, tm = family_pair(ARCH, seed=2)
    toks = batch(2, 12, seed=3)["tokens"]
    want, jaux = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(toks))
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        logits, cache = make_prefill_step(tm, tm.cfg)(torch.from_numpy(toks), cache_len=16)
        np.testing.assert_allclose(f32(logits), f32(want[:, -1:]), atol=1e-4, rtol=1e-4)
        prefilled = {k: v.clone() for k, v in cache["blocks"].items()}  # decode writes in place
        nxt, dec, cache = make_serve_step(tm, tm.cfg)(cache, torch.from_numpy(toks[:, :1]), 12)
    # JAX's prefill and decode step (a token's own dispatch: its capacity
    # is that of one token a sequence)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(toks), cache_len=16)
    np.testing.assert_allclose(f32(logits), f32(jlogits), atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(prefilled[name]), f32(jcache["blocks"][name]),
                                   atol=1e-4, rtol=1e-4)
    want_dec, _ = jm.decode_step(jp, jcache, jnp.asarray(toks[:, :1]), 12)
    np.testing.assert_allclose(f32(dec), f32(want_dec), atol=1e-4, rtol=1e-4)
    assert torch.equal(nxt, torch.argmax(dec[:, -1:], -1).to(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(dtype):
    """Every leaf: the experts, the router, the dense residual MLP, the
    attention, the untied head."""
    jcfg, jm, jp, tm = family_pair(ARCH, dtype, seed=3)
    b = batch(2, 16, seed=4)
    want = j_grads(jm, jp, b, jcfg)
    tm.requires_grad_(True)
    loss, metrics, got = loss_and_grads(tm, as_torch(b), tm.cfg)
    jloss, jmetrics = j_loss_fn(jm, jp, jax.tree.map(jnp.asarray, b), jcfg)
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), rtol=rtol)
    assert float(metrics["aux"]) > 0
    assert_grads_close(got, want, 1e-4 if dtype == "float32" else 2e-2)


def test_train_step_matches_jax():
    jcfg, jm, jp, tm = family_pair(ARCH, seed=5)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, grad_compression="bf16")
    jstep = jax.jit(j_make_train_step(jm, jcfg, JAdamWConfig(**kw), 2))
    tstep = make_train_step(tm, tm.cfg, AdamWConfig(**kw), 2)
    jo = j_opt_state(jp)
    to = opt_state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jo), "cpu")
    lrs = 0.0
    for step in range(3):
        b = batch(4, 12, seed=10 + step)
        jp, jo, jm_ = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        to, tm_ = tstep(to, as_torch(b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]), rtol=1e-4,
                                       err_msg=key)
        lrs += float(jm_["lr"])
    got = lm_params_to_numpy(tm)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp), tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2 * lrs, err_msg=str(path))
    assert int(opt_state_to_numpy(to)["step"]) == 3


RUN = ["--arch", "arctic-480b", "--smoke", "--device", "cpu", "--steps", "10",
       "--seq-len", "16", "--batch", "2"]


def test_cpu_driver_trains_and_restarts_bit_equal(tmp_path):
    """The driver's run (the loss falls), and ``--ckpt-every 5
    --inject-failure-at 8`` against it: the replay, and the final state bit
    for bit."""
    plain = train.main(RUN)
    losses = plain["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    out = train.main(RUN + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "5",
                            "--inject-failure-at", "8"])
    assert out["recoveries"] == [dict(failed_step=8, worker=0, restored_to=5, lost_steps=3)]
    assert out["losses"][:8] == losses[:8] and out["losses"][8:] == losses[5:]
    assert_same_bits(out["state"], plain["state"])
