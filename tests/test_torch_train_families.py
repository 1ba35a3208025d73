"""Port parity: training of the hybrid and encoder-decoder families and of
the patch frontend, against the JAX package on the same numpy inputs.

recurrentgemma-2b, seamless-m4t-medium and internvl2-76b at their smoke
widths, on carried weights.  The JAX models run their differentiable jnp
routes (blockwise attention, `associative_scan` for the RG-LRU); the
port's CPU routes are the plain versions, which the card's
`FlashAttention` differentiates too.  The hybrid runs 64 positions
against its smoke window of 32, so the window masks part of every A
unit's scores.  Both sides run under the configs' default ``remat`` of
``block`` (the JAX default the port's config copies).

Tolerances, as tests/test_torch_train.py: gradients within 1e-4 of each
leaf's max |g| in fp32 and 2e-2 in bf16; losses within rtol 1e-5 (fp32)
and 2e-2 (bf16); the train step's losses and grad norms within rtol 1e-4
and the parameters within 2 x the sum of the steps' lr.  The patch
frontend's forward logits within atol/rtol 1e-4 (fp32).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serve import make_prefill_step as j_make_prefill_step
from repro.train.train_step import loss_fn as j_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.carry import lm_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.launch import train
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.serve import make_prefill_step
from repro_torch.train import loss_and_grads, loss_fn, make_train_step
from test_torch_train import (as_torch, assert_grads_close, batch, f32, family_pair,
                              j_opt_state)

ARCHS = ["recurrentgemma_2b", "seamless_m4t_medium", "internvl2_76b"]
SEQ = {"recurrentgemma_2b": 64, "seamless_m4t_medium": 16, "internvl2_76b": 12}


def with_frontend(b, jcfg, dtype, seed=7):
    """``b`` with the arch's stub frontend input: ``frames`` (B, S, d) for
    the encoder-decoder, ``embeds`` (B, n_frontend_tokens, d) for the patch
    frontend, seeded normals in the model's dtype (as numpy float32)."""
    B, S = b["tokens"].shape
    rng = np.random.default_rng(seed)
    b = dict(b)
    if jcfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    if jcfg.frontend == "patch_stub":
        b["embeds"] = rng.normal(size=(B, jcfg.n_frontend_tokens, jcfg.d_model)
                                 ).astype(np.float32)
    return b


def to_jax(b, dtype):
    """The batch for JAX: the frontend inputs in the model's dtype."""
    return {k: jnp.asarray(v, dtype if k in ("frames", "embeds") else None)
            for k, v in b.items()}


def to_port(b, dtype):
    out = as_torch(b)
    for k in ("frames", "embeds"):
        if k in out:
            out[k] = out[k].to(getattr(torch, dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_gradients_match_jax_grad(arch, dtype):
    """Every leaf against `jax.grad`: the hybrid's R and A units (the
    window binding), the encoder, the decoder's self and cross attention,
    the patch frontend's backbone with the loss on the text positions."""
    jcfg, jm, jp, tm = family_pair(arch, dtype, seed=3)
    b = with_frontend(batch(2, SEQ[arch], seed=4), jcfg, dtype)
    jb = to_jax(b, dtype)
    (jloss, _), want = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, jcfg), has_aux=True)(jp)
    tm.requires_grad_(True)
    loss, metrics, got = loss_and_grads(tm, to_port(b, dtype), tm.cfg)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    assert float(metrics["aux"]) == 0.0
    assert_grads_close(got, want, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("arch,n_micro,compression", [
    ("recurrentgemma_2b", 2, "bf16"), ("seamless_m4t_medium", 2, "int8"),
    ("internvl2_76b", 2, "bf16")])
def test_family_train_step_matches_jax(arch, n_micro, compression):
    """3 steps from the same weights, state and batches, the frontend
    inputs split into microbatches with the tokens: losses, grad norms and
    parameters as tests/test_torch_train.py holds the dense family's."""
    jcfg, jm, jp, tm = family_pair(arch, seed=5)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, grad_compression=compression)
    jstep = jax.jit(j_make_train_step(jm, jcfg, JAdamWConfig(**kw), n_micro))
    tstep = make_train_step(tm, tm.cfg, AdamWConfig(**kw), n_micro)
    jo = j_opt_state(jp)
    to = opt_state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jo), "cpu")
    lrs = 0.0
    for step in range(3):
        b = with_frontend(batch(4, SEQ[arch] // 2, seed=10 + step), jcfg, "float32",
                          seed=20 + step)
        jp, jo, jm_ = jstep(jp, jo, to_jax(b, "float32"))
        to, tm_ = tstep(to, to_port(b, "float32"))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]), rtol=1e-4,
                                       err_msg=key)
        lrs += float(jm_["lr"])
    got = lm_params_to_numpy(tm)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp), tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2 * lrs, err_msg=str(path))
        assert np.mean(np.abs(g - np.asarray(w)) > 1e-5) < 1e-3, path
    assert int(opt_state_to_numpy(to)["step"]) == 3


# ------------------------------------------------------- patch frontend ----

def test_patch_frontend_forward_loss_and_prefill_match_jax():
    """internvl2-76b's smoke config: the forward over the embeddings and the
    tokens, the loss on the text positions only, and the prefill step's
    last-position logits, against JAX."""
    jcfg, jm, jp, tm = family_pair("internvl2_76b", seed=2)
    b = with_frontend(batch(2, 10, seed=3), jcfg, "float32")
    n_img = jcfg.n_frontend_tokens
    want, _ = jm.forward(jp, jnp.asarray(b["tokens"]), embeds=jnp.asarray(b["embeds"]))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(b["tokens"]), embeds=torch.from_numpy(b["embeds"]))
        assert got.shape == (2, n_img + 10, jcfg.vocab) and float(aux) == 0.0
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-4)
        jl, _ = j_loss_fn(jm, jp, to_jax(b, "float32"), jcfg)
        tl, _ = loss_fn(tm, as_torch(b), tm.cfg)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        # the embeddings reach the text positions' loss
        no_img, _ = loss_fn(tm, {k: v for k, v in as_torch(b).items() if k != "embeds"},
                            tm.cfg)
        assert abs(float(no_img) - float(tl)) > 1e-6
        step = make_prefill_step(tm, tm.cfg)
        last = step(torch.from_numpy(b["tokens"]), torch.from_numpy(b["embeds"]))
    jlast = j_make_prefill_step(jm, jcfg)(jp, jnp.asarray(b["tokens"]),
                                          jnp.asarray(b["embeds"]))
    assert last.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(f32(last), f32(jlast), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(f32(last), f32(got[:, -1:]))


def test_patch_embeds_take_the_activations_dtype():
    """fp32 embeddings into a bf16 model are cast, as the JAX forward does."""
    cfg = get_smoke_config("internvl2-76b")
    model, _ = train.build_state(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    embeds = torch.randn(1, cfg.n_frontend_tokens, cfg.d_model)
    with torch.no_grad():
        a, _ = model(tokens, embeds=embeds)
        b, _ = model(tokens, embeds=embeds.to(torch.bfloat16))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# -------------------------------------------------------------- driver ----

def jax_driver_inputs(cfg, step, B, S):
    """The frontend inputs as `repro.launch.train` draws them (its lines for
    ``embeds`` and ``frames``), as bf16 bit patterns."""
    out = {}
    if cfg.frontend == "patch_stub":
        rng = np.random.default_rng(step)
        out["embeds"] = jnp.asarray(rng.normal(size=(B, cfg.n_frontend_tokens, cfg.d_model)),
                                    jnp.bfloat16)
    if cfg.family == "encdec":
        rng = np.random.default_rng(step)
        out["frames"] = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jnp.bfloat16)
    return {k: np.asarray(v).view(np.uint16) for k, v in out.items()}


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-76b", "recurrentgemma-2b"])
def test_driver_frontend_inputs_are_the_jax_drivers(arch):
    """`launch.train.frontend_inputs` bit for bit against the JAX driver's
    draws, at two steps and two batch shapes."""
    cfg = get_smoke_config(arch)
    for step, (B, S) in ((0, (8, 128)), (7, (4, 32))):
        got = train.frontend_inputs(cfg, step, torch.zeros((B, S), dtype=torch.int64))
        want = jax_driver_inputs(cfg, step, B, S)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16), w)


def test_driver_rounds_float64_draws_as_jax_does():
    """JAX without x64 takes a float64 array to float32 before bfloat16:
    a value just above a bf16 rounding tie in float64 that float32 rounds
    onto the tie goes to the even neighbour.  The driver rounds the same
    way."""
    x = np.array([1.0 + 2.0 ** -8 + 2.0 ** -30, -(1.0 + 2.0 ** -8 + 2.0 ** -30)])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    assert float(got[0]) == 1.0  # the tie went to the even neighbour
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "seamless-m4t-medium",
                                  "internvl2-76b"])
def test_cpu_driver_trains_and_starts_at_the_jax_loss(arch):
    """The driver's run on the CPU (2 microbatches): the loss falls, and
    its first loss is the JAX loss of the driver's own first step: its
    seed-0 weights, its pipeline's first batch and the JAX driver's
    frontend draws, within the bf16 tolerance 2e-2 (relative)."""
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "8",
                      "--seq-len", "32", "--batch", "4", "--microbatches", "2"])
    losses = out["losses"]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    cfg = get_smoke_config(arch)
    model, _ = train.build_state(cfg, device="cpu")
    pipe = DataPipeline(train.synthetic_corpus(cfg, doc_len=32 + 1 + 64, device="cpu"),
                        PipelineConfig(seq_len=32, global_batch=4))
    b = {k: jnp.asarray(v.numpy()) for k, v in pipe.get_batch(0).items()}
    pipe.stop()
    b.update({k: jnp.asarray(v.view(ml_dtypes.bfloat16))
              for k, v in jax_driver_inputs(cfg, 0, 4, 32).items()})
    jcfg = j_get_smoke_config(arch.replace("-", "_"))
    jp = jax.tree.map(lambda a: jnp.asarray(a.view(ml_dtypes.bfloat16)
                                            if a.dtype == np.uint16 else a),
                      lm_params_to_numpy(model))
    want, _ = j_loss_fn(j_build_model(jcfg), jp, b, jcfg)
    np.testing.assert_allclose(losses[0], float(want), rtol=2e-2)
