"""Port parity: activation recompute (`models.layers.maybe_remat`) under
the reference's three policies, against the JAX package's `maybe_remat`.

Each family's smoke model (smollm-135m, granite-moe-1b-a400m,
mamba2-370m, recurrentgemma-2b, seamless-m4t-medium) in fp32 on carried
weights, under ``none``, ``block`` and ``dots`` on both sides: forward
logits within atol/rtol 1e-4 (tests/test_torch_lm.py's), the loss within
rtol 1e-5 and every gradient within 1e-4 of the leaf's max |g|
(tests/test_torch_train.py's).  A policy changes what autograd keeps, not
what it computes: the port's gradients under ``block`` and ``dots`` are
bit-equal to those under ``none``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.train_step import loss_fn as j_loss_fn
from repro_torch.kernels.flash_attention.ops import FlashAttention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models.layers import maybe_remat
from repro_torch.models.params import tree_leaves
from repro_torch.train import loss_and_grads
from test_torch_train import as_torch, assert_grads_close, batch, f32, family_pair

FAMILIES = ["smollm_135m", "granite_moe_1b_a400m", "mamba2_370m", "recurrentgemma_2b",
            "seamless_m4t_medium"]
SEQ = {"mamba2_370m": 32, "recurrentgemma_2b": 48}
POLICIES = ["none", "block", "dots"]


def family_batch(jcfg, arch, seed=4):
    b = batch(2, SEQ.get(arch, 16), seed=seed)
    if jcfg.family == "encdec":
        rng = np.random.default_rng(seed)
        b["frames"] = rng.normal(size=b["tokens"].shape + (jcfg.d_model,)).astype(np.float32)
    return b


def forward(model, b):
    tokens = torch.from_numpy(b["tokens"])
    if "frames" in b:
        return model(tokens, torch.from_numpy(b["frames"]))
    return model(tokens)


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_policy_matches_jax(arch, remat):
    """Forward values and gradients under one policy on both sides."""
    jcfg, jm, jp, tm = family_pair(arch, seed=6, remat=remat)
    assert tm.cfg.remat == remat
    b = family_batch(jcfg, arch)
    jb = jax.tree.map(jnp.asarray, b)
    if jcfg.family == "encdec":
        want_logits, _ = jm.forward(jp, jb["tokens"], jb["frames"])
    else:
        want_logits, _ = jm.forward(jp, jb["tokens"])
    (jloss, _), want = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, jcfg), has_aux=True)(jp)
    tm.requires_grad_(True)
    logits, _ = forward(tm, b)
    np.testing.assert_allclose(f32(logits), f32(want_logits), atol=1e-4, rtol=1e-4)
    loss, _, got = loss_and_grads(tm, as_torch(b), tm.cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_grads_close(got, want, 1e-4)
    if remat != "none":
        _, _, _, plain = family_pair(arch, seed=6, remat="none")
        plain.requires_grad_(True)
        _, _, ref = loss_and_grads(plain, as_torch(b), plain.cfg)
        for g, r in zip(tree_leaves(got), tree_leaves(ref)):
            assert torch.equal(g, r)


@pytest.fixture
def counted_attention(monkeypatch):
    """The models' attention through `FlashAttention` (the card's route)
    with the plain version as its forward, counting the forward's runs."""
    calls = []

    def forward(*args, **kw):
        calls.append(kw)
        return flash_attention_ref(*args, **kw)

    def attention(q, k, v, *, causal=True, scale=None, window=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return FlashAttention.apply(q, k, v, causal, scale, window, forward)

    monkeypatch.setattr(attn_mod, "flash_attention", attention)
    monkeypatch.setattr(encdec_mod, "flash_attention", attention)
    return calls


@pytest.mark.parametrize("arch,per_pass", [
    ("smollm_135m", 2), ("recurrentgemma_2b", 1), ("seamless_m4t_medium", 6)])
@pytest.mark.parametrize("remat", POLICIES)
def test_recompute_runs_each_attention_forward_again(counted_attention, arch, per_pass,
                                                     remat):
    """Under ``block`` and ``dots`` every layer's attention forward runs
    once in the forward and once more in the backward's recompute (the
    smoke models: 2 dense layers; 1 A unit in RRAR; 2 encoder layers and 2
    decoder layers of self and cross attention); under ``none`` once.
    `FlashAttention`'s own backward runs once a call either way.  Without
    autograd (the serving paths) no policy recomputes anything."""
    jcfg, _, _, tm = family_pair(arch, seed=1, remat=remat)
    b = family_batch(jcfg, arch)
    with torch.no_grad():
        forward(tm, b)
    assert len(counted_attention) == per_pass
    tm.requires_grad_(True)
    forward(tm, b)  # autograd records, nothing differentiates it
    counted_attention.clear()
    loss, _, grads = loss_and_grads(tm, as_torch(b), tm.cfg)
    assert len(counted_attention) == per_pass * (1 if remat == "none" else 2)
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


def test_maybe_remat_is_inert_without_autograd():
    calls = []

    def fn(x, w):
        calls.append(x)
        return torch.tanh(x @ w)

    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    for remat in POLICIES:
        body = maybe_remat(fn, remat)
        with torch.no_grad():
            out = body(x, w)
        assert out.grad_fn is None and torch.equal(out, torch.tanh(x @ w))
    assert len(calls) == 3
    assert maybe_remat(fn, "none") is fn
    # under autograd the policies recompute and give the same gradient
    grads = {}
    for remat in POLICIES:
        calls.clear()
        out = maybe_remat(fn, remat)(x, w)
        grads[remat] = torch.autograd.grad(out.sum(), (x, w))
        assert len(calls) == (1 if remat == "none" else 2)
    for remat in ("block", "dots"):
        for g, r in zip(grads[remat], grads["none"]):
            assert torch.equal(g, r)


@pytest.mark.parametrize("remat", ["full", "", "Block", None])
def test_maybe_remat_raises_on_an_unknown_policy(remat):
    with pytest.raises(ValueError, match="unknown remat policy"):
        maybe_remat(lambda x: x, remat)
