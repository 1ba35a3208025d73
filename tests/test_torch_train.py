"""Port parity: AdamW, gradient compression, the loss, the gradients and
the train step against the JAX package on the same numpy inputs.

The JAX model is the default one (``use_flash_kernel=False``): `jax.grad`
cannot go through the Pallas kernel, and its gradient is XLA's autodiff of
`blockwise_attention`.  The port's CPU attention is the plain version,
which the card's kernel route differentiates too (`FlashAttention`).

The MoE and ssm families (granite-moe-1b-a400m and mamba2-370m at their
smoke widths) are held the same way: the JAX MoE differentiates its
expert einsums, the JAX mixer its jnp chunked scan (`use_ssd_kernel=False`);
the port's CPU routes are the plain versions, which the card's `MoeGemm`
and `SsdScan` differentiate too.

Tolerances: the optimizer on identical gradients agrees to fp32 rounding
(rtol 1e-5, atol 1e-8; the working weights in bf16 to one bf16 ulp where a
master sits on a rounding boundary).  Gradients in fp32 within 1e-4 of
each leaf's max |g| (sums in another order through 2 layers); in bf16
within 2e-2 of it (the JAX blockwise path rounds q * scale to bf16, the
port's does not).  Losses and grad norms of the train step within rtol
1e-4 (fp32).  Parameters after n steps within 2 x (sum of the steps' lr):
with eps 1e-8 an element whose gradient is ~0 moves by about +-lr either
way, whichever way its rounding falls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress_grads as j_compress_grads
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.optim import decompress_grads as j_decompress_grads
from repro.optim import global_norm as j_global_norm
from repro.train.train_step import loss_fn as j_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.carry import (lm_params_from_numpy, lm_params_to_numpy,
                               opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gemm.ops import MoeGemm, moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.ssd_scan import ref as ssd_ref_mod
from repro_torch.kernels.ssd_scan.ops import SsdScan, ssd_scan
from repro_torch.kernels.ssd_scan.ref import causal_decay, ssd_scan_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, cosine_schedule,
                               decompress_grads, global_norm)
from repro_torch.train import loss_and_grads, loss_fn, make_train_step

OPT = dict(rtol=1e-5, atol=1e-8)
BF16_ULP = 2.0 ** -8


def f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def from_bits(a):
    """numpy -> float32, bfloat16 leaves given as uint16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# ------------------------------------------------------------ optimizer ----

def opt_tree(rng, dtype):
    shapes = {"blocks": {"w": (2, 8, 16), "ln": (2, 16)}, "embed": (32, 16)}
    return jax.tree.map(lambda s: (rng.normal(size=s) * 0.05).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_adamw_update_matches_jax(state_dtype, param_dtype):
    """3 steps on identical numpy gradients, clipping active."""
    rng = np.random.default_rng(0)
    p0 = opt_tree(rng, param_dtype)
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5,
              state_dtype=state_dtype)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jdt, tdt = jnp.dtype(param_dtype), getattr(torch, param_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    jo = {"mu": jax.tree.map(lambda a: jnp.zeros(a.shape, state_dtype), p0),
          "nu": jax.tree.map(lambda a: jnp.zeros(a.shape, state_dtype), p0),
          "master": jax.tree.map(lambda a: jnp.asarray(a, jdt).astype(jnp.float32), p0),
          "step": jnp.int32(0)}
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), p0)
    to = adamw_init(tp, state_dtype)
    for step in range(3):
        g = opt_tree(rng, "float32")
        g = jax.tree.map(lambda a: a * (3.0 + step), g)  # norm ~4-6 > clip 0.5
        jp, jo, jm = j_adamw_update(jcfg, jax.tree.map(jnp.asarray, g), jo, jp)
        tp, to, tm = adamw_update(tcfg, tree_map(torch.from_numpy, g), to, tp)
        assert float(jm["grad_norm"]) > kw["clip_norm"]
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **OPT)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **OPT)
        assert int(to["step"]) == int(jo["step"]) == step + 1
        for part in ("mu", "nu", "master"):
            for w, t in zip(jax.tree.leaves(jo[part]), tree_leaves(to[part])):
                assert t.dtype == getattr(torch, jnp.dtype(w.dtype).name)
                tol = OPT if t.dtype == torch.float32 else dict(
                    rtol=BF16_ULP, atol=1e-12)
                np.testing.assert_allclose(f32(t), f32(w), **tol)
        for w, t in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert t.dtype == tdt
            tol = OPT if tdt == torch.float32 else dict(rtol=BF16_ULP, atol=0)
            np.testing.assert_allclose(f32(t), f32(w), **tol)


def test_cosine_schedule_and_global_norm_match_jax():
    cfg = dict(lr_peak=3e-3, warmup_steps=5, total_steps=40)
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        want = float(j_cosine_schedule(JAdamWConfig(**cfg), jnp.int32(step)))
        got = cosine_schedule(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
    tree = opt_tree(np.random.default_rng(2), "float32")
    np.testing.assert_allclose(float(global_norm(tree_map(torch.from_numpy, tree))),
                               float(j_global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=1e-6)


def test_adamw_reduces_quadratic_loss():
    """tests/test_substrates.py's quadratic, bf16 weights, bf16 moments."""
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=1, total_steps=100,
                      weight_decay=0.0, clip_norm=10.0, state_dtype="bfloat16")
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8,)).astype(np.float32))
    params = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    opt = adamw_init(params, "bfloat16")
    l0 = float(((params["w"].float() - target) ** 2).sum())
    for _ in range(60):
        g = {"w": 2 * (params["w"].float() - target)}
        params, opt, _ = adamw_update(cfg, g, opt, params)
    assert float(((params["w"].float() - target) ** 2).sum()) < 0.05 * l0


# ---------------------------------------------------------- compression ----

@pytest.mark.parametrize("method", ["bf16", "int8"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compression_matches_jax(method, with_residual):
    rng = np.random.default_rng(3)
    g = {"a": (rng.normal(size=(64, 8)) * 1e-3).astype(np.float32),
         "b": {"c": rng.normal(size=(33,)).astype(np.float32)}}
    r = (jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-5).astype(np.float32), g)
         if with_residual else None)
    jc, jr = j_compress_grads(jax.tree.map(jnp.asarray, g), method,
                              None if r is None else jax.tree.map(jnp.asarray, r))
    tc, tr = compress_grads(tree_map(torch.from_numpy, g), method,
                            None if r is None else tree_map(torch.from_numpy, r))
    is_code = lambda x: isinstance(x, tuple)  # noqa: E731
    for w, t in zip(jax.tree.leaves(jc, is_leaf=is_code), tree_leaves(tc)):
        if method == "int8":
            assert t[0].dtype == torch.int8
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(w[0]))
            np.testing.assert_allclose(float(t[1]), float(w[1]), rtol=1e-7)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(f32(t), f32(w))
    for w, t in zip(jax.tree.leaves(jr), tree_leaves(tr)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-12)
    back = decompress_grads(tc, method)
    for w, t in zip(jax.tree.leaves(j_decompress_grads(jc, method)), tree_leaves(back)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-12)
    # error feedback: what came back plus the new residual is what went in
    for t, rr, gg, r0 in zip(tree_leaves(back), tree_leaves(tr), tree_leaves(g),
                             tree_leaves(r) if r else [0, 0]):
        np.testing.assert_allclose(t.numpy() + rr.numpy(), gg + r0, rtol=1e-5, atol=1e-8)


def test_compression_none_is_identity():
    g = {"w": torch.ones(3)}
    assert compress_grads(g, "none") == (g, None)
    assert decompress_grads(g, "none") is g
    with pytest.raises(ValueError):
        compress_grads(g, "fp8")


# ------------------------------------------------------------------- LM ----

def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def pair(dtype="float32", seed=0):
    """(JAX cfg, JAX model, JAX params, port model) on the same weights;
    the JAX model on its default (blockwise, differentiable) attention."""
    jcfg = j_get_config("smollm_135m").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, dtype=dtype)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm


def batch(B, S, seed=1, masked=True):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
    labels = data[:, 1:].copy()
    if masked:
        labels[0, :3] = -1  # positions the loss leaves out
    return {"tokens": data[:, :-1], "labels": labels}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("loss_impl", ["gather", "onehot"])
def test_loss_fn_matches_jax(loss_impl):
    jcfg, jm, jp, tm = pair()
    b = batch(3, 12)
    want, wm = j_loss_fn(jm, jp, jax.tree.map(jnp.asarray, b), jcfg, loss_impl)
    got, gm = loss_fn(tm, as_torch(b), tm.cfg, loss_impl)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=1e-5)
    assert float(gm["aux"]) == 0.0
    other = "onehot" if loss_impl == "gather" else "gather"
    np.testing.assert_allclose(float(loss_fn(tm, as_torch(b), tm.cfg, other)[0]),
                               float(got), rtol=1e-6)


def test_layers_are_views_of_the_stacked_parameters():
    """`LM.blocks` hands out index i of each stacked Parameter: an in-place
    update of `param_tree` (the optimizer's) reaches the layers, and under
    autograd a layer's gradient lands in its slice of the stacked leaf."""
    _, _, _, tm = pair(seed=5)
    w_q = tm.param_tree()["blocks"]["attn"]["w_q"]
    view = tm.blocks[1].attn.w_q
    assert view.data_ptr() == w_q[1].data_ptr() and view.grad_fn is None
    with torch.no_grad():
        w_q[1].add_(1.0)
    assert torch.equal(tm.blocks[1].attn.w_q, w_q[1])
    tm.requires_grad_(True)
    view = tm.blocks[1].attn.w_q
    assert view.data_ptr() == w_q[1].data_ptr() and view.grad_fn is not None
    view.sum().backward()
    assert w_q.grad.shape == w_q.shape
    assert torch.equal(w_q.grad[1], torch.ones_like(view))
    assert not w_q.grad[0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(dtype):
    jcfg, jm, jp, tm = pair(dtype, seed=3)
    b = batch(2, 16, seed=4)
    want = jax.grad(lambda p: j_loss_fn(jm, p, jax.tree.map(jnp.asarray, b), jcfg)[0])(jp)
    tm.requires_grad_(True)
    _, _, got = loss_and_grads(tm, as_torch(b), tm.cfg)
    share = 1e-4 if dtype == "float32" else 2e-2
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    leaves_g = tree_leaves(got)
    assert len(leaves_w) == len(leaves_g) == 11
    for (path, w), g in zip(leaves_w, leaves_g):
        assert g.dtype == getattr(torch, jnp.dtype(w.dtype).name), path
        assert tuple(g.shape) == w.shape, path
        w = f32(w)
        np.testing.assert_allclose(f32(g), w, rtol=0, atol=share * np.abs(w).max(),
                                   err_msg=str(path))
        assert np.abs(w).max() > 0, path


def j_opt_state(jp):
    return {"mu": jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jp),
            "nu": jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jp),
            "master": jax.tree.map(lambda a: a.astype(jnp.float32), jp),
            "step": jnp.int32(0)}


@pytest.mark.parametrize("n_micro,compression", [
    (1, "none"), (2, "none"), (1, "bf16"), (2, "int8")])
def test_train_step_matches_jax(n_micro, compression):
    """3 steps of the train step from the same weights, state and batches:
    losses and grad norms agree, and so do the parameters within the
    optimizer's step."""
    jcfg, jm, jp, tm = pair(seed=5)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10,
              grad_compression=compression)
    jstep = jax.jit(j_make_train_step(jm, jcfg, JAdamWConfig(**kw), n_micro))
    tstep = make_train_step(tm, tm.cfg, AdamWConfig(**kw), n_micro)
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
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2 * lrs,
                                   err_msg=str(path))
        # and almost every element to fp32 rounding of the update
        assert np.mean(np.abs(g - np.asarray(w)) > 1e-5) < 1e-3, path
    state = opt_state_to_numpy(to)
    assert int(state["step"]) == 3
    for part in ("master", "mu"):
        for w, g in zip(jax.tree.leaves(jo[part]), tree_leaves(state[part])):
            assert g.shape == w.shape and g.dtype == np.float32


def test_opt_state_round_trip_bit_exact():
    _, _, jp, tm = pair("bfloat16")
    jo = j_opt_state(jp)
    jo["mu"] = jax.tree.map(lambda a: (a + 1).astype(jnp.bfloat16), jo["master"])
    jo["step"] = jnp.int32(7)
    want = jax.tree.map(np.asarray, jo)
    state = opt_state_from_numpy(tm.cfg, want, "cpu")
    assert tree_leaves(state["mu"])[0].dtype == torch.bfloat16
    assert tree_leaves(state["nu"])[0].dtype == torch.float32
    got = opt_state_to_numpy(state)
    assert int(got["step"]) == 7
    for part in ("mu", "nu", "master"):
        for w, g in zip(jax.tree.leaves(want[part]), tree_leaves(got[part])):
            np.testing.assert_array_equal(from_bits(g), w.astype(np.float32))


# ----------------------------------------------- the attention gradient ----

@pytest.mark.parametrize("case", [
    dict(shape=(2, 16, 16, 4, 2, 16), causal=True, window=None),
    dict(shape=(1, 8, 24, 6, 2, 32), causal=True, window=None),   # Sq < Skv
    dict(shape=(2, 16, 16, 4, 4, 16), causal=False, window=None),
    dict(shape=(1, 32, 32, 4, 1, 16), causal=True, window=8)])
def test_flash_attention_function_backward_is_the_plain_gradient(case):
    """`FlashAttention` with the plain version as its forward (the kernel
    needs the card): its gradients are autograd's through the plain
    version, bit for bit, and the forward it is given is the one that runs."""
    B, Sq, Skv, H, K, D = case["shape"]
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))
    dout = torch.from_numpy(rng.normal(size=(B, Sq, H, D)).astype(np.float32))
    calls = []

    def forward(*args, **kw):
        calls.append(kw)
        return flash_attention_ref(*args, **kw)

    attn = dict(causal=case["causal"], scale=D ** -0.5, window=case["window"])
    out = FlashAttention.apply(q, k, v, attn["causal"], attn["scale"], attn["window"],
                               forward)
    assert calls == [attn]
    want_out = flash_attention_ref(q, k, v, **attn)
    assert torch.equal(out, want_out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # only the inputs that ask for a gradient get one
    out = FlashAttention.apply(q.detach(), k, v.detach(), True, 0.25, None, forward)
    (dk,) = torch.autograd.grad(out, (k,), dout)
    assert dk.shape == k.shape


def test_flash_attention_on_the_cpu_is_the_plain_version():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16)
    out = flash_attention(q, k, k, causal=True)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    assert torch.equal(out, flash_attention_ref(q, k, k, causal=True, scale=0.25))


# ----------------------------------------------- the MoE and ssm families ----

FAMILIES = ["granite_moe_1b_a400m", "mamba2_370m"]


def family_pair(arch, dtype="float32", seed=0, **kw):
    """(JAX cfg, JAX model, JAX params, port model) of ``arch``'s smoke
    config on the same weights; the JAX model on its differentiable jnp
    routes."""
    jcfg = j_get_smoke_config(arch).scaled(dtype=dtype, **kw)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm


def j_grads(jm, jp, b, jcfg):
    return jax.grad(lambda p: j_loss_fn(jm, p, jax.tree.map(jnp.asarray, b), jcfg)[0])(jp)


def assert_grads_close(got, want, share):
    """Each leaf within ``share`` of the JAX leaf's max |g|, in the JAX
    leaf's dtype and shape."""
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    leaves_g = tree_leaves(got)
    assert len(leaves_w) == len(leaves_g)
    for (path, w), g in zip(leaves_w, leaves_g):
        assert g.dtype == getattr(torch, jnp.dtype(w.dtype).name), path
        assert tuple(g.shape) == w.shape, path
        w = f32(w)
        assert np.isfinite(w).all() and np.abs(w).max() > 0, path
        np.testing.assert_allclose(f32(g), w, rtol=0, atol=share * np.abs(w).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_gradients_match_jax_grad(arch, dtype):
    """Every leaf of the MoE and ssm smoke models (experts, router, mixer,
    A_log, dt_bias, D, ...) against `jax.grad`, the MoE aux loss in the
    loss; the ssm at the smoke config's chunk of 16 over 64 steps."""
    jcfg, jm, jp, tm = family_pair(arch, dtype, seed=3)
    S = 64 if arch.startswith("mamba") else 16
    b = batch(2, S, seed=4)
    want = j_grads(jm, jp, b, jcfg)
    tm.requires_grad_(True)
    loss, metrics, got = loss_and_grads(tm, as_torch(b), tm.cfg)
    jloss, jmetrics = j_loss_fn(jm, jp, jax.tree.map(jnp.asarray, b), jcfg)
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), rtol=rtol)
    assert (float(metrics["aux"]) > 0) == arch.startswith("granite")
    assert_grads_close(got, want, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("arch,n_micro,compression", [
    ("granite_moe_1b_a400m", 2, "bf16"), ("granite_moe_1b_a400m", 1, "int8"),
    ("mamba2_370m", 2, "int8"), ("mamba2_370m", 1, "bf16")])
def test_family_train_step_matches_jax(arch, n_micro, compression):
    """3 steps of the MoE and ssm train steps from the same weights, state
    and batches, with microbatches and compressed gradients: losses, grad
    norms and parameters as for the dense family."""
    jcfg, jm, jp, tm = family_pair(arch, seed=5)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10,
              grad_compression=compression)
    jstep = jax.jit(j_make_train_step(jm, jcfg, JAdamWConfig(**kw), n_micro))
    tstep = make_train_step(tm, tm.cfg, AdamWConfig(**kw), n_micro)
    jo = j_opt_state(jp)
    to = opt_state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jo), "cpu")
    lrs = 0.0
    S = 32 if arch.startswith("mamba") else 12
    for step in range(3):
        b = batch(4, S, seed=10 + step)
        jp, jo, jm_ = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        to, tm_ = tstep(to, as_torch(b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]), rtol=1e-4,
                                       err_msg=key)
        lrs += float(jm_["lr"])
    got = lm_params_to_numpy(tm)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp), tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2 * lrs,
                                   err_msg=str(path))
        assert np.mean(np.abs(g - np.asarray(w)) > 1e-5) < 1e-3, path
    assert int(opt_state_to_numpy(to)["step"]) == 3


# ------------------------------------ the chunked scan's NaN gradient ----

def old_causal_decay(diff, causal):
    """The chunked scan's decay before the repair (and the JAX package's,
    `repro/models/ssm.py:74`): exp first, then `where`."""
    return torch.where(causal, torch.exp(diff), 0.0)


def test_ssd_scan_ref_forward_is_unchanged_by_the_repair(monkeypatch):
    """`causal_decay` gives the old expression's values bit for bit, and so
    the scan its outputs, over exponents that overflow above the diagonal."""
    rng = np.random.default_rng(8)
    B, S, H, P, N = 2, 96, 3, 16, 16
    x, Bm, Cm = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = torch.from_numpy(rng.uniform(0.5, 3.0, size=(B, S, H)).astype(np.float32))
    A = torch.tensor([-1.0, -2.0, -0.5])
    for chunk in (32, 48, 96):
        want = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
        with monkeypatch.context() as m:
            m.setattr(ssd_ref_mod, "causal_decay", old_causal_decay)
            old = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
        for g, w in zip(want, old):
            assert torch.equal(g, w)
    diff = torch.from_numpy(rng.normal(size=(5, 7, 7)).astype(np.float32)) * 60
    causal = torch.ones(7, 7, dtype=torch.bool).tril()
    assert torch.equal(causal_decay(diff, causal), old_causal_decay(diff, causal))


def test_ssd_scan_ref_gradient_is_finite_where_the_decay_overflows(monkeypatch):
    """dt = 2 over one chunk of 64: cum spans 128 > 88.7, so exp overflows
    above the diagonal.  The old expression's gradient is NaN; the
    repaired one is finite."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(1, 64, 2, 8)).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rng.normal(size=(1, 64, 8)).astype(np.float32))
              for _ in range(2))
    A = torch.tensor([-1.0, -1.0])

    def dt_grad():
        dt = torch.full((1, 64, 2), 2.0, requires_grad=True)
        y, _ = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=64)
        (g,) = torch.autograd.grad(y.sum(), dt)
        return g

    assert bool(torch.isfinite(dt_grad()).all())
    with monkeypatch.context() as m:
        m.setattr(ssd_ref_mod, "causal_decay", old_causal_decay)
        assert bool(torch.isnan(dt_grad()).any())


def test_ssm_gradient_at_the_published_chunk_is_finite_where_jax_is_nan():
    """mamba2's smoke model at the published chunk of 256 over 256 steps,
    with the repo's init (A = -1, dt ~ 0.7: cum spans ~177).  The JAX
    gradient is NaN (its chunked scan exps before its `where`); the port's
    is finite and equals its gradient at chunk 16, which equals JAX's."""
    b = batch(2, 256, seed=4)
    jcfg, jm, jp, _ = family_pair("mamba2_370m", seed=3, ssm_chunk=256)
    want_nan = j_grads(jm, jp, b, jcfg)
    nan_leaves = [str(p) for p, w in jax.tree_util.tree_leaves_with_path(want_nan)
                  if np.isnan(f32(w)).any()]
    assert any("A_log" in p for p in nan_leaves) and any("embed" in p for p in nan_leaves)
    grads = {}
    for chunk in (256, 16):
        jcfg, jm, jp, tm = family_pair("mamba2_370m", seed=3, ssm_chunk=chunk)
        tm.requires_grad_(True)
        grads[chunk] = loss_and_grads(tm, as_torch(b), tm.cfg)[2]
    assert_grads_close(grads[16], j_grads(jm, jp, b, jcfg), 1e-4)
    for g256, g16 in zip(tree_leaves(grads[256]), tree_leaves(grads[16])):
        assert bool(torch.isfinite(g256).all())
        torch.testing.assert_close(g256, g16, rtol=0, atol=1e-4 * float(g16.abs().max()))


# ---------------------------------- the MoE and scan gradients' wiring ----

def test_ssd_scan_function_backward_is_the_plain_gradient():
    """`SsdScan` with the plain version as its forward (the kernel needs
    the card): x, B and C are strided views of one conv output, as in the
    mixer, and their gradients add up into it; every gradient is autograd's
    through the plain version, bit for bit, with the state's cotangent
    dropped (training) and given."""
    rng = np.random.default_rng(10)
    Bsz, S, H, P, N, chunk = 2, 40, 3, 8, 16, 16
    di = H * P
    conv = torch.from_numpy(rng.normal(size=(Bsz, S, di + 2 * N)).astype(np.float32)
                            ).requires_grad_()
    dt_raw = torch.from_numpy(rng.normal(size=(Bsz, S, H)).astype(np.float32)
                              ).requires_grad_()
    A_log = torch.from_numpy(rng.normal(size=(H,)).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.normal(size=(Bsz, S, H, P)).astype(np.float32))
    dstate = torch.from_numpy(rng.normal(size=(Bsz, H, P, N)).astype(np.float32))
    leaves = (conv, dt_raw, A_log)
    calls = []

    def forward(*args, **kw):
        calls.append(kw)
        return ssd_scan_ref(*args, **kw)

    def inputs():
        return (conv[..., :di].unflatten(-1, (H, P)),
                torch.nn.functional.softplus(dt_raw), -torch.exp(A_log),
                conv[..., di:di + N], conv[..., di + N:])

    got_y, got_s = SsdScan.apply(*inputs(), chunk, forward)
    want_y, want_s = ssd_scan_ref(*inputs(), chunk=chunk)
    assert calls == [dict(chunk=chunk)]
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)
    for outs, cots in (((got_y,), (dy,)), ((got_y, got_s), (dy, dstate))):
        got = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        want = torch.autograd.grad((want_y, want_s)[:len(outs)], leaves, cots,
                                   retain_graph=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert bool(got[0][..., :di].any() and got[0][..., di:di + N].any()
                    and got[0][..., di + N:].any())
    # only the inputs that ask for a gradient get one
    x, dt, A, Bm, Cm = inputs()
    y, _ = SsdScan.apply(x.detach(), dt, A.detach(), Bm.detach(), Cm.detach(), chunk,
                         forward)
    (g,) = torch.autograd.grad(y, (dt_raw,), dy)
    assert g.shape == dt_raw.shape


def test_moe_gemm_function_backward_is_the_plain_gradient():
    """`MoeGemm` with the plain version as its forward: gradients of x and
    the three weights are autograd's through the plain version, bit for
    bit; rows at or past ``counts[e]`` (random here) get zero gradient, and
    counts none."""
    rng = np.random.default_rng(11)
    E, C, d, f = 4, 12, 16, 24
    x, wg, wu, wd = (torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3
                                      ).requires_grad_()
                     for s in ((E, C, d), (E, d, f), (E, d, f), (E, f, d)))
    counts = torch.tensor([0, 5, C, C + 3], dtype=torch.int32)
    dy = torch.from_numpy(rng.normal(size=(E, C, d)).astype(np.float32))
    calls = []

    def forward(*args):
        calls.append(len(args))
        return moe_gemm_ref(*args)

    got_y = MoeGemm.apply(x, wg, wu, wd, counts, forward)
    want_y = moe_gemm_ref(x, wg, wu, wd, counts)
    assert calls == [5] and torch.equal(got_y, want_y)
    got = torch.autograd.grad(got_y, (x, wg, wu, wd), dy)
    want = torch.autograd.grad(want_y, (x, wg, wu, wd), dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and bool(g.any())
    dead = torch.arange(C)[None, :] >= counts[:, None]
    assert not bool(got[0][dead].any()) and bool(got[0][~dead].all())
    (gwd,) = torch.autograd.grad(MoeGemm.apply(x.detach(), wg, wu, wd, counts, forward),
                                 (wd,), dy)
    assert torch.equal(gwd, want[3])


def test_moe_and_scan_on_the_cpu_are_the_plain_versions():
    x = torch.randn(2, 8, 16, requires_grad=True)
    w = [torch.randn(2, 16, 8), torch.randn(2, 16, 8), torch.randn(2, 8, 16)]
    counts = torch.tensor([3, 8], dtype=torch.int32)
    y = moe_gemm(x, *w, counts)
    assert "MoeGemm" not in type(y.grad_fn).__name__
    assert torch.equal(y, moe_gemm_ref(x, *w, counts))
    xs = torch.randn(1, 8, 2, 8, requires_grad=True)
    dt, A = torch.rand(1, 8, 2), -torch.ones(2)
    Bm = Cm = torch.randn(1, 8, 8)
    y, _ = ssd_scan(xs, dt, A, Bm, Cm, chunk=4)
    assert "SsdScan" not in type(y.grad_fn).__name__
    assert torch.equal(y, ssd_scan_ref(xs, dt, A, Bm, Cm, chunk=4)[0])
