"""Port parity: the MoE slice (granite-moe-1b-a400m) against the JAX package.

The same numpy inputs, and the same weights carried through
`carry.lm_params_from_numpy`, go through both sides.  Tolerances:
- the grouped expert GEMM's plain version against the JAX `moe_gemm`
  (Pallas, interpret mode, as `tests/test_kernels.py:312` runs it) and
  `moe_gemm_ref`: 1e-5 relative in fp32, with an atol of 1e-5 of the
  largest |y| (the sums of d and f products run in another order, and y
  cancels: intermediates are O(d sqrt(f))); in bf16 the JAX test's 5e-2;
- the MoE layer in fp32: the routing (expert ids, counts, the capacity
  buffer, so every kept pick's slot and every drop) equal, the output
  within 1e-5 of the largest |out|, the aux loss within 1e-6;
- models: 1e-4 in fp32 (2 layers and a tied head, sums in another order)
  and 2e-2 in bf16, those of `tests/test_torch_lm.py:28-29`.  In bf16 the
  JAX model rounds g and u to bf16 before silu (`models/moe.py:145-147`)
  and the port keeps them in fp32 (the kernel's contract), which the bf16
  tolerance covers.
The JAX model runs its flash kernels (interpret mode), so both sides take
the kernels' casts in attention (see `tests/test_torch_lm.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.moe_gemm.ops import moe_gemm as j_moe_gemm
from repro.kernels.moe_gemm.ref import moe_gemm_ref as j_moe_gemm_ref
from repro.models import build_model as j_build_model
from repro.models.moe import moe as j_moe
from repro.models.params import count_params as j_count_params
from repro.models.params import init_params as j_init_params
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import make_serve_step as j_make_serve_step
from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.moe_gemm.ops import moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, count_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import capacity, combine, dispatch, moe, observe
from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                               make_serve_step)

GEMM_FP32 = 1e-5  # relative, and as a share of the largest |y|
GEMM_BF16 = dict(atol=5e-2, rtol=5e-2)
FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)

MG_SHAPES = [  # (E, C, d, f, block_c): tests/test_kernels.py:301-307
    (4, 64, 32, 16, 32), (8, 96, 64, 32, 32), (2, 50, 32, 64, 16), (32, 40, 64, 32, 8)]
SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=64, vocab=256, n_experts=8, top_k=4)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def scaled(rel: float, want) -> dict:
    """rtol ``rel`` and an atol of ``rel`` times the largest |want|."""
    return dict(rtol=rel, atol=rel * float(np.abs(f32(want)).max()))


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def gemm_inputs(shape, dtype, seed=0):
    """x, w_gate, w_up, w_down as numpy fp32 already rounded to ``dtype``
    (the draws of tests/test_kernels.py), and counts in [0, C] with 0, C
    and C + 5 among them; x is zero past the counts, as the dispatch
    leaves it."""
    E, C, d, f, _ = shape
    rng = np.random.default_rng(seed)

    def rounded(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype).float().numpy()

    x, wg, wu, wd = rounded(E, C, d), rounded(E, d, f), rounded(E, d, f), rounded(E, f, d)
    counts = rng.integers(0, C + 1, size=E).astype(np.int32)
    counts[:2] = 0, C
    counts[-1] = C + 5
    x *= (np.arange(C)[None, :] < counts[:, None])[..., None]
    return x, wg, wu, wd, counts


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("target", ["kernel", "ref"])
def test_plain_gemm_matches_jax(shape, dtypes, target):
    """The port's plain version (the CPU route of `moe_gemm`) against the
    JAX kernel in interpret mode and against its oracle."""
    x, wg, wu, wd, counts = gemm_inputs(shape, dtypes[0])
    got = moe_gemm(*(torch.from_numpy(a).to(dtypes[0]) for a in (x, wg, wu, wd)),
                   torch.from_numpy(counts))
    assert got.dtype == dtypes[0] and got.shape == x.shape
    jargs = [jnp.asarray(a).astype(dtypes[1]) for a in (x, wg, wu, wd)]
    want = (j_moe_gemm(*jargs, jnp.asarray(counts), block_c=shape[-1])
            if target == "kernel" else j_moe_gemm_ref(*jargs, jnp.asarray(counts)))
    tol = scaled(GEMM_FP32, want) if dtypes[0] == torch.float32 else GEMM_BF16
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    dead = np.arange(shape[1])[None, :] >= counts[:, None]
    assert not f32(got)[dead].any()


def test_plain_gemm_masks_rows_past_the_counts():
    """Rows at or past counts[e] are 0 whatever the buffer holds there, and
    the live rows do not depend on them."""
    x, wg, wu, wd, counts = gemm_inputs(MG_SHAPES[1], torch.float32, seed=3)
    args = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
    junk = args[0] + torch.from_numpy(np.random.default_rng(4).normal(
        size=x.shape).astype(np.float32))
    live = torch.arange(x.shape[1])[None, :] < torch.from_numpy(counts)[:, None]
    junk = torch.where(live[..., None], args[0], junk)
    c = torch.from_numpy(counts)
    assert torch.equal(moe_gemm_ref(junk, *args[1:], c), moe_gemm_ref(*args, c))


# ------------------------------------------------------------ the layer ----

def layer_inputs(T, seed=0, **kw):
    """A JAX smoke config, and the router/expert weights and tokens xt
    (T, d) as numpy fp32 with O(1) activations."""
    jcfg = j_get_config("granite_moe_1b_a400m").scaled(dtype="float32", **SMOKE | kw)
    d, f, E = jcfg.d_model, jcfg.d_ff, jcfg.n_experts
    rng = np.random.default_rng(seed)

    def w(*s, fan):
        return (rng.normal(size=s) / np.sqrt(fan)).astype(np.float32)

    p = dict(w_router=w(d, E, fan=d), w_gate=w(E, d, f, fan=d), w_up=w(E, d, f, fan=d),
             w_down=w(E, f, d, fan=f))
    return jcfg, p, rng.normal(size=(T, d)).astype(np.float32)


def jax_moe_recorded(monkeypatch, jcfg, p, xt):
    """JAX `moe` on (1, T, d), with its top-k ids and capacity buffer
    recorded on the way."""
    seen = {}
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def rec_top_k(x, k):
        out = top_k(x, k)
        seen.setdefault("ids", np.asarray(out[1]))
        return out

    def rec_einsum(spec, a, *rest, **kw):
        seen.setdefault("grouped", np.asarray(a))
        return einsum(spec, a, *rest, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "einsum", rec_einsum)
    out, aux = j_moe({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(xt)[None])
    monkeypatch.undo()
    return np.asarray(out)[0], float(aux), seen


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_layer_matches_jax(monkeypatch, capacity_factor):
    jcfg, p, xt = layer_inputs(96, capacity_factor=capacity_factor)
    cfg = port_cfg(jcfg)
    want, want_aux, seen = jax_moe_recorded(monkeypatch, jcfg, p, xt)
    tp = type("P", (), {k: torch.from_numpy(v) for k, v in p.items()})
    disp = dispatch(tp, cfg, torch.from_numpy(xt))
    E, C = cfg.n_experts, capacity(cfg, 96)
    np.testing.assert_array_equal(disp.expert_ids.numpy(), np.sort(seen["ids"], axis=-1))
    np.testing.assert_array_equal(disp.counts.numpy(),
                                  np.bincount(seen["ids"].ravel(), minlength=E))
    # every kept pick in JAX's slot, every dropped one absent: the buffers
    # hold the same token rows, bit for bit
    assert disp.grouped.shape == (E, C, cfg.d_model)
    np.testing.assert_array_equal(disp.grouped.numpy(), seen["grouped"])
    kept = disp.keep.sum()
    assert int(kept) == int(np.minimum(np.bincount(seen["ids"].ravel(), minlength=E), C).sum())
    if capacity_factor < 1:
        assert not bool(disp.keep.all())        # the case drops picks
    rows = disp.grouped.reshape(E * C, -1)[disp.slot[disp.keep]]
    tok = torch.arange(96)[:, None].expand_as(disp.keep)[disp.keep]
    assert torch.equal(rows, torch.from_numpy(xt)[tok])
    got, aux = moe(tp, cfg, torch.from_numpy(xt)[None])
    np.testing.assert_allclose(f32(got[0]), want, **scaled(GEMM_FP32, want))
    assert abs(float(aux) - want_aux) <= 1e-6



def tied_router_inputs(case):
    """`layer_inputs(16)` with router ties: token 3 set to zero (all its
    logits 0), or router columns 1 and 6 made equal."""
    jcfg, p, xt = layer_inputs(16)
    if case == "zero_token":
        xt[3] = 0
    else:
        p["w_router"][:, 1] = p["w_router"][:, 6]
    return jcfg, p, xt


@pytest.mark.parametrize("case", ["zero_token", "equal_columns"])
def test_moe_router_breaks_ties_as_jax(monkeypatch, case):
    """Among equal router probabilities the lower expert id wins, as in
    `lax.top_k`; the picks decide which overflow capacity, and so the
    other tokens' outputs."""
    jcfg, p, xt = tied_router_inputs(case)
    cfg = port_cfg(jcfg)
    want, _, seen = jax_moe_recorded(monkeypatch, jcfg, p, xt)
    tp = type("P", (), {k: torch.from_numpy(v) for k, v in p.items()})
    disp = dispatch(tp, cfg, torch.from_numpy(xt))
    if case == "zero_token":
        assert seen["ids"][3].tolist() == [0, 1, 2, 3]
    else:
        probs = torch.softmax(torch.from_numpy(xt) @ tp.w_router, -1)
        assert bool((probs[:, 1] == probs[:, 6]).all())
        # some token's tie sits on the k-th place: only expert 1 is picked
        picked = [set(r) & {1, 6} for r in seen["ids"].tolist()]
        assert {1} in picked
    np.testing.assert_array_equal(disp.expert_ids.numpy(), np.sort(seen["ids"], axis=-1))
    np.testing.assert_array_equal(disp.grouped.numpy(), seen["grouped"])
    got, _ = moe(tp, cfg, torch.from_numpy(xt)[None])
    np.testing.assert_allclose(f32(got[0]), want, **scaled(GEMM_FP32, want))

def test_moe_layer_without_aux_gives_the_same_output():
    """Decode and prefill discard the aux loss (as the JAX package does);
    the output is the dispatch, the expert GEMM and the combine alone."""
    jcfg, p, xt = layer_inputs(40, capacity_factor=0.5)
    cfg = port_cfg(jcfg)
    tp = type("P", (), {k: torch.from_numpy(v) for k, v in p.items()})
    out, aux = moe(tp, cfg, torch.from_numpy(xt)[None])
    disp = dispatch(tp, cfg, torch.from_numpy(xt))
    y = moe_gemm_ref(disp.grouped, tp.w_gate, tp.w_up, tp.w_down, disp.counts)
    assert torch.equal(out[0], combine(y, disp)) and torch.equal(aux, disp.aux)
    assert not bool(disp.keep.all())


def test_moe_observe_sees_every_dispatch():
    """`observe` calls back once per `moe` call with its tokens and
    dispatch, and stops at the end of the block."""
    jcfg, p, xt = layer_inputs(40, capacity_factor=0.5)
    cfg = port_cfg(jcfg)
    tp = type("P", (), {k: torch.from_numpy(v) for k, v in p.items()})
    seen = []
    with observe(lambda q, t, d: seen.append((q, t, d))):
        out, _ = moe(tp, cfg, torch.from_numpy(xt)[None])
    moe(tp, cfg, torch.from_numpy(xt)[None])
    assert len(seen) == 1 and seen[0][0] is tp
    assert torch.equal(seen[0][1], torch.from_numpy(xt))
    assert torch.equal(seen[0][2].expert_ids, dispatch(tp, cfg, torch.from_numpy(xt)).expert_ids)


# ------------------------------------------------------------- the model ----

def pair(dtype="float32", seed=0, **kw):
    """(JAX cfg, JAX model, JAX params, port model) on the same weights, at
    the smoke widths of `configs/granite_moe_1b_a400m.py`."""
    jcfg = j_get_config("granite_moe_1b_a400m").scaled(
        dtype=dtype, use_flash_kernel=True, use_flash_decode=True, **SMOKE | kw)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm


def tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S)).astype(np.int32)


VARIANTS = {"base": {}, "drops": dict(capacity_factor=0.5),
            "dense_residual": dict(moe_dense_residual=True)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant):
    _, jm, jp, tm = pair(**VARIANTS[variant])
    tok = tokens(2, 24)
    want, want_aux = jm.forward(jp, jnp.asarray(tok))
    got, aux = tm.forward(torch.from_numpy(tok))
    np.testing.assert_allclose(f32(got), f32(want), **FP32)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", ["base", "dense_residual"])
def test_prefill_matches_jax(fused, variant):
    _, jm, jp, tm = pair(fused_prefill_kv=fused, **VARIANTS[variant])
    tok = tokens(3, 12)
    want_lg, want_c = jm.prefill(jp, jnp.asarray(tok), cache_len=16)
    got_lg, got_c = tm.prefill(torch.from_numpy(tok), cache_len=16)
    np.testing.assert_allclose(f32(got_lg), f32(want_lg), **FP32)
    for name in ("k", "v"):
        assert got_c["blocks"][name].shape == want_c["blocks"][name].shape
        np.testing.assert_allclose(f32(got_c["blocks"][name]),
                                   f32(want_c["blocks"][name]), **FP32)


@pytest.mark.parametrize("index_kind", ["scalar", "per_sequence"])
def test_decode_step_matches_jax(index_kind):
    _, jm, jp, tm = pair()
    tok = tokens(3, 12)
    _, jc = jm.prefill(jp, jnp.asarray(tok), cache_len=16)
    _, tc = tm.prefill(torch.from_numpy(tok), cache_len=16)
    nxt = np.asarray([[7], [9], [200]], np.int32)
    if index_kind == "scalar":
        j_idx, t_idx = jnp.int32(12), 12
    else:
        idx = np.asarray([12, 5, 9], np.int32)
        j_idx, t_idx = jnp.asarray(idx), torch.from_numpy(idx)
    for _ in range(2):                  # the second step reads the first's insert
        want, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), j_idx)
        got, tc = tm.decode_step(tc, torch.from_numpy(nxt), t_idx)
        np.testing.assert_allclose(f32(got), f32(want), **FP32)
        j_idx, t_idx = j_idx + 1, t_idx + 1
    np.testing.assert_allclose(f32(tc["blocks"]["k"]), f32(jc["blocks"]["k"]), **FP32)


def test_bf16_forward_and_decode_match_jax():
    _, jm, jp, tm = pair("bfloat16", seed=4)
    tok = tokens(2, 16, seed=5)
    want, _ = jm.forward(jp, jnp.asarray(tok))
    got, _ = tm.forward(torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    _, jc = jm.prefill(jp, jnp.asarray(tok), cache_len=20)
    _, tc = tm.prefill(torch.from_numpy(tok), cache_len=20)
    nxt = np.asarray([[3], [4]], np.int32)
    want, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(16))
    got, _ = tm.decode_step(tc, torch.from_numpy(nxt), 16)
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_prefill_then_serve_steps_match_jax():
    """Greedy tokens of the batched serving path equal JAX's."""
    jcfg, jm, jp, tm = pair(seed=2)
    B, S, gen = 3, 10, 6
    tok = tokens(B, S, seed=6)
    j_step = jax.jit(j_make_serve_step(jm, jcfg))
    lg, jc = jm.prefill(jp, jnp.asarray(tok), cache_len=S + gen)
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    want = [np.asarray(nxt)]
    for i in range(gen - 1):
        nxt, _, jc = j_step(jp, jc, nxt, jnp.int32(S + i))
        want.append(np.asarray(nxt))
    lg, tc = make_prefill_step(tm, tm.cfg)(torch.from_numpy(tok), cache_len=S + gen)
    nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    step, got = make_serve_step(tm, tm.cfg), [nxt.numpy()]
    for i in range(gen - 1):
        nxt, _, tc = step(tc, nxt, S + i)
        got.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))


def test_continuous_batching_matches_jax():
    """The setup of tests/test_serving.py:48 on the MoE arch (4 experts,
    top-2): the port's batcher serves JAX's tokens, request for request.
    Idle slots feed token 0 at position 0 on both sides, and take expert
    capacity there as in the JAX batcher."""
    jcfg = j_get_config("granite_moe_1b_a400m").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
        dtype="float32", n_experts=4, top_k=2, use_flash_kernel=True,
        use_flash_decode=True)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(0))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, size=n).tolist() for n in (3, 5, 8, 4)]
    jeng = JBatcher(jm, jcfg, jp, n_slots=2, cache_len=32)
    teng = ContinuousBatcher(tm, tm.cfg, n_slots=2, cache_len=32, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid, p, 6))
        teng.submit(Request(rid, p, 6))
    want, got = jeng.run(), teng.run()
    assert got == want and set(got) == set(range(4))
    assert teng.occupancy == jeng.occupancy > 0.5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_round_trip_bit_exact(dtype):
    """The MoE tree (w_router fp32, the experts in the model dtype) goes
    to the port and back bit for bit."""
    _, _, jp, tm = pair(dtype, moe_dense_residual=True)
    assert tm.blocks[0].moe.w_router.dtype == torch.float32
    assert tm.blocks[0].moe.w_gate.dtype == getattr(torch, dtype)
    want = jax.tree.map(np.asarray, jp)
    got = lm_params_to_numpy(tm)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[path]
        assert g.shape == w.shape, path
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g, w.view(np.uint16), err_msg=str(path))
        else:
            assert g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    again = lm_params_to_numpy(lm_params_from_numpy(tm.cfg, got, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, again, got)


def test_full_config_and_specs_match_jax():
    jcfg = j_get_config("granite_moe_1b_a400m")
    cfg = get_config("granite-moe-1b-a400m")
    assert port_cfg(jcfg) == cfg and cfg.family == "moe"
    assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor, cfg.router_aux_coef) == (
        32, 8, 1.25, 0.01)
    jm = j_build_model(jcfg)
    assert count_params(build_model(get_smoke_config("granite-moe-1b-a400m"),
                                    device="cpu").specs()) == j_count_params(
        j_build_model(jcfg.scaled(**SMOKE)).specs())
    from repro_torch.models.lm import lm_specs
    assert count_params(lm_specs(cfg)) == j_count_params(jm.specs())
    assert set(lm_specs(cfg)["blocks"]) == set(jm.specs()["blocks"]) == {
        "ln1", "attn", "ln2", "moe"}
    # the capacity of the serving path's global prefill dispatch
    assert capacity(cfg, 32 * 2048) == 20480 and capacity(cfg, 32) == 10


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_driver_runs_on_cpu(continuous, capsys):
    args = ["--arch", "granite-moe-1b-a400m", "--smoke", "--batch", "2",
            "--prompt-len", "6", "--gen", "4", "--device", "cpu"]
    out = serve_cli.main(args + (["--continuous"] if continuous else []))
    assert "on CPU" in capsys.readouterr().out
    if continuous:
        assert len(out) == 5 and all(len(v) == 4 for v in out.values())
    else:
        assert out.shape == (2, 4) and out.dtype == torch.int32
