"""Port parity: the Mamba-2 (ssm) slice against the JAX package.

The same numpy inputs, and the same weights carried through
`carry.lm_params_from_numpy`, go through both sides.  Tolerances:
- 2e-5 between the port's plain scan and the JAX chunked scan
  (`_ssd_chunked`, and the Pallas kernel in interpret mode), relative and
  as a share of the largest |y| (`scaled`): the same algorithm, but
  PyTorch's and XLA's cumsums round differently, and one ulp of |cum|
  (3.8e-6 at the |cum| ~ 45 of these draws) in exp(cum_i - cum_j) moves y
  by that share of the sum of its terms, which is of the order of |y|
  itself.  The two JAX paths share XLA's cumsum and agree closer
  (`tests/test_kernels.py:218`);
- 2e-4 against the fully quadratic oracle `ssd_ref`, which associates
  differently (`tests/test_kernels.py:196`);
- 1e-4 for models in fp32 (2 layers and a tied head, sums in another
  order) and 2e-2 in bf16 (`tests/test_kernels.py:31`).
bf16 inputs of the scan are held at the fp32 tolerances: both sides take
them to fp32 exactly and compute in fp32.

The seeded init (A_log = dt_bias = 0) gives A = -1 and dt ~ 0.7, which
decays the state to nothing within a chunk, so several tests set A and dt
by Mamba-2's published init (A in -[1, 16], dt log-uniform in [1e-3, 1e-1])
so that the carried state counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.models import build_model as j_build_model
from repro.models.params import count_params as j_count_params
from repro.models.params import init_params as j_init_params
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro.models.ssm import ssm_block as j_ssm_block
from repro.models.ssm import ssm_decode_step as j_ssm_decode_step
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import make_prefill_step as j_make_prefill_step
from repro.serve import make_serve_step as j_make_serve_step
from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, count_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_specs
from repro_torch.models.ssm import ssm_block, ssm_decode_step
from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                               make_serve_step)

CHUNKED = 2e-5  # relative, and as a share of the largest |y| (`scaled`)
QUADRATIC = dict(atol=2e-4, rtol=2e-4)
FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)

SSD_SHAPES = [  # (B, S, H, P, N, chunk): tests/test_kernels.py:171-177
    (1, 64, 2, 32, 32, 32), (2, 128, 4, 64, 64, 32), (1, 96, 2, 32, 64, 32),
    (1, 80, 3, 16, 32, 32),     # padding path (80 % 32 != 0)
    (2, 64, 2, 64, 128, 64),
    (1, 100, 2, 8, 16, 256),    # Q = S = 100, not a power of two; P = 8
    (2, 100, 2, 16, 16, 48)]    # Q = 48 and a ragged last chunk of 4


def scaled(rel: float, want) -> dict:
    """rtol ``rel`` and an atol of ``rel`` times the largest |want|."""
    return dict(rtol=rel, atol=rel * float(np.abs(f32(want)).max()))


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def scan_inputs(shape, dtype, seed=0):
    """x, dt, A, B, C as numpy fp32 (x, B, C already rounded to ``dtype``)
    with the draws of tests/test_kernels.py."""
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)

    def rounded(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).float().numpy()

    x = rounded(rng.normal(size=(B, S, H, P)))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    return x, dt, A, rounded(rng.normal(size=(B, S, N))), rounded(rng.normal(size=(B, S, N)))


def port_scan(args, dtype, chunk):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in args)
    return ssd_scan(x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), chunk=chunk)


def jax_args(args, dtype):
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in args)
    return x.astype(dtype), dt, A, Bm.astype(dtype), Cm.astype(dtype)


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_plain_scan_matches_jax_chunked(shape, dtypes):
    B, S, H, P, N, chunk = shape
    args = scan_inputs(shape, dtypes[0])
    y, s = port_scan(args, dtypes[0], chunk)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, S, H, P) and s.shape == (B, H, P, N)
    # JAX's chunked path takes whole chunks: pad S as its ssm_block does
    Q = min(chunk, S)
    pad = (-S) % Q
    x, dt, A, Bm, Cm = jax_args(args, dtypes[1])
    x, dt, Bm, Cm = (jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                     for t in (x, dt, Bm, Cm))
    want_y, want_s = j_ssd_chunked(x, dt, A, Bm, Cm, Q)
    np.testing.assert_allclose(f32(y), f32(want_y[:, :S]), **scaled(CHUNKED, want_y))
    np.testing.assert_allclose(f32(s), f32(want_s), **scaled(CHUNKED, want_s))


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_plain_scan_matches_jax_kernel(shape, dtypes):
    """Against the Pallas kernel (interpret mode on the CPU), whose wrapper
    stores y in x.dtype: the bf16 case compares at the bf16 tolerance."""
    chunk = shape[-1]
    args = scan_inputs(shape, dtypes[0], seed=1)
    y, s = port_scan(args, dtypes[0], chunk)
    want_y, want_s = j_ssd_scan(*jax_args(args, dtypes[1]), chunk=chunk)
    np.testing.assert_allclose(f32(y), f32(want_y), **(
        BF16 if dtypes[0] == torch.bfloat16 else scaled(CHUNKED, want_y)))
    np.testing.assert_allclose(f32(s), f32(want_s), **scaled(CHUNKED, want_s))


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_plain_scan_matches_quadratic_oracle(shape, dtypes):
    args = scan_inputs(shape, dtypes[0], seed=2)
    y, s = port_scan(args, dtypes[0], shape[-1])
    want_y, want_s = j_ssd_ref(*jax_args(args, dtypes[1]))
    np.testing.assert_allclose(f32(y), f32(want_y), **QUADRATIC)
    np.testing.assert_allclose(f32(s), f32(want_s), **QUADRATIC)


# ------------------------------------------------------------ models ----

def published_init(tree, seed=9):
    """A_log and dt_bias of every layer by Mamba-2's published init."""
    rng = np.random.default_rng(seed)
    ssm = tree["blocks"]["ssm"]
    shape = np.shape(ssm["A_log"])
    ssm["A_log"] = np.log(rng.uniform(1, 16, size=shape)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
    ssm["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)  # softplus^-1
    return tree


def pair(dtype="float32", seed=0, published=False, **kw):
    """(JAX cfg, JAX model, JAX params, port model) of the mamba2 smoke
    config on the same weights."""
    jcfg = j_get_config("mamba2_370m").scaled(
        n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, dtype=dtype, **kw)
    jm = j_build_model(jcfg)
    tree = jax.tree.map(np.asarray, j_init_params(jm.specs(), jax.random.key(seed)))
    if published:
        tree = published_init(tree)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, jm, jp, lm_params_from_numpy(port_cfg(jcfg), tree, "cpu")


def tokens(B, S, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])


@pytest.mark.parametrize("S", [40, 48, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_matches_jax(S, dtype):
    """One mixer on carried weights: S 40 (a ragged last chunk), 48 (whole
    chunks) and 7 (one chunk of 7)."""
    jcfg, _, jp, tm = pair(dtype, published=True)
    x = np.random.default_rng(3).normal(size=(2, S, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.tensor(f32(jx)).to(tm.top.embed.dtype)
    want = j_ssm_block(layer0(jp), jcfg, jx)
    got = ssm_block(tm.blocks[0].ssm, tm.cfg, tx)
    assert got.dtype == tx.dtype and got.shape == (2, S, 64)
    np.testing.assert_allclose(f32(got), f32(want), **(FP32 if dtype == "float32" else BF16))


def test_ssm_block_cache_matches_stepping():
    """The final state and conv tail that `ssm_block` hands a prefill equal
    what JAX's `ssm_decode_step` leaves after the same steps."""
    jcfg, _, jp, tm = pair(published=True)
    for S in (40, 2):  # 2 < conv_width - 1: the tail is left-padded
        x = np.random.default_rng(S).normal(size=(2, S, 64)).astype(np.float32)
        _, st, conv = ssm_block(tm.blocks[0].ssm, tm.cfg, torch.from_numpy(x),
                                return_cache=True)
        js = jnp.zeros((2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state))
        jc = jnp.zeros((2, jcfg.conv_width - 1, jcfg.d_inner + 2 * jcfg.ssm_state))
        for i in range(S):
            _, js, jc = j_ssm_decode_step(layer0(jp), jcfg, jnp.asarray(x[:, i:i + 1]), js, jc)
        np.testing.assert_allclose(f32(st), f32(js), **FP32)
        np.testing.assert_array_equal(f32(conv), f32(jc))


def test_ssm_decode_step_matches_jax_and_updates_in_place():
    jcfg, _, jp, tm = pair(published=True)
    rng = np.random.default_rng(4)
    state = rng.normal(size=(3, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state)).astype(np.float32)
    conv = rng.normal(size=(3, jcfg.conv_width - 1, jcfg.d_inner + 2 * jcfg.ssm_state)).astype(np.float32)
    ts, tc = torch.from_numpy(state.copy()), torch.from_numpy(conv.copy())
    js, jc = jnp.asarray(state), jnp.asarray(conv)
    for step in range(3):
        x = rng.normal(size=(3, 1, 64)).astype(np.float32)
        want, js, jc = j_ssm_decode_step(layer0(jp), jcfg, jnp.asarray(x), js, jc)
        got, ts2, tc2 = ssm_decode_step(tm.blocks[0].ssm, tm.cfg, torch.from_numpy(x), ts, tc)
        assert ts2 is ts and tc2 is tc  # the cache is written where it lies
        np.testing.assert_allclose(f32(got), f32(want), **FP32)
        np.testing.assert_allclose(f32(ts), f32(js), **FP32)
        np.testing.assert_allclose(f32(tc), f32(jc), **FP32)


@pytest.mark.parametrize("use_ssd_kernel", [False, True])
@pytest.mark.parametrize("published", [False, True])
def test_forward_matches_jax(use_ssd_kernel, published):
    _, jm, jp, tm = pair(published=published, use_ssd_kernel=use_ssd_kernel)
    tok = tokens(2, 40)
    want, _ = jm.forward(jp, jnp.asarray(tok))
    got, aux = tm.forward(torch.from_numpy(tok))
    assert float(aux) == 0.0 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(f32(got), f32(want), **FP32)


def test_bf16_forward_matches_jax():
    _, jm, jp, tm = pair("bfloat16", seed=4, published=True)
    tok = tokens(2, 24, seed=5)
    want, _ = jm.forward(jp, jnp.asarray(tok))
    got, _ = tm.forward(torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


@pytest.mark.parametrize("S", [20, 32, 2])
def test_prefill_matches_jax_stepping(S):
    """Logits, states and conv tails of the chunked prefill against JAX's
    token-by-token prefill: S 20 (not a multiple of the chunk), 32 (two
    whole chunks), 2 (shorter than conv_width - 1)."""
    _, jm, jp, tm = pair(published=True)
    tok = tokens(3, S, seed=S)
    want_lg, want_c = jm.prefill(jp, jnp.asarray(tok), cache_len=S + 4)
    got_lg, got_c = tm.prefill(torch.from_numpy(tok), cache_len=S + 4)
    assert got_lg.shape == (3, 1, 256)
    np.testing.assert_allclose(f32(got_lg), f32(want_lg), **FP32)
    for name in ("state", "conv"):
        assert got_c["blocks"][name].shape == want_c["blocks"][name].shape
        assert got_c["blocks"][name].dtype == torch.float32
        np.testing.assert_allclose(f32(got_c["blocks"][name]),
                                   f32(want_c["blocks"][name]), **FP32)


def test_prefill_then_serve_steps_match_jax():
    """Greedy tokens after a prefill: JAX's prefill step + serve steps
    against the port's, on the same weights."""
    jcfg, jm, jp, tm = pair(seed=2, published=True)
    B, S, gen = 3, 21, 8
    tok = tokens(B, S, seed=6)
    j_step = jax.jit(j_make_serve_step(jm, jcfg))
    j_logits = j_make_prefill_step(jm, jcfg)(jp, jnp.asarray(tok))
    _, jc = jm.prefill(jp, jnp.asarray(tok), cache_len=S + gen)
    nxt = jnp.argmax(j_logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [np.asarray(nxt)]
    for i in range(gen - 1):
        nxt, _, jc = j_step(jp, jc, nxt, jnp.int32(S + i))
        want.append(np.asarray(nxt))

    prefill, step = make_prefill_step(tm, tm.cfg), make_serve_step(tm, tm.cfg)
    lg, tc = prefill(torch.from_numpy(tok))
    np.testing.assert_allclose(f32(lg), f32(j_logits), **FP32)
    nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    got = [nxt.numpy()]
    for i in range(gen - 1):
        nxt, logits, tc = step(tc, nxt, S + i)
        assert nxt.dtype == torch.int32 and logits.shape == (B, 1, 256)
        got.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))


def test_decode_matches_forward():
    """Decode logits step by step == the chunked forward's (the duality
    inside the port, as tests/test_models.py:113), with a carried state
    that counts and a prompt over three chunks."""
    _, _, _, tm = pair(published=True)
    tok = torch.from_numpy(tokens(2, 40, seed=8))
    full, _ = tm.forward(tok)
    cache = serve_cli.zero_cache(tm, tm.cfg, 2, 40)
    outs = [tm.decode_step(cache, tok[:, i:i + 1], i)[0][:, 0] for i in range(40)]
    np.testing.assert_allclose(f32(torch.stack(outs, 1)), f32(full), **FP32)


@pytest.mark.parametrize("n_slots", [1, 2])
def test_continuous_batching_matches_jax(n_slots):
    """The batcher on ssm caches (template tests/test_serving.py:148)."""
    jcfg, jm, jp, tm = pair(seed=6, published=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (3, 6, 9, 2)]
    jeng = JBatcher(jm, jcfg, jp, n_slots=n_slots, cache_len=24)
    teng = ContinuousBatcher(tm, tm.cfg, n_slots=n_slots, cache_len=24, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid, p, 5))
        teng.submit(Request(rid, p, 5))
    want, got = jeng.run(), teng.run()
    assert got == want
    assert teng.occupancy == jeng.occupancy


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_round_trip_bit_exact(dtype):
    _, _, jp, tm = pair(dtype)
    want = jax.tree.map(np.asarray, jp)
    got = lm_params_to_numpy(tm)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g) == 13
    for path, w in flat_w:
        g = flat_g[path]
        assert g.shape == w.shape, path
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g, w.view(np.uint16), err_msg=str(path))
        else:  # A_log, dt_bias, D, norm and the norms stay fp32
            assert g.dtype == np.float32, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    again = lm_params_to_numpy(lm_params_from_numpy(tm.cfg, got, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, again, got)


def test_full_config_matches_jax():
    jcfg = j_get_config("mamba2_370m")
    cfg = get_config("mamba2-370m")
    assert port_cfg(jcfg) == cfg
    assert (cfg.d_inner, cfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads) == (2048, 32)
    assert count_params(lm_specs(cfg)) == j_count_params(j_build_model(jcfg).specs())
    assert port_cfg(j_get_config("mamba2_370m").scaled(
        n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16)) == get_smoke_config("mamba2_370m")


def test_cache_specs_match_jax():
    jcfg, jm, _, tm = pair()
    want = jm.cache_specs(3, 17)
    got = tm.cache_specs(3, 17)
    for name in ("state", "conv"):
        w, g = want["blocks"][name], got["blocks"][name]
        assert (g.shape, g.axes, g.dtype, g.init) == (w.shape, w.axes, w.dtype, w.init)


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_driver_runs_on_cpu(continuous, capsys):
    args = ["--arch", "mamba2-370m", "--smoke", "--batch", "2",
            "--prompt-len", "6", "--gen", "5", "--device", "cpu"]
    out = serve_cli.main(args + (["--continuous"] if continuous else []))
    assert "on CPU" in capsys.readouterr().out
    if continuous:
        assert len(out) == 5 and all(len(v) == 5 for v in out.values())
    else:
        assert out.shape == (2, 5) and out.dtype == torch.int32


def test_smoke_model_builds_from_the_registry():
    m = build_model(get_smoke_config("mamba2-370m"), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert m.top.embed.dtype == torch.bfloat16
    assert m.blocks[0].ssm.A_log.dtype == torch.float32
    lg, cache = make_prefill_step(m, m.cfg)(torch.zeros((2, 5), dtype=torch.int32))
    assert lg.shape == (2, 1, 256) and cache["blocks"]["conv"].dtype == torch.bfloat16
