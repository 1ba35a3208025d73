"""Port parity: the dense LM against the JAX package on carried weights.

The JAX `LM` is built with ``use_flash_kernel`` and ``use_flash_decode``
so that both sides compute the kernels' casts (the JAX default path,
`blockwise_attention`, rounds q * scale to the input dtype and differs by
design).  Its parameters cross as numpy arrays through
`carry.lm_params_from_numpy`.  fp32 tolerance 1e-4: the sums run in
another order through 2 layers and a tied head; bf16 tolerance 2e-2, that
of `tests/test_kernels.py:29`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.params import count_params as j_count_params
from repro.models.params import init_params as j_init_params
from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import build_model, count_params, init_params
from repro_torch.models.config import ModelConfig

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def pair(dtype="float32", seed=0, **kw):
    """(JAX cfg, JAX model, JAX params, port model) on the same weights."""
    jcfg = j_get_config("smollm_135m").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, dtype=dtype, use_flash_kernel=True,
        use_flash_decode=True, **kw)
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(seed))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm


def tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S)).astype(np.int32)


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_round_trip_bit_exact(dtype):
    _, _, jp, tm = pair(dtype)
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
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    # the numpy tree loads again, bit for bit
    again = lm_params_to_numpy(lm_params_from_numpy(tm.cfg, got, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, again, got)


SMOKE_WIDTHS = {  # the port's smoke() configs, as scalings of the JAX configs
    "smollm_135m": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab=256),
    "gemma_2b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                     head_dim=32, d_ff=256, vocab=256),
    "minitron_8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=192, vocab=256),
    "mamba2_370m": dict(n_layers=2, d_model=64, vocab=256, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16),
    "granite_moe_1b_a400m": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                 head_dim=16, d_ff=64, vocab=256, n_experts=8,
                                 top_k=4),
}


def test_specs_and_counts_match_jax():
    """The supported archs' configs, smoke configs, spec trees and counts
    equal the JAX package's; every other arch raises with a ROADMAP pointer."""
    for arch, widths in SMOKE_WIDTHS.items():
        jcfg = j_get_config(arch)
        cfg = get_config(arch)
        assert port_cfg(jcfg) == cfg
        assert port_cfg(jcfg.scaled(**widths)) == get_smoke_config(arch)
        tm_specs = build_model(get_smoke_config(arch), device="cpu").specs()
        j_specs = j_build_model(jcfg.scaled(**widths)).specs()
        assert count_params(tm_specs) == j_count_params(j_specs)
        assert set(tm_specs) == set(j_build_model(jcfg).specs())
        assert set(tm_specs["blocks"]) == set(j_specs["blocks"])
    for arch in ARCH_IDS:
        if arch not in SMOKE_WIDTHS:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_config(arch)
    # llama3-405b: its smoke config runs, the full model stays with A13
    from repro_torch.configs import llama3_405b
    assert port_cfg(j_get_config("llama3_405b")) == llama3_405b.CONFIG
    assert port_cfg(j_get_config("llama3_405b").scaled(**LLAMA3_SMOKE)) == \
        get_smoke_config("llama3-405b")
    with pytest.raises(NotImplementedError, match="does not fit one card.*A13"):
        get_config("llama3-405b")
    for arch in ARCH_IDS:
        if arch not in SMOKE_WIDTHS and arch != "llama3_405b":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_smoke_config(arch)


LLAMA3_SMOKE = dict(n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
                    d_ff=384, vocab=512)
# (arch, the published parameter count the JAX package's specs give)
DENSE_FULL = [("gemma_2b", 2_506_172_416), ("minitron_8b", 9_882_046_464),
              ("llama3_405b", 405_853_388_800)]


@pytest.mark.parametrize("arch,n_params", DENSE_FULL)
def test_dense_family_full_configs_match_jax(arch, n_params):
    """Every field of the full config and the parameter count of its spec
    tree (no weights allocated) equal the JAX package's."""
    import importlib

    from repro_torch.models.lm import lm_specs

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    jcfg = j_get_config(arch)
    assert port_cfg(jcfg) == cfg
    assert count_params(lm_specs(cfg)) == j_count_params(j_build_model(jcfg).specs()) \
        == n_params


@pytest.mark.parametrize("arch", ["gemma_2b", "minitron_8b", "llama3_405b"])
def test_dense_family_smoke_parity(arch):
    """The arch's smoke config in fp32 on carried weights: forward logits,
    prefill logits and cache, and 6 greedy decode steps equal the JAX
    package's on its default jnp attention (in fp32 the kernels' casts and
    the blockwise path's rounding of q * scale are one rounding apart)."""
    jcfg = j_get_config(arch).scaled(
        **(SMOKE_WIDTHS.get(arch) or LLAMA3_SMOKE), dtype="float32")
    assert port_cfg(jcfg) == get_smoke_config(arch).scaled(dtype="float32")
    jm = j_build_model(jcfg)
    jp = j_init_params(jm.specs(), jax.random.key(11))
    tm = lm_params_from_numpy(port_cfg(jcfg), jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(12).integers(0, jcfg.vocab, size=(2, 10)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(tok))
    got, _ = tm.forward(torch.from_numpy(tok))
    np.testing.assert_allclose(f32(got), f32(want), **FP32)
    want_lg, jc = jm.prefill(jp, jnp.asarray(tok), cache_len=16)
    got_lg, tc = tm.prefill(torch.from_numpy(tok), cache_len=16)
    np.testing.assert_allclose(f32(got_lg), f32(want_lg), **FP32)
    np.testing.assert_allclose(f32(tc["blocks"]["v"]), f32(jc["blocks"]["v"]), **FP32)
    j_nxt = jnp.argmax(want_lg[:, -1:], axis=-1).astype(jnp.int32)
    t_nxt = torch.argmax(got_lg[:, -1:], dim=-1).to(torch.int32)
    for i in range(6):
        assert np.array_equal(np.asarray(j_nxt), t_nxt.numpy()), i
        want, jc = jm.decode_step(jp, jc, j_nxt, jnp.int32(10 + i))
        got, tc = tm.decode_step(tc, t_nxt, 10 + i)
        np.testing.assert_allclose(f32(got), f32(want), **FP32)
        j_nxt = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        t_nxt = torch.argmax(got[:, -1:], dim=-1).to(torch.int32)


def test_init_params_draws_seeded_normals():
    cfg = get_smoke_config("smollm-135m")
    m = build_model(cfg, device="cpu")
    specs = m.specs()
    a = init_params(specs, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(specs, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["embed"], b["embed"]) and a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    std = a["blocks"]["attn"]["w_q"].float().std().item()
    assert 0.018 < std < 0.022          # normal x 0.02
    assert a["blocks"]["attn"]["w_q"].shape == (cfg.n_layers, 64, 4 * 16)


def test_forward_matches_jax():
    _, jm, jp, tm = pair()
    tok = tokens(2, 24)
    want, _ = jm.forward(jp, jnp.asarray(tok))
    got, aux = tm.forward(torch.from_numpy(tok))
    assert float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), **FP32)


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_matches_jax(fused):
    _, jm, jp, tm = pair(fused_prefill_kv=fused)
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
    for step in range(2):                # the second step reads the first's insert
        want, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), j_idx)
        got, tc = tm.decode_step(tc, torch.from_numpy(nxt), t_idx)
        np.testing.assert_allclose(f32(got), f32(want), **FP32)
        j_idx, t_idx = j_idx + 1, t_idx + 1
    np.testing.assert_allclose(f32(tc["blocks"]["k"]), f32(jc["blocks"]["k"]), **FP32)


def test_decode_matches_forward():
    """Greedy decode logits == teacher-forced forward logits (the cached
    path against the full-sequence path, as tests/test_models.py:113)."""
    _, _, _, tm = pair()
    tok = torch.from_numpy(tokens(1, 12))
    full, _ = tm.forward(tok)
    cache = {"blocks": {k: torch.zeros(2, 1, 12, 2, 16) for k in ("k", "v")}}
    outs = [tm.decode_step(cache, tok[:, i:i + 1], i)[0][:, 0] for i in range(12)]
    np.testing.assert_allclose(f32(torch.stack(outs, 1)), f32(full), **FP32)


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
