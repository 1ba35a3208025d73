"""Port parity: the attention kernels' CPU path against the JAX kernels.

The same seeded numpy inputs go through the JAX Pallas kernels (interpret
mode on the CPU, as `tests/test_kernels.py` runs them) and through the
port's wrappers on CPU tensors, which take the plain PyTorch versions.
Tolerances are those of `tests/test_kernels.py:29`: 2e-5 in fp32 (sums
in another order), 2e-2 in bf16 (the JAX kernel rounds each tile's PV
product to bf16, the port keeps it in fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash_attention
from repro.kernels.flash_decode.ops import flash_decode as j_flash_decode
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ops import flash_decode

ATTN_SHAPES = [
    # (B, Sq, Skv, H, K, D), as tests/test_kernels.py:37
    (1, 64, 64, 4, 4, 64),
    (2, 128, 128, 8, 2, 64),
    (1, 96, 96, 4, 1, 128),
    (1, 32, 128, 4, 2, 64),
    (2, 64, 64, 4, 4, 256),
]

FD_SHAPES = [
    # (B, S, H, K, D, cache_len, block_kv), as tests/test_kernels.py:262
    (2, 128, 8, 2, 64, 128, 32),
    (1, 256, 4, 4, 64, 100, 64),
    (2, 96, 4, 1, 128, 50, 32),
    (1, 64, 8, 8, 64, 1, 64),
]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def both(rng, shape, name):
    """One seeded array as a JAX array and as a CPU tensor of equal values
    (bf16 rounded once, by JAX, and carried bit for bit)."""
    jdt, tdt = DTYPES[name]
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype=jdt)
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    return x, t


def as_np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32),
                      np.float32)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 48)])
def test_flash_attention_matches_jax(shape, dtype, causal, window):
    B, Sq, Skv, H, K, D = shape
    rng = np.random.default_rng(42)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng, s, dtype) for s in
                                    [(B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)])
    want = j_flash_attention(jq, jk, jv, causal=causal, window=window,
                             block_q=32, block_kv=32)
    before = fa_ops.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, H, D)
    assert fa_ops.launches == before      # the CPU path launches no kernel
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))


@pytest.mark.parametrize("shape", FD_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_matches_jax(shape, dtype):
    B, S, H, K, D, clen, bkv = shape
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng, s, dtype) for s in
                                    [(B, 1, H, D), (B, S, K, D), (B, S, K, D)])
    want = j_flash_decode(jq, jk, jv, clen, scale=D ** -0.5, block_kv=bkv)
    before = fd_ops.launches
    got = flash_decode(tq, tk, tv, clen, scale=D ** -0.5)
    assert got.dtype == tq.dtype and got.shape == (B, 1, H, D)
    assert fd_ops.launches == before
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))


@pytest.mark.parametrize("lens_kind", ["numpy", "tensor"])
def test_flash_decode_per_sequence_lens(lens_kind):
    """Per-sequence cache lengths (continuous batching) mask correctly."""
    B, S, H, K, D = 3, 64, 4, 2, 64
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng, s, "float32") for s in
                                    [(B, 1, H, D), (B, S, K, D), (B, S, K, D)])
    lens = np.asarray([5, 33, 64], np.int32)
    want = j_flash_decode(jq, jk, jv, jnp.asarray(lens), scale=D ** -0.5, block_kv=16)
    got = flash_decode(tq, tk, tv, lens if lens_kind == "numpy" else torch.from_numpy(lens),
                       scale=D ** -0.5)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol("float32"))


@pytest.mark.parametrize("make,ready", [
    (lambda x: x, True),                                   # contiguous (2, 8, 6, 64)
    (lambda x: x[:, :, :3], True),                         # a slice of heads
    (lambda x: x.view(-1)[8:8 + 7 * 6 * 64].view(1, 7, 6, 64), True),   # 16 bytes off
    (lambda x: x.view(-1)[4:4 + 7 * 6 * 64].view(1, 7, 6, 64), False),  # 8 bytes off
    (lambda x: x.transpose(1, 2), True),                   # strides still multiples of 8
    (lambda x: x.view(2, 8, 6 * 64)[..., 4:4 + 5 * 64].view(2, 8, 5, 64), False)])
def test_bf16_chunk_eligibility(make, ready):
    """The bf16 body moves q, k and v in 16-byte chunks: a 16-byte aligned
    base and strides that are multiples of 8 elements, else the wrapper
    copies."""
    from repro_torch.kernels.flash_attention.ops import chunk_ready

    x = torch.zeros((2, 8, 6, 64), dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert chunk_ready(make(x)) is ready
