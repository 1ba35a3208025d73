"""The split-bf16 arithmetic of `ssd_scan`'s tensor-core body, on the CPU.

`ssd_scan_split_ref` repeats the bf16 body's roundings in plain PyTorch:
x, B and C enter the products as the bf16 values they are, and every
operand the body forms in fp32 (G' = (C . B^T) o L o dt, the carried
state S, and x o w of the state update) is split into hi + lo bf16 and
multiplied twice.  The same numpy inputs go through it, through the port's
fp32 plain scan and through the JAX package's quadratic oracle `ssd_ref`
and chunked Pallas kernel (interpret mode, fed the bf16 values as fp32, so
that its wrapper's bf16 store of y does not round them), and all are held
at the card tests' `ssd_tol`: rtol 1e-4 and 1e-4 of max |out|.  One case
rounds each operand once (no lo terms) and records that this lands outside
that tolerance at Mamba-2's published A and dt ranges.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro_torch.kernels.ssd_scan.ref import (split_bf16, ssd_scan_ref,
                                              ssd_scan_split_ref)
from test_torch_cuda import ssd_tol

SHAPES = [  # (B, S, H, P, N, chunk): mamba2-370m's P, N and Q at small B, H, S
    (1, 256, 2, 64, 128, 256),   # one whole chunk
    (1, 300, 2, 64, 128, 256),   # a ragged last chunk of 44
    (2, 600, 2, 64, 128, 256)]   # two chunks carried, then 88 rows
WIDTHS = [  # (B, S, H, P, N, chunk): the other widths the bf16 body is built for
    (1, 300, 2, 128, 64, 256), (1, 300, 2, 96, 48, 256),
    (1, 300, 2, 96, 128, 256), (1, 300, 2, 48, 96, 256)]
DRAWS = ["jax", "published"]


def inputs(shape, draws, seed):
    """x, dt, A, B, C as fp32 tensors, x, B and C holding bf16 values.
    ``jax``: the draws of tests/test_kernels.py:185; ``published``:
    Mamba-2's init, A in -[1, 16] and dt log-uniform in [1e-3, 1e-1]."""
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    x = bf16(rng.normal(size=(B, S, H, P)))
    Bm, Cm = bf16(rng.normal(size=(B, S, N))), bf16(rng.normal(size=(B, S, N)))
    if draws == "published":
        A = -rng.uniform(1, 16, size=H)
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(B, S, H)))
    else:
        A = -np.exp(rng.normal(size=H) * 0.5)
        dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    return x, torch.from_numpy(dt.astype(np.float32)), torch.from_numpy(
        A.astype(np.float32)), Bm, Cm


def assert_within(got, want):
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, dtype=np.float32))
        torch.testing.assert_close(g, w, **ssd_tol(w))


@pytest.mark.parametrize("shape", SHAPES + WIDTHS)
@pytest.mark.parametrize("draws", DRAWS)
def test_split_matches_the_plain_scan(shape, draws):
    args = inputs(shape, draws, seed=0)
    got = ssd_scan_split_ref(*args, chunk=shape[-1])
    assert got[0].shape == args[0].shape and got[1].shape == (*shape[:1], *shape[2:5])
    assert_within(got, ssd_scan_ref(*args, chunk=shape[-1]))


@pytest.mark.parametrize("shape", SHAPES + WIDTHS)
@pytest.mark.parametrize("draws", DRAWS)
def test_split_matches_the_jax_quadratic_oracle(shape, draws):
    args = inputs(shape, draws, seed=1)
    got = ssd_scan_split_ref(*args, chunk=shape[-1])
    assert_within(got, j_ssd_ref(*(jnp.asarray(a.numpy()) for a in args)))


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("draws", DRAWS)
def test_split_matches_the_jax_kernel(shape, draws):
    args = inputs(shape, draws, seed=2)
    got = ssd_scan_split_ref(*args, chunk=shape[-1])
    want = j_ssd_scan(*(jnp.asarray(a.numpy()) for a in args), chunk=shape[-1])
    assert_within(got, want)


def test_bf16_inputs_are_taken_as_they_are():
    """bf16 x, B and C give what their fp32 copies give: the body's C . B^T
    and its x and B operands are exact."""
    args = inputs(SHAPES[1], "published", seed=3)
    low = [a.bfloat16() if i in (0, 3, 4) else a for i, a in enumerate(args)]
    for g, w in zip(ssd_scan_split_ref(*low), ssd_scan_split_ref(*args)):
        assert torch.equal(g, w)


def test_rounding_once_misses_the_check():
    """Why the lo terms are there: rounding G', S and x o w to bf16 once
    puts y and the state ~2e-3 of their max |out| from the plain scan at
    the published ranges, past the 1e-4 check; the split stays within."""
    shape = SHAPES[2]
    args = inputs(shape, "published", seed=4)
    want = ssd_scan_ref(*args, chunk=shape[-1])
    once = ssd_scan_split_ref(*args, chunk=shape[-1], lo_terms=False)
    split = ssd_scan_split_ref(*args, chunk=shape[-1])
    for o, s, w in zip(once, split, want):
        top = float(w.abs().max())
        assert float((o - w).abs().max()) > 1e-4 * top * 5
        assert float((s - w).abs().max()) < 1e-4 * top / 5
        with pytest.raises(AssertionError):
            torch.testing.assert_close(o, w, **ssd_tol(w))


def test_split_keeps_sixteen_bits():
    """hi + lo carries v to within 2^-16 of |v|, and hi alone to 2^-8."""
    v = torch.from_numpy(np.random.default_rng(5).normal(size=4096).astype(np.float32))
    v = v * torch.exp2(torch.arange(4096, dtype=torch.float32) % 40 - 20)
    hi, lo = split_bf16(v)
    assert bool(((hi + lo - v).abs() <= v.abs() * 2.0 ** -16).all())
    assert bool(((hi - v).abs() <= v.abs() * 2.0 ** -8).all())
    assert bool((split_bf16(v, lo_terms=False)[1] == 0).all())
