"""The kernels' shared host pieces on the CPU: `_wrap.Counts`, which every
``ops`` module serves its counts through, and `_wrap.plain_grad`, the
plain-recompute gradient of the three autograd Functions."""
import importlib
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import _wrap
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

KERNELS = ["cutout_gather", "flash_attention", "flash_decode", "moe_gemm", "morton_matmul",
           "ssd_scan"]


def test_counts_keep_every_add_from_threads():
    """Adds from more threads than cores, switching often, are all counted."""
    counts = _wrap.Counts("m", "launches", "other")
    threads, adds = 32, 2000
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(adds):
            counts.add("launches")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert counts.get("launches") == threads * adds and counts.get("other") == 0


def test_counts_reset_zeroes_every_count_and_name_only_their_own():
    counts = _wrap.Counts("pkg.ops", "launches", "backward_plain")
    counts.add("launches")
    counts.add("backward_plain")
    counts.add("backward_plain")
    assert (counts.get("launches"), counts.get("backward_plain")) == (1, 2)
    counts.reset()
    assert (counts.get("launches"), counts.get("backward_plain")) == (0, 0)
    with pytest.raises(AttributeError, match="'pkg.ops' has no attribute 'other'"):
        counts.get("other")
    with pytest.raises(KeyError):
        counts.add("other")


@pytest.mark.parametrize("kernel", KERNELS)
def test_ops_module_serves_its_counts_as_attributes(kernel):
    """``ops.launches`` (and each other count) reads the module's count, and
    ``ops.reset_launches()`` zeroes every one."""
    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    names = list(ops._counts._counts)
    assert names[0] == "launches"
    for name in names:
        ops._counts.add(name)
        assert getattr(ops, name) >= 1
    ops.reset_launches()
    assert ops.launches == 0 and all(getattr(ops, n) == 0 for n in names)
    assert not hasattr(ops, "no_such_count")


def _tensors(rng, *shapes, dtype=torch.float32):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3).to(dtype)
            for s in shapes]


def _attention(rng):
    q, k, v = _tensors(rng, (2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    (dout,) = _tensors(rng, (2, 12, 4, 16))
    return flash_attention_ref, (q, k, v), (dout,), dict(causal=True, scale=0.25, window=5)


def _moe(rng):
    E, C, d, f = 3, 8, 16, 24
    x, wg, wu, wd = _tensors(rng, (E, C, d), (E, d, f), (E, d, f), (E, f, d))
    counts = torch.tensor([0, 5, C + 2], dtype=torch.int32)
    (dy,) = _tensors(rng, (E, C, d))
    return moe_gemm_ref, (x, wg, wu, wd, counts), (dy,), {}


def _scan(rng, with_state):
    Bsz, S, H, P, N = 2, 24, 3, 8, 16
    x, Bm, Cm = _tensors(rng, (Bsz, S, H, P), (Bsz, S, N), (Bsz, S, N))
    dt = torch.nn.functional.softplus(*_tensors(rng, (Bsz, S, H)))
    A = -torch.exp(*_tensors(rng, (H,)))
    dy, dstate = _tensors(rng, (Bsz, S, H, P), (Bsz, H, P, N))
    return ssd_scan_ref, (x, dt, A, Bm, Cm), (dy, dstate if with_state else None), dict(chunk=8)


CASES = {
    "attention, all": (_attention, (True, True, True)),
    "attention, k only": (_attention, (False, True, False)),
    "moe, weights but x": (_moe, (False, True, True, True, False)),
    "moe, x and down": (_moe, (True, False, False, True, False)),
    "scan, state dropped": (lambda rng: _scan(rng, False), (True, True, True, True, True)),
    "scan, state dropped, dt and C": (lambda rng: _scan(rng, False),
                                      (False, True, False, False, True)),
    "scan, state given, x and A": (lambda rng: _scan(rng, True),
                                   (True, False, True, False, False)),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_plain_grad_is_autograds_gradient_through_the_ref(case):
    """`plain_grad` is bit for bit `torch.autograd.grad` through the plain
    version at the saved inputs, over the outputs with a cotangent, for the
    inputs it needs; None for the others; the saved tensors untouched."""
    build, needs = CASES[case]
    ref, saved, cots, kw = build(np.random.default_rng(34))
    got = _wrap.plain_grad(ref, saved, needs, cots, **kw)
    assert all(not t.requires_grad for t in saved)
    ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    outs = ref(*ins, **kw)
    outs = (outs,) if isinstance(outs, torch.Tensor) else outs
    kept = [(o, g) for o, g in zip(outs, cots) if g is not None]
    want = iter(torch.autograd.grad([o for o, _ in kept], [t for t in ins if t.requires_grad],
                                    [g for _, g in kept]))
    assert len(got) == len(saved)
    for g, n in zip(got, needs):
        if n:
            w = next(want)
            assert g.shape == w.shape and torch.equal(g, w)
        else:
            assert g is None
