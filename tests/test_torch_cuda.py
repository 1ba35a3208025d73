"""The port on the card: kernel against plain version, card against CPU.

Marked ``gpu``; every test skips without a CUDA card.  Run on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import cutout as tcut
from repro_torch.core import morton
from repro_torch.core.cuboid import CuboidGrid, DatasetSpec
from repro_torch.core.store import DeviceCuboidStore
from repro_torch.kernels.cutout_gather import ops
from repro_torch.kernels.cutout_gather.ref import cutout_gather_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.morton_matmul import ops as mm_ops
from repro_torch.kernels.morton_matmul.ref import morton_matmul_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_split_ref
from repro_torch.vision import synapse_detector as sd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(packed, grid, lo, hi):
    gshape, cells, alo = ops.build_plan(grid, lo, hi)
    args = (packed, torch.from_numpy(cells).to(packed.device), gshape,
            [l - a for l, a in zip(lo, alo)], [h - l for l, h in zip(lo, hi)])
    return ops.cutout_gather_cuda(*args), cutout_gather_ref(*args)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32,
                                   torch.float32, torch.int64])
@pytest.mark.parametrize("cs", [(128, 128, 16), (64, 64, 64), (8, 8, 3)])
def test_gather_kernel_matches_plain(cuda, dtype, cs):
    grid = CuboidGrid((3 * cs[0] - 5, 2 * cs[1] + 3, 4 * cs[2] - 1), cs)
    gen = torch.Generator(device=cuda).manual_seed(1)
    packed = torch.randint(0, 256, (grid.n_cells,) + cs[:2]
                           + (cs[2] * dtype.itemsize,), generator=gen,
                           device=cuda, dtype=torch.uint8).view(dtype)
    v = grid.volume_shape
    before = ops.launches
    for lo, hi in [((0, 0, 0), v), ((0, 0, 0), (cs[0], cs[1], 2 * cs[2])),
                   ((5, 3, 2), (v[0] - 9, v[1] - 4, v[2] - 7)),
                   ((v[0] - 1, 7, 1), (v[0], 8, 2))]:
        got, want = _both(packed, grid, lo, hi)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert ops.launches == before + 4


def test_gather_reads_past_byte_2_31(cuda):
    """Cells whose byte offset exceeds 2^31 (64-bit offsets in the kernel)."""
    grid = CuboidGrid((128 * 32, 128 * 32, 16 * 16), (128, 128, 16))
    assert grid.n_cells == 16384         # 4 GiB of uint8 cuboids
    packed = torch.zeros((grid.n_cells,) + grid.cuboid_shape,
                         dtype=torch.uint8, device=cuda)
    cells = np.arange(8192, 8192 + 64)   # an aligned Morton run past 2^31 B
    packed[8192:8256] = torch.randint(1, 256, (64,) + grid.cuboid_shape,
                                      dtype=torch.uint8, device=cuda)
    coords = morton.morton_decode(cells, grid.bits)
    cs = grid.cuboid_shape
    lo = tuple(int(c) * s + 3 for c, s in zip(coords.min(0), cs))
    hi = tuple(int(c + 1) * s - 2 for c, s in zip(coords.max(0), cs))
    got, want = _both(packed, grid, lo, hi)
    assert torch.equal(got, want) and bool(want.all())


@pytest.mark.parametrize("case", [
    dict(vol=(64, 200), cs=(16, 64), dtype="uint32",
         boxes=[((3, 0), (4, 200)), ((16, 0), (32, 200)), ((5, 17), (40, 133))]),
    dict(vol=(300,), cs=(64,), dtype="float32", boxes=[((0,), (300,)), ((7,), (250,))])])
def test_cutout_of_rank_below_3_on_the_card_matches_plain(cuda, case):
    """A 2-D uint32 store (the training pipeline's tokens: whole rows and a
    ragged box) and a 1-D one, cut out through the kernel: the plain
    gather's bytes and the stored values.  The kernel takes rank-3 grids;
    the wrapper pads the grid with leading unit axes."""
    spec = DatasetSpec("t", case["vol"], dtype=case["dtype"], base_cuboid=case["cs"],
                       scaled_dims=())
    rng = np.random.default_rng(4)
    data = (rng.integers(0, 2 ** 32, size=case["vol"], dtype=np.uint64).astype(np.uint32)
            if case["dtype"] == "uint32" else
            rng.normal(size=case["vol"]).astype(np.float32))
    store = DeviceCuboidStore(spec, device=cuda)
    tcut.ingest(store, 0, data)
    grid, packed = spec.grid(0), store.peek(0)
    for lo, hi in case["boxes"]:
        before = ops.launches
        got = tcut.cutout(store, 0, lo, hi)
        assert ops.launches == before + 1
        gshape, cells, alo = ops.build_plan(grid, lo, hi)
        want = cutout_gather_ref(packed, torch.from_numpy(cells).to(cuda), gshape,
                                 [l - a for l, a in zip(lo, alo)],
                                 [h - l for l, h in zip(lo, hi)])
        assert got.shape == want.shape and torch.equal(got, want)
        box = tuple(slice(l, h) for l, h in zip(lo, hi))
        assert np.array_equal(got.cpu().numpy().view(data.dtype), data[box])


def test_detect_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    vol = rng.normal(100, 3, size=(48, 48, 16)).astype(np.float32)
    xx, yy, zz = np.ogrid[:48, :48, :16]
    for _ in range(6):
        c = [rng.integers(6, s - 6) for s in vol.shape]
        vol += 80.0 * np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2
                               + ((zz - c[2]) * 2) ** 2) / 8.0)
    dc, lc = sd.detect_synapses(torch.from_numpy(vol).to(cuda), min_voxels=4)
    dh, lh = sd.detect_synapses(torch.from_numpy(vol), min_voxels=4)
    assert torch.equal(lc.cpu(), lh) and len(dc) == len(dh) >= 3
    for a, b in zip(dc, dh):
        assert (a.n_voxels, a.bbox_lo, a.bbox_hi, a.centroid) == \
            (b.n_voxels, b.bbox_lo, b.bbox_hi, b.centroid)
        assert abs(a.confidence - b.confidence) <= 1e-6


def test_store_on_card_matches_cpu(cuda):
    spec = DatasetSpec("em", (100, 70, 40), n_resolutions=3, dtype="uint8",
                       base_cuboid=(32, 16, 8))
    vol = np.random.default_rng(0).integers(0, 255, size=spec.volume_shape,
                                            dtype=np.uint8)
    stores = []
    for dev in (cuda, torch.device("cpu")):
        s = DeviceCuboidStore(spec, device=dev)
        tcut.ingest(s, 0, vol)
        tcut.write_cutout(s, 0, (90, 3, 30), np.full((20, 9, 15), 7, np.uint8),
                          discipline="preserve")
        tcut.build_hierarchy(s)
        stores.append(s)
    for r in range(3):
        shape = spec.grid(r).volume_shape
        assert torch.equal(tcut.cutout(stores[0], r, (0, 0, 0), shape).cpu(),
                           tcut.cutout(stores[1], r, (0, 0, 0), shape))


# ------------------------------------------------- attention kernels ----

ATTN_SHAPES = [  # (B, Sq, Skv, H, K, D): tests/test_kernels.py:37, smollm
    (1, 64, 64, 4, 4, 64), (2, 128, 128, 8, 2, 64), (1, 96, 96, 4, 1, 128),
    (1, 32, 128, 4, 2, 64), (2, 64, 64, 4, 4, 256), (2, 200, 200, 9, 3, 64),
    (2, 40, 40, 4, 2, 16), (1, 70, 70, 8, 1, 32),
    (2, 256, 256, 16, 8, 64),  # granite-moe-1b-a400m's heads
    (1, 2048, 2048, 9, 3, 64),  # smollm's prefill length and heads (21 queries a block)
    (2, 128, 128, 8, 1, 256)]  # D 256 with 8 query heads per kv head (gemma-2b)
FD_SHAPES = [  # (B, S, H, K, D, cache_len): tests/test_kernels.py:262, smollm
    (2, 128, 8, 2, 64, 128), (1, 256, 4, 4, 64, 100), (2, 96, 4, 1, 128, 50),
    (1, 64, 8, 8, 64, 1), (4, 2176, 9, 3, 64, 2100), (2, 512, 8, 1, 256, 300),
    (3, 40, 4, 2, 16, 33), (2, 600, 6, 2, 32, 599),
    (32, 2176, 16, 8, 64, 2100),  # granite's decode at batch 32 (split kv axis)
    (16, 288, 16, 8, 64, 200),    # granite's 16-slot batcher (split kv axis)
    (2, 256, 10, 1, 64, 200),     # 10 query heads per kv head (recurrentgemma-2b)
    (1, 256, 16, 1, 128, 256),    # 16 per kv head (llama3-405b)
    (2, 2176, 16, 1, 64, 2100)]   # 16 per kv head over a split kv axis
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 48)])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype, causal, window):
    B, Sq, Skv, H, K, D = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (B, Sq, H, D), dtype, cuda)
    k = _randn(gen, (B, Skv, K, D), dtype, cuda)
    v = _randn(gen, (B, Skv, K, D), dtype, cuda)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, scale=D ** -0.5, window=window)
    assert fa_ops.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 128, 128, 9, 3, 64), (1, 96, 96, 32, 8, 128),
                                   (1, 64, 64, 8, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_through_the_kernel(cuda, shape, dtype):
    """The card's route is differentiable: the forward is the kernel (one
    launch), and dq, dk, dv are autograd's through the plain version on the
    same tensors (bit for bit: the backward recomputes the plain version),
    finite and nonzero."""
    B, Sq, Skv, H, K, D = shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn(gen, s, dtype, cuda).requires_grad_()
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))
    dout = _randn(gen, (B, Sq, H, D), dtype, cuda)
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=True)
    assert fa_ops.launches == before + 1
    want_out = flash_attention_ref(q, k, v, causal=True, scale=D ** -0.5)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    assert fa_ops.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
        assert bool(torch.isfinite(g.float()).all()) and bool((g != 0).any())


def test_smoke_model_gradients_on_card_match_cpu(cuda):
    """A 2-layer fp32 smollm at the smoke widths: every parameter's
    gradient through the kernel route on the card within 1e-4 of its max
    |g| of the CPU's (the plain route), w_q, w_k and w_v nonzero."""
    from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loss_and_grads

    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), cuda)
    data = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(4, 33)).astype(np.int32))
    batch = {"tokens": data[:, :-1], "labels": data[:, 1:]}
    before = fa_ops.launches
    grads = {}
    for m in (cpu, card):
        m.requires_grad_(True)
        grads[m.device.type] = loss_and_grads(m, batch, cfg)[2]
    assert fa_ops.launches == before + cfg.n_layers
    for g, w in zip(tree_leaves(grads["cuda"]), tree_leaves(grads["cpu"])):
        w = w.float()
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))
    for name in ("w_q", "w_k", "w_v"):
        g = grads["cuda"]["blocks"]["attn"][name]
        assert bool((g != 0).any()) and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("shape", FD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, shape, dtype):
    B, S, H, K, D, clen = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (B, 1, H, D), dtype, cuda)
    kc = _randn(gen, (B, S, K, D), dtype, cuda)
    vc = _randn(gen, (B, S, K, D), dtype, cuda)
    before = fd_ops.launches
    got = fd_ops.flash_decode(q, kc, vc, clen, scale=D ** -0.5)
    want = flash_decode_ref(q, kc, vc, clen, scale=D ** -0.5)
    assert fd_ops.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # per-sequence lens, one of them 1
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=cuda, dtype=torch.int32)
    lens[0] = 1
    got = fd_ops.flash_decode(q, kc, vc, lens, scale=D ** -0.5)
    want = flash_decode_ref(q, kc, vc, lens, scale=D ** -0.5)
    assert fd_ops.launches == before + 2
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [3, 10])
def test_flash_decode_merges_any_split_count_inside_the_launch(cuda, dtype, G):
    """Every cluster size the kernel takes (1 to 8 splits of the kv axis,
    merged through distributed shared memory in split order), one launch
    each, per-sequence lengths with a 1 and lengths ending inside a split
    and inside a stage."""
    B, S, K, D = 3, 1000, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (B, 1, K * G, D), dtype, cuda)
    kc = _randn(gen, (B, S, K, D), dtype, cuda)
    vc = _randn(gen, (B, S, K, D), dtype, cuda)
    lens = torch.tensor([1, 517, S], dtype=torch.int32, device=cuda)
    want = flash_decode_ref(q, kc, vc, lens, scale=D ** -0.5)
    outs = []
    for nsplit in range(1, fd_ops.MAX_SPLITS + 1):
        before = fd_ops.launches
        out = fd_ops.flash_decode_cuda(q, kc, vc, lens, scale=D ** -0.5, nsplit=nsplit)
        assert fd_ops.launches == before + 1
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        outs.append(out)
    with pytest.raises(ValueError, match="nsplit 9"):  # past a portable cluster
        fd_ops.flash_decode_cuda(q, kc, vc, lens, scale=D ** -0.5, nsplit=9)
    # the wrapper launches its plan's split count, and the merge's order is fixed
    plan = fd_ops.plan_for(q, kc)
    assert torch.equal(outs[plan.nsplit - 1], fd_ops.flash_decode(q, kc, vc, lens,
                                                                  scale=D ** -0.5))


@pytest.mark.parametrize("D", fd_ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_stage_plan_is_the_kernels(cuda, D, dtype):
    elem = torch.finfo(dtype).bits // 8
    for G in (1, 2, 3, 4, 5, 16):
        assert fd_ops.kernel_stages(D, G, dtype) == fd_ops.stage_plan(D, elem, G)


def test_flash_attention_bf16_takes_unaligned_inputs_through_a_copy(cuda):
    """The bf16 body moves 16-byte chunks: a q whose heads start 8 bytes
    off goes to the same kernel as a contiguous copy, counted."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, S, H, K, D = 2, 96, 4, 2, 64
    base = _randn(gen, (B * S * H * D + 4,), torch.bfloat16, cuda)
    q = base[4:].view(B, S, H, D)
    k = _randn(gen, (B, S, K, D), torch.bfloat16, cuda)
    v = _randn(gen, (B, S, K, D), torch.bfloat16, cuda)
    assert not fa_ops.chunk_ready(q) and fa_ops.chunk_ready(k)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v)
    assert fa_ops.launches == 1 and fa_ops.aligned_copies == 1
    want = flash_attention_ref(q, k, v, causal=True, scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 96), device=cuda)
    k = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head_dim 96"):
        fd_ops.flash_decode(q[:, :1], k, k, 8, scale=0.1)
    with pytest.raises(ValueError, match="Sq"):
        fa_ops.flash_attention(torch.zeros((1, 9, 4, 64), device=cuda),
                               torch.zeros((1, 8, 2, 64), device=cuda),
                               torch.zeros((1, 8, 2, 64), device=cuda))


def test_smoke_model_serves_the_same_tokens_on_card_and_cpu(cuda):
    from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                                   make_serve_step)

    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 20)).astype(np.int32))
    served = {}
    for model in (cpu, card):
        lg, cache = make_prefill_step(model, cfg)(tok.to(model.device), cache_len=32)
        nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        step, out = make_serve_step(model, cfg), [nxt.cpu()]
        for i in range(10):
            nxt, _, cache = step(cache, nxt, 20 + i)
            out.append(nxt.cpu())
        eng = ContinuousBatcher(model, cfg, n_slots=2, cache_len=32,
                                device=model.device)
        for rid, n in enumerate((5, 9, 3)):
            eng.submit(Request(rid, tok[rid, :n].tolist(), 6))
        served[model.device.type] = (torch.cat(out, 1), eng.run())
    assert torch.equal(served["cuda"][0], served["cpu"][0])
    assert served["cuda"][1] == served["cpu"][1]


# ------------------------------------------------------------ ssd scan ----

SSD_SHAPES = [  # (B, S, H, P, N, chunk): tests/test_kernels.py:171, then
    (1, 64, 2, 32, 32, 32), (2, 128, 4, 64, 64, 32), (1, 96, 2, 32, 64, 32),
    (1, 80, 3, 16, 32, 32), (2, 64, 2, 64, 128, 64),
    (2, 100, 3, 8, 16, 256),     # Q = S = 100, not a power of two; P = 8
    (2, 300, 3, 16, 16, 48),     # Q = 48, a ragged last chunk of 12
    (2, 77, 3, 24, 40, 24),      # P, N multiples of 8 only
    (2, 1000, 4, 64, 128, 256),  # mamba2-370m's head: Q 256, N 128, P 64
    (1, 600, 2, 128, 128, 256)]  # the widest P and N the kernel takes


def ssd_tol(want: torch.Tensor) -> dict:
    """fp32-level: rtol 1e-4 and an atol of 1e-4 of the largest |want|.
    Both sides compute in fp32 from the same inputs (bf16 ones too), but
    their cumsums round differently; with the published ranges |cum|
    reaches ~400 within a chunk, where an fp32 ulp is 3.05e-5, and a few
    such ulps in exp(cum_i - cum_j) are ~1e-4 of a term."""
    return dict(rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def ssd_inputs(gen, shape, dtype, dev, published):
    """x, dt, A, B, C.  The JAX tests' draws (tests/test_kernels.py:185),
    or Mamba-2's published init: A in -[1, 16], dt log-uniform in
    [1e-3, 1e-1]."""
    B, S, H, P, N, _ = shape
    x = _randn(gen, (B, S, H, P), dtype, dev)
    Bm = _randn(gen, (B, S, N), dtype, dev)
    Cm = _randn(gen, (B, S, N), dtype, dev)
    if published:
        A = -(1 + 15 * torch.rand((H,), generator=gen, device=dev))
        dt = torch.exp(np.log(1e-3) + np.log(100.0) * torch.rand((B, S, H), generator=gen,
                                                                 device=dev))
    else:
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
        A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=dev))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("published", [False, True], ids=["jax_draws", "published"])
def test_ssd_scan_kernel_matches_plain(cuda, shape, dtype, published):
    gen = torch.Generator(device=cuda).manual_seed(4)
    args = ssd_inputs(gen, shape, dtype, cuda, published)
    before = ssd_ops.launches
    y, s = ssd_ops.ssd_scan(*args, chunk=shape[-1])
    want_y, want_s = ssd_scan_ref(*args, chunk=shape[-1])
    assert ssd_ops.launches == before + 1
    assert y.dtype == s.dtype == torch.float32
    torch.testing.assert_close(y, want_y, **ssd_tol(want_y))
    torch.testing.assert_close(s, want_s, **ssd_tol(want_s))


SSD_TC_SHAPES = [  # (B, S, H, P, N, chunk): the bf16 body
    (2, 600, 32, 64, 128, 256),   # mamba2-370m's H 32, a ragged last chunk of 88
    (1, 777, 33, 64, 128, 256),   # an odd H; chunks of 256 then 9 rows
    (1, 300, 3, 64, 128, 256),
    # the instances (P, N each up to 64 or 128, exactly so or not) that the
    # shapes above and SSD_SHAPES leave out
    (1, 300, 2, 128, 64, 256), (1, 300, 2, 96, 48, 256),
    (1, 300, 2, 96, 128, 256), (1, 300, 2, 48, 96, 256)]


@pytest.mark.parametrize("shape", SSD_TC_SHAPES)
@pytest.mark.parametrize("published", [False, True], ids=["jax_draws", "published"])
def test_ssd_scan_bf16_body_matches_plain_and_its_emulation(cuda, shape, published):
    """The tensor-core body against the fp32 plain version, and against
    `ssd_scan_split_ref` (the same roundings), both at the unchanged
    fp32-level tolerance."""
    assert ssd_ops.body(torch.bfloat16) == "mma"
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = ssd_inputs(gen, shape, torch.bfloat16, cuda, published)
    before = ssd_ops.launches
    y, s = ssd_ops.ssd_scan(*args, chunk=shape[-1])
    assert ssd_ops.launches == before + 1
    for want_y, want_s in (ssd_scan_ref(*args, chunk=shape[-1]),
                           ssd_scan_split_ref(*args, chunk=shape[-1])):
        torch.testing.assert_close(y, want_y, **ssd_tol(want_y))
        torch.testing.assert_close(s, want_s, **ssd_tol(want_s))


def test_ssd_scan_bf16_body_takes_unaligned_slices(cuda):
    """x, B and C at an odd element offset of one projection: the bf16
    body's loads take the plain path instead of cp.async."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, S, H, P, N = 2, 300, 4, 64, 128
    xbc = _randn(gen, (B, S, 1 + H * P + 2 * N), torch.bfloat16, cuda)[..., 1:]
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.rand((B, S, H), generator=gen, device=cuda) * 0.1
    A = -(1 + 15 * torch.rand((H,), generator=gen, device=cuda))
    y, s = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    want_y, want_s = ssd_scan_ref(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                                  chunk=256)
    torch.testing.assert_close(y, want_y, **ssd_tol(want_y))
    torch.testing.assert_close(s, want_s, **ssd_tol(want_s))


@pytest.mark.parametrize("pn", [(64, 128), (8, 16), (24, 40), (128, 64), (128, 128)])
def test_ssd_scan_tc_plan_is_the_kernels(cuda, pn):
    P, N = pn
    plan = ssd_ops.tc_plan(2, 32, P, N)
    smem, asked, occupancy, warps = ssd_ops.kernel_tc_plan(P, N)
    assert (smem, asked, warps) == (plan.smem, plan.blocks_per_sm, plan.warps)
    assert occupancy >= asked


def test_ssd_scan_reads_strided_slices(cuda):
    """x, B and C cut out of one projection, as `models.ssm` hands them."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, S, H, P, N = 2, 300, 4, 64, 128
    xbc = _randn(gen, (B, S, H * P + 2 * N), torch.bfloat16, cuda)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.rand((B, H, S), generator=gen, device=cuda).transpose(1, 2) * 0.1
    A = -(1 + 15 * torch.rand((H,), generator=gen, device=cuda))
    y, s = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    want_y, want_s = ssd_scan_ref(x.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                                  Cm.contiguous(), chunk=256)
    torch.testing.assert_close(y, want_y, **ssd_tol(want_y))
    torch.testing.assert_close(s, want_s, **ssd_tol(want_s))


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 300, 2, 64), device=cuda)
    dt = torch.zeros((1, 300, 2), device=cuda)
    A = -torch.ones(2, device=cuda)
    bc = torch.zeros((1, 300, 128), device=cuda)
    with pytest.raises(ValueError, match="chunk 512"):
        ssd_ops.ssd_scan(x, dt, A, bc, bc, chunk=512)
    with pytest.raises(ValueError, match="head dim P 12"):
        ssd_ops.ssd_scan(x[..., :12], dt, A, bc, bc)
    with pytest.raises(ValueError, match="state size N 136"):
        ssd_ops.ssd_scan(x, dt, A, torch.zeros((1, 300, 136), device=cuda),
                         torch.zeros((1, 300, 136), device=cuda))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ssd_ops.ssd_scan(x, dt, A, bc.bfloat16(), bc)
    with pytest.raises(ValueError, match="dt and A must be float32"):
        ssd_ops.ssd_scan(x, dt.bfloat16(), A, bc, bc)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, bc, bc)


def test_ssm_smoke_model_serves_the_same_tokens_on_card_and_cpu(cuda):
    """A 2-layer fp32 mamba2 at the smoke widths (published A and dt, so
    the carried state counts): prefill + serve steps, and the batcher."""
    from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                                   make_serve_step)

    cfg = get_smoke_config("mamba2-370m").scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    tree = lm_params_to_numpy(cpu)
    rng = np.random.default_rng(6)
    shape = tree["blocks"]["ssm"]["A_log"].shape
    tree["blocks"]["ssm"]["A_log"] = np.log(rng.uniform(1, 16, shape)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    tree["blocks"]["ssm"]["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    cpu = lm_params_from_numpy(cfg, tree, "cpu")
    card = lm_params_from_numpy(cfg, tree, cuda)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(3, 40)).astype(np.int32))
    served = {}
    before = ssd_ops.launches
    for model in (cpu, card):
        lg, cache = make_prefill_step(model, cfg)(tok.to(model.device))
        nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        step, out = make_serve_step(model, cfg), [nxt.cpu()]
        for i in range(10):
            nxt, _, cache = step(cache, nxt, 40 + i)
            out.append(nxt.cpu())
        eng = ContinuousBatcher(model, cfg, n_slots=2, cache_len=32, device=model.device)
        for rid, n in enumerate((5, 9, 3)):
            eng.submit(Request(rid, tok[rid, :n].tolist(), 6))
        served[model.device.type] = (torch.cat(out, 1), eng.run())
    assert ssd_ops.launches == before + cfg.n_layers
    assert torch.equal(served["cuda"][0], served["cpu"][0])
    assert served["cuda"][1] == served["cpu"][1]


# ------------------------------------------------------------ moe gemm ----

MG_SHAPES = [  # (E, C, d, f): tests/test_kernels.py:301-307, then
    (4, 64, 32, 16), (8, 96, 64, 32), (2, 50, 32, 64), (32, 40, 64, 32),
    (3, 130, 24, 40),        # C over three row tiles; d and f multiples of 8 only
    (32, 640, 1024, 512),    # granite-moe-1b-a400m's experts
    (32, 10, 1024, 512),     # its decode step: C 10 at batch 32
    (32, 8, 1024, 512)]      # its 16-slot batcher: C 8


def moe_tol(want: torch.Tensor) -> dict:
    """fp32: rtol 1e-4 and 1e-4 of the largest |y| (sums in another
    order).  bf16: rtol 2e-2 and an atol of 5% of the mean |y|: both sides
    round h and y to bf16 from fp32 sums, and a sum that lands the other
    side of a rounding boundary moves a value by one bf16 ulp."""
    if want.dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    return dict(rtol=2e-2, atol=5e-2 * float(want.float().abs().mean()))


def moe_inputs(gen, shape, dtype, dev, junk=False):
    """x (rows past the counts zero, or ``junk``), weights scaled by
    1/sqrt(fan-in) so that g, u and y are O(1), and counts in [0, C] with
    0, C and a count past C among them."""
    E, C, d, f = shape
    x = _randn(gen, (E, C, d), torch.float32, dev)
    w = [_randn(gen, s, torch.float32, dev) * s[1] ** -0.5
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    counts = torch.randint(0, C + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    n = min(3, E)
    counts[:n] = torch.tensor([0, C, C + 7][:n], dtype=torch.int32, device=dev)
    if not junk:
        x = x * (torch.arange(C, device=dev)[None, :] < counts[:, None])[..., None]
    return [t.to(dtype) for t in [x] + w] + [counts]


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("junk", [False, True], ids=["zeroed", "junk_past_counts"])
def test_moe_gemm_kernel_matches_plain(cuda, shape, dtype, junk):
    gen = torch.Generator(device=cuda).manual_seed(6)
    args = moe_inputs(gen, shape, dtype, cuda, junk)
    before = mg_ops.launches
    got = mg_ops.moe_gemm(*args)
    want = moe_gemm_ref(*args)
    assert mg_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **moe_tol(want))
    dead = torch.arange(shape[1], device=cuda)[None, :] >= args[-1][:, None]
    assert not bool(got[dead].any())


@pytest.mark.parametrize("d", [24, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_grid_plan_is_the_kernels(cuda, d, dtype):
    plan = mg_ops.grid_plan(4, 300, d, 512, dtype)
    assert mg_ops.kernel_tiles(dtype, d) == (plan.body, plan.gate_up.rows, plan.gate_up.cols,
                                             plan.down.rows, plan.down.cols)


def test_moe_gemm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, wg, wu, wd, counts = moe_inputs(gen, (4, 64, 32, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        mg_ops.moe_gemm(x, wg.bfloat16(), wu, wd, counts)
    with pytest.raises(ValueError, match="does not match"):
        mg_ops.moe_gemm(x, wg, wu, wd[:, :8], counts)
    with pytest.raises(ValueError, match="same CUDA device"):
        mg_ops.moe_gemm(x, wg, wu, wd, counts.cpu())
    with pytest.raises(ValueError, match="int32"):
        mg_ops.moe_gemm(x, wg, wu, wd, counts.long())
    with pytest.raises(ValueError, match="f 12"):
        mg_ops.moe_gemm(x, wg[..., :12], wu[..., :12], wd[:, :12], counts)
    with pytest.raises(ValueError, match="contiguous"):
        mg_ops.moe_gemm(x.transpose(0, 1).contiguous().transpose(0, 1), wg, wu, wd, counts)


def test_moe_smoke_model_serves_the_same_tokens_on_card_and_cpu(cuda):
    """A 2-layer fp32 granite at the smoke widths: prefill + serve steps,
    and the batcher, through `moe_gemm` on the card."""
    from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                                   make_serve_step)

    cfg = get_smoke_config("granite-moe-1b-a400m").scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 20)).astype(np.int32))
    served = {}
    before = mg_ops.launches
    for model in (cpu, card):
        lg, cache = make_prefill_step(model, cfg)(tok.to(model.device), cache_len=32)
        nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        step, out = make_serve_step(model, cfg), [nxt.cpu()]
        for i in range(10):
            nxt, _, cache = step(cache, nxt, 20 + i)
            out.append(nxt.cpu())
        eng = ContinuousBatcher(model, cfg, n_slots=2, cache_len=32, device=model.device)
        for rid, n in enumerate((5, 9, 3)):
            eng.submit(Request(rid, tok[rid, :n].tolist(), 6))
        served[model.device.type] = (torch.cat(out, 1), eng.run())
    assert mg_ops.launches >= before + cfg.n_layers * 11
    assert torch.equal(served["cuda"][0], served["cpu"][0])
    assert served["cuda"][1] == served["cpu"][1]



@pytest.mark.parametrize("case", ["zero_token", "equal_columns"])
def test_moe_router_breaks_ties_by_lower_expert_id_on_the_card(cuda, case):
    """CUDA's sort is another code path than the CPU's: among equal router
    probabilities the lower expert id still wins, as in `lax.top_k` (here
    numpy's stable argsort of the card's own probabilities)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import dispatch

    cfg = get_smoke_config("granite-moe-1b-a400m").scaled(dtype="float32")
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    rng = np.random.default_rng(0)
    w_router = (rng.normal(size=(d, E)) / np.sqrt(d)).astype(np.float32)
    xt = rng.normal(size=(16, d)).astype(np.float32)
    if case == "zero_token":
        xt[3] = 0
    else:
        w_router[:, 1] = w_router[:, 6]
    p = SimpleNamespace(w_router=torch.from_numpy(w_router).to(cuda))
    x = torch.from_numpy(xt).to(cuda)
    disp = dispatch(p, cfg, x)
    probs = torch.softmax(x @ p.w_router, dim=-1).cpu().numpy()
    want = np.sort(np.argsort(-probs, axis=-1, kind="stable")[:, :k], axis=-1)
    np.testing.assert_array_equal(disp.expert_ids.cpu().numpy(), want)
    if case == "zero_token":
        assert disp.expert_ids[3].tolist() == list(range(k))
    else:
        assert bool((probs[:, 1] == probs[:, 6]).all())

# ------------------------------------- the gradients of ssd_scan and moe_gemm ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", ["repo", "published"])
def test_ssd_scan_gradients_through_the_kernel(cuda, dtype, init):
    """The card's scan is differentiable at mamba2-370m's heads and its
    chunk of 256: the forward is the kernel (one launch), x, B and C are
    views of one conv output, and every gradient is autograd's through the
    plain version on the same tensors (bit for bit: the backward recomputes
    it), finite and nonzero.  The repo's init (A = -1, dt ~ 0.7) overflowed
    exp above the chunk's diagonal before the plain scan's repair."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    Bsz, S, H, P, N = 2, 512, 32, 64, 128
    conv = _randn(gen, (Bsz, S, H * P + 2 * N), dtype, cuda).requires_grad_()
    if init == "repo":
        dt_raw = torch.zeros((Bsz, S, H), device=cuda).requires_grad_()
        A_log = torch.zeros((H,), device=cuda).requires_grad_()
    else:
        dt_raw = (np.log(1e-3) + np.log(100.0) * torch.rand((Bsz, S, H), generator=gen,
                                                            device=cuda)).requires_grad_()
        A_log = torch.log(1 + 15 * torch.rand((H,), generator=gen, device=cuda)
                          ).requires_grad_()
    dy = torch.randn((Bsz, S, H, P), generator=gen, device=cuda)

    def inputs():
        dt = torch.nn.functional.softplus(dt_raw) if init == "repo" else torch.exp(dt_raw)
        return (conv[..., :H * P].unflatten(-1, (H, P)), dt, -torch.exp(A_log),
                conv[..., H * P:H * P + N], conv[..., H * P + N:])

    leaves = (conv, dt_raw, A_log)
    before = ssd_ops.launches
    y, _ = ssd_ops.ssd_scan(*inputs(), chunk=256)
    assert ssd_ops.launches == before + 1
    want_y, _ = ssd_scan_ref(*inputs(), chunk=256)
    torch.testing.assert_close(y, want_y, **ssd_tol(want_y))
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(want_y, leaves, dy)
    assert ssd_ops.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert bool(torch.isfinite(g.float()).all()) and bool((g != 0).any())


@pytest.mark.parametrize("shape", [(32, 640, 1024, 512), (3, 130, 24, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_gradients_through_the_kernel(cuda, shape, dtype):
    """The card's expert GEMM is differentiable: one launch forward, and the
    gradients of x and the three weights are autograd's through the plain
    version on the same tensors, bit for bit; rows past the counts (random
    here) get zero gradient."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x, wg, wu, wd, counts = moe_inputs(gen, shape, dtype, cuda, junk=True)
    ins = [t.requires_grad_() for t in (x, wg, wu, wd)]
    dy = _randn(gen, x.shape, dtype, cuda)
    before = mg_ops.launches
    y = mg_ops.moe_gemm(*ins, counts)
    assert mg_ops.launches == before + 1
    want_y = moe_gemm_ref(*ins, counts)
    torch.testing.assert_close(y, want_y, **moe_tol(want_y))
    got = torch.autograd.grad(y, ins, dy)
    want = torch.autograd.grad(want_y, ins, dy)
    assert mg_ops.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w) and bool(torch.isfinite(g.float()).all())
    dead = torch.arange(shape[1], device=cuda)[None, :] >= counts[:, None]
    assert not bool(got[0][dead].any()) and bool(got[0][~dead].any())


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_layer_backward_is_deterministic_on_the_card(cuda, capacity_factor):
    """granite's MoE layer in bf16 over 2,048 tokens, forward and backward
    twice: the gradients of the tokens and of every weight are bit-equal
    (the combine's backward adds into each slot one kept pick's gradient
    and zeros from dropped picks; capacity 0.25 drops many)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe

    cfg = get_config("granite-moe-1b-a400m").scaled(capacity_factor=capacity_factor)
    gen = torch.Generator(device=cuda).manual_seed(9)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = SimpleNamespace(
        w_router=(torch.randn((d, E), generator=gen, device=cuda) * 0.02).requires_grad_(),
        **{k: (torch.randn(s, generator=gen, device=cuda) * 0.02).to(torch.bfloat16
                                                                     ).requires_grad_()
           for k, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)), ("w_down", (E, f, d)))})
    x = torch.randn((2, 1024, d), generator=gen, device=cuda).to(torch.bfloat16
                                                                  ).requires_grad_()
    dout = torch.randn((2, 1024, d), generator=gen, device=cuda).to(torch.bfloat16)
    leaves = (x, p.w_router, p.w_gate, p.w_up, p.w_down)
    runs = []
    for _ in range(2):
        out, aux = moe(p, cfg, x)
        runs.append(torch.autograd.grad((out, aux), leaves, (dout, torch.ones_like(aux))))
    for a, b in zip(*runs):
        assert torch.equal(a, b) and bool(a.any())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_family_smoke_model_gradients_on_card_match_cpu(cuda, arch):
    """A 2-layer fp32 granite and mamba2 (the latter at the published
    chunk of 256 over 256 steps, the repo's init): every parameter's
    gradient through the kernel route on the card within 1e-4 of its max
    |g| of the CPU's (the plain route), finite, and the kernels' leaves
    nonzero."""
    from repro_torch.carry import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loss_and_grads

    moe_family = arch.startswith("granite")
    cfg = get_smoke_config(arch).scaled(dtype="float32",
                                        **({} if moe_family else dict(ssm_chunk=256)))
    S = 32 if moe_family else 256
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), cuda)
    data = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(4, S + 1)).astype(np.int32))
    batch = {"tokens": data[:, :-1], "labels": data[:, 1:]}
    ops_ = mg_ops if moe_family else ssd_ops
    before = ops_.launches
    grads = {}
    for m in (cpu, card):
        m.requires_grad_(True)
        grads[m.device.type] = loss_and_grads(m, batch, cfg)[2]
    assert ops_.launches == before + cfg.n_layers
    for g, w in zip(tree_leaves(grads["cuda"]), tree_leaves(grads["cpu"])):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))
    blk = grads["cuda"]["blocks"]
    for g in ((blk["moe"]["w_gate"], blk["moe"]["w_down"], blk["moe"]["w_router"])
              if moe_family else (blk["ssm"]["A_log"], blk["ssm"]["dt_bias"], blk["ssm"]["w_dt"])):
        assert bool((g != 0).any())


# tests/test_kernels.py:78-80, then a grid of 3 x 3 blocks with non-consecutive
# repeats, a ragged edge in every dimension and a row stride that is not a
# multiple of 16 bytes
MM_SHAPES = [(256, 128, 256), (512, 256, 512), (128, 128, 128), (384, 256, 128),
             (256, 96, 200), (300, 300, 300), (130, 67, 33)]
MM_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py:96


@pytest.mark.parametrize("mnk", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [(128, 128, 64), (256, 256, 256)])
def test_morton_matmul_kernel_matches_plain_in_every_order(cuda, mnk, dtype, blocks):
    """Within the JAX test's tolerance of the plain version, the three
    orders bit-identical, and every tile computed once, by the block that
    `tile_order` gives it."""
    M, N, K = mnk
    gen = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    b = torch.randn((K, N), generator=gen, device=cuda).to(dtype)
    want = morton_matmul_ref(a, b).float()
    bm, bn, bk, nm, nn = mm_ops.grid(M, N, K, *blocks)
    outs = []
    for order in mm_ops.ORDERS:
        trace = mm_ops.new_trace(nm, nn, cuda)
        before = mm_ops.launches
        got = mm_ops.morton_matmul(a, b, block_m=bm, block_n=bn, block_k=bk,
                                   order=order, trace=trace)
        assert mm_ops.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == (M, N)
        rel = (got.float() - want).abs() / (want.abs() + 1)
        assert float(rel.max()) < MM_REL[dtype]
        mm_ops.check_trace(trace, mm_ops.tile_order(nm, nn, order, cuda))
        outs.append(got)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_morton_matmul_takes_unaligned_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    base = torch.randn(70 * 45 + 1, generator=gen, device=cuda)
    a = base[1:].view(70, 45)  # 4-byte aligned, rows of 180 bytes
    b = torch.randn((45, 29), generator=gen, device=cuda)
    got = mm_ops.morton_matmul(a, b, block_m=32, block_n=16, block_k=8, order="hilbert")
    want = morton_matmul_ref(a, b)
    assert float(((got - want).abs() / (want.abs() + 1)).max()) < 1e-4


def test_morton_matmul_bf16_takes_unaligned_operands_through_padded_copies(cuda):
    """TMA needs 16-byte aligned bases and rows: a (70, 45) bf16 a from a
    base 2 bytes off, and a (45, 29) b, go to the tensor-core body as
    padded copies, each counted, within the JAX test's bf16 tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    base = torch.randn(70 * 45 + 1, generator=gen, device=cuda).bfloat16()
    a = base[1:].view(70, 45)  # 2-byte aligned, rows of 90 bytes
    b = torch.randn((45, 29), generator=gen, device=cuda).bfloat16()
    assert not mm_ops.tma_ready(a) and not mm_ops.tma_ready(b)
    mm_ops.reset_launches()
    trace = mm_ops.new_trace(3, 2, cuda)
    got = mm_ops.morton_matmul(a, b, block_m=32, block_n=16, block_k=8, order="hilbert",
                               trace=trace)
    assert mm_ops.launches == 1 and mm_ops.padded_copies == 2
    mm_ops.check_trace(trace, mm_ops.tile_order(3, 2, "hilbert", cuda))
    want = morton_matmul_ref(a, b).float()
    assert float(((got.float() - want).abs() / (want.abs() + 1)).max()) < MM_REL[torch.bfloat16]
    aligned = torch.randn((64, 32), generator=gen, device=cuda).bfloat16()
    mm_ops.morton_matmul(aligned, aligned.t().contiguous())
    assert mm_ops.padded_copies == 2  # aligned operands are read in place


def test_morton_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((64, 32), device=cuda)
    b = torch.zeros((32, 16), device=cuda)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        mm_ops.morton_matmul(a, b.bfloat16())
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        mm_ops.morton_matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="same CUDA device"):
        mm_ops.morton_matmul(a, b.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mm_ops.morton_matmul(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="want a"):
        mm_ops.morton_matmul(a[None], b)
    with pytest.raises(ValueError, match="trace"):
        mm_ops.morton_matmul(a, b, trace=mm_ops.new_trace(2, 2, cuda))


def test_morton_matmul_tile_order_is_built_once_on_the_card(cuda):
    a = mm_ops.tile_order(47, 79, "hilbert", cuda)
    assert a.is_cuda and a is mm_ops.tile_order(47, 79, "hilbert", "cuda")
    assert 1 <= mm_ops.blocks_per_sm(torch.bfloat16) <= 8
