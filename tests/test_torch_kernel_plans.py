"""The host-side plans of the port's kernels, on the CPU.

`flash_decode`'s split plan (how many splits of the kv axis, one cluster
of blocks per (kv head, sequence), and the kernel's shared-memory ring)
`moe_gemm`'s grid plan (the blocks of its two phases, and which body
a dtype runs), and `ssd_scan`'s bf16 plan (one head a block, shared
memory, blocks an SM, and which body a dtype runs).  The kernels run these plans on the card
(`tests/test_torch_cuda.py` holds the plans to what the built kernels
report); here they are checked for what the kernels rely on.
"""
import pytest
import torch

from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from test_torch_cuda import FD_SHAPES, MG_SHAPES

SM_COUNTS = (132, 114, 16, 1)  # H100 SXM, H100 PCIe, and small cards
SMEM_PER_BLOCK = 232_448       # the most dynamic shared memory a Hopper block takes
SMEM_PER_SM = 233_472          # what an SM gives its blocks (228 KB)
SMEM_RESERVED = 1024           # taken by the system from each block's share


@pytest.mark.parametrize("shape", FD_SHAPES)
@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sms", SM_COUNTS)
def test_flash_decode_splits_cover_the_cache_once(shape, elem, sms):
    B, S, H, K, D, _ = shape
    plan = fd_ops.split_plan(B, K, S, H // K, D, elem, sms)
    assert 1 <= plan.nsplit <= fd_ops.MAX_SPLITS
    # the kernel's split: block `split` takes [split * chunk, (split + 1) * chunk)
    assert plan.chunk == -(-S // plan.nsplit)
    covered = torch.zeros(S, dtype=torch.int64)
    for split in range(plan.nsplit):
        covered[split * plan.chunk:min((split + 1) * plan.chunk, S)] += 1
    assert bool((covered == 1).all())
    assert plan.nsplit <= -(-S // fd_ops.MIN_SPLIT)  # one split per 256 positions at most


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_flash_decode_splits_fill_the_card_without_passing_a_cluster(sms):
    """More splits for fewer (sequence, kv head) pairs, never more than a
    portable cluster (8); over a long cache the block count is the one
    nearest the plan's aim of blocks an SM that 1 to 8 splits can give."""
    last = None
    for B in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        plan = fd_ops.split_plan(B, 3, 32_768, 3, 64, 2, sms)
        aim = fd_ops.BLOCKS_PER_SM * sms
        best = min(range(1, fd_ops.MAX_SPLITS + 1), key=lambda n: (abs(B * 3 * n - aim), -n))
        assert abs(B * 3 * plan.nsplit - aim) == abs(B * 3 * best - aim)
        assert last is None or plan.nsplit <= last
        last = plan.nsplit


@pytest.mark.parametrize("D", fd_ops.HEAD_DIMS)
@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("G", [1, 3, 4, 5, 8, 16])
def test_flash_decode_stage_plan_fits_a_block(D, elem, G):
    """A stage is at most 16 KB of K and V and a whole number of steps of
    the block's row groups; the block's shared memory fits Hopper's and
    leaves room for the four blocks an SM of the kernel's launch bounds."""
    tp, stages, smem = fd_ops.stage_plan(D, elem, G)
    lp = min(D * elem // 16, 32)
    groups = 4 * (32 // lp)
    assert stages == fd_ops.STAGES and tp % groups == 0 and tp <= 128
    assert 2 * tp * D * elem <= fd_ops.STAGE_BYTES or tp == groups
    assert (2 * tp * D * elem) % (16 * fd_ops.THREADS) == 0  # whole 16-byte copies a thread
    assert smem <= SMEM_PER_BLOCK
    assert SMEM_PER_SM // (smem + SMEM_RESERVED) >= 4


def test_flash_decode_plan_of_the_serving_decodes():
    """On the H100 (132 SMs) the dense decode at batch 32 splits its kv
    axis in 3 (288 blocks), the MoE decode (8 kv heads) not at all (256
    blocks), the MoE batcher's 16 slots in 2."""
    dense = fd_ops.split_plan(32, 3, 2176, 3, 64, 2, 132)
    assert (dense.nsplit, dense.tp, dense.stages) == (3, 64, 3)  # 16 KB stages at D 64
    assert fd_ops.split_plan(32, 8, 2176, 2, 64, 2, 132).nsplit == 1
    assert fd_ops.split_plan(16, 8, 288, 2, 64, 2, 132).nsplit == 2


def _blocks(phase):
    """(expert, first row, first column) of each block, in CUDA's launch
    order: blockIdx.x the column tile, y the row tile, z the expert."""
    nx, ny, nz = phase.grid
    return [(e, i * phase.rows, j * phase.cols)
            for e in range(nz) for i in range(ny) for j in range(nx)]


def _cover(phase, E, C, n):
    """How many blocks write each (expert, row, column) of the (E, C, n)
    output; asserts no block lies wholly outside it."""
    seen = torch.zeros((E, C, n), dtype=torch.int64)
    for e, r0, c0 in _blocks(phase):
        assert e < E and r0 < C and c0 < n
        seen[e, r0:r0 + phase.rows, c0:c0 + phase.cols] += 1
    return seen


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_blocks_cover_each_phase_once(shape, dtype):
    E, C, d, f = shape
    plan = mg_ops.grid_plan(E, C, d, f, dtype)
    assert plan.body == ("wgmma" if dtype == torch.bfloat16 else "fma")
    for phase, n in ((plan.gate_up, f), (plan.down, d)):
        nx, ny, nz = phase.grid
        assert nz == E and ny == -(-C // phase.rows) and nx == -(-n // phase.cols)
        tiles = _blocks(phase)
        assert len(tiles) == len(set(tiles)) == nx * ny * nz
        assert bool((_cover(phase, E, C, n) == 1).all())


@pytest.mark.parametrize("d", [24, 128, 136, 1024])
def test_moe_gemm_tile_shapes_by_body(d):
    """bf16: 128-row tiles (two wgmma consumers of 64 rows), 128 columns of
    f, and 256 columns of d past d 128; fp32: the FMA body's 64 x 64 and
    64 x 128."""
    tc = mg_ops.grid_plan(4, 300, d, 512, torch.bfloat16)
    assert (tc.gate_up.rows, tc.gate_up.cols) == (128, 128)
    assert (tc.down.rows, tc.down.cols) == (128, 256 if d > 128 else 128)
    fma = mg_ops.grid_plan(4, 300, d, 512, torch.float32)
    assert (fma.gate_up.rows, fma.gate_up.cols, fma.down.cols) == (64, 64, 128)
    with pytest.raises(ValueError, match="no moe_gemm body"):
        mg_ops.grid_plan(4, 300, d, 512, torch.float16)


def test_moe_gemm_decode_step_spreads_over_the_card():
    """A decode step (C 10 at granite's widths) launches 128 blocks in each
    phase, so its weight reads spread over the SMs."""
    plan = mg_ops.grid_plan(32, 10, 1024, 512, torch.bfloat16)
    assert len(_blocks(plan.gate_up)) == len(_blocks(plan.down)) == 128


WIDTHS = range(8, 129, 8)  # P and N the ssd_scan kernel takes


@pytest.mark.parametrize("P", WIDTHS)
def test_ssd_scan_tc_plan_fits_a_block(P):
    """Every N with this P: the bf16 body's shared memory fits a block, and
    the blocks its launch bounds ask for fit an SM together."""
    for N in WIDTHS:
        plan = ssd_ops.tc_plan(32, 32, P, N)
        assert plan.grid == (32, 32)
        assert plan.smem <= SMEM_PER_BLOCK
        assert plan.blocks_per_sm * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM
        assert plan.smem % 16 == 0  # the kernel carves 16-byte aligned regions


def test_ssd_scan_tc_plan_of_the_prefill():
    """mamba2-370m's prefill (B 32, H 32, P 64, N 128): one head a block,
    1,024 blocks of 8 warps, two an SM (16 warps) in 99,328 bytes each."""
    plan = ssd_ops.tc_plan(32, 32, 64, 128)
    assert plan == ssd_ops.TcPlan((32, 32), 99_328, 2, 8)


def test_ssd_scan_body_by_dtype():
    assert ssd_ops.body(torch.bfloat16) == "mma"
    assert ssd_ops.body(torch.float32) == "fma"
    with pytest.raises(ValueError, match="no ssd_scan body"):
        ssd_ops.body(torch.float16)
