"""Port parity: `morton_matmul` (kernel B6's slice) against the JAX package.

The same numpy inputs go through both sides.  The JAX `morton_matmul` runs
its Pallas kernel in interpret mode, as `tests/test_kernels.py:86` runs
it; the port's runs its plain version on the CPU.  Tolerance: the JAX
test's, ``|got - want| / (|want| + 1)`` below 1e-4 in fp32 and 3e-2 in
bf16 (`tests/test_kernels.py:96`): both sum K products in fp32, in other
orders, and bf16 rounds the result once.  The tile orders, the traffic
model and the Hilbert decode are integers and must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import morton as j_morton
from repro.kernels.morton_matmul.ops import morton_matmul as j_morton_matmul
from repro.kernels.morton_matmul.ops import panel_traffic as j_panel_traffic
from repro.kernels.morton_matmul.ops import tile_sequence as j_tile_sequence
from repro.kernels.morton_matmul.ref import matmul_ref as j_matmul_ref
from repro_torch.core import morton
from repro_torch.kernels.morton_matmul import ops
from repro_torch.kernels.morton_matmul.ref import matmul_ref, morton_matmul_ref

MM_SHAPES = [(256, 128, 256), (512, 256, 512), (128, 128, 128),
             (384, 256, 128),  # non-pow2 tile grid (clamped curve cells)
             (256, 96, 200)]   # padding path
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-4, "bfloat16": 3e-2}
ORDERS = ["morton", "hilbert", "rowmajor"]
# tests/test_kernels.py:107's square grids, then grids that are not square or
# not powers of two: 3 x 3 repeats tiles that are not consecutive, 47 x 79 is
# the study's ragged grid at 128 x 128 blocks
GRIDS = [(8, 8), (16, 16), (32, 32), (3, 3), (1, 5), (47, 79)]


def _draw(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _to(x, jdt, tdt):
    """The same values on both sides (bf16 rounded once, by JAX)."""
    j = jnp.asarray(x, dtype=jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mnk", MM_SHAPES)
def test_port_matches_jax_morton_matmul(mnk, dtype, order):
    M, N, K = mnk
    jdt, tdt = DTYPES[dtype]
    ja, ta = _to(_draw((M, K), 1), jdt, tdt)
    jb, tb = _to(_draw((K, N), 2), jdt, tdt)
    want = np.asarray(j_morton_matmul(ja, jb, block_m=128, block_n=128, block_k=64,
                                      order=order).astype(jnp.float32))
    got = ops.morton_matmul(ta, tb, block_m=128, block_n=128, block_k=64, order=order)
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    got = got.float().numpy()
    rel = np.abs(got - want) / (np.abs(want) + 1.0)
    assert rel.max() < REL[dtype], rel.max()
    # and the fp32 products themselves agree with the JAX oracle
    ref = np.asarray(j_matmul_ref(ja, jb))
    assert np.abs(matmul_ref(ta, tb).numpy() - ref).max() < 1e-4 * (np.abs(ref).max() + 1)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("nm,nn", GRIDS)
def test_tile_sequence_and_panel_traffic_equal_jax(nm, nn, order):
    assert ops.tile_sequence(nm, nn, order) == j_tile_sequence(nm, nn, order)
    for capacity in (1, 4):
        assert (ops.panel_traffic(nm, nn, order, capacity)
                == j_panel_traffic(nm, nn, order, capacity))


def _jax_first_visits(nm, nn, order):
    """First visit of each tile under the JAX kernel's own index maps
    (`kernel.py:63-84`): the traced decoders, then the clamp."""
    bits = j_morton.grid_bits((nm, nn))
    if order == "morton":
        t = jnp.arange(1 << j_morton.total_bits(bits))
        i, j = j_morton.morton_decode_traced(t, bits)
    elif order == "hilbert":
        h = max(bits) if bits else 0
        i, j = j_morton.hilbert_decode_2d_traced(jnp.arange(1 << (2 * h)), h)
    else:
        t = jnp.arange(nm * nn)
        i, j = t // nn, t % nn
    i = np.asarray(jnp.minimum(i, nm - 1)).tolist()
    j = np.asarray(jnp.minimum(j, nn - 1)).tolist()
    seen, out = set(), []
    for tile in (a * nn + b for a, b in zip(i, j)):
        if tile not in seen:
            seen.add(tile)
            out.append(tile)
    return out


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("nm,nn", GRIDS + [(1, 1), (5, 3), (24, 40), (64, 64)])
def test_tile_order_is_the_first_visits_of_the_jax_index_maps(nm, nn, order):
    got = ops.tile_order_np(nm, nn, order)
    assert got.dtype == np.int32
    assert got.tolist() == _jax_first_visits(nm, nn, order)
    assert sorted(got.tolist()) == list(range(nm * nn))  # a permutation


def test_tile_order_drops_repeats_that_are_not_consecutive():
    """A 3 x 3 Morton walk over 4 x 4 cells visits (0,2), (1,2), then (0,2)
    again at t = 8, 9 and 10; the kernel's order keeps only the first."""
    cells = ops._curve(3, 3, "morton").tolist()
    assert cells[8:11] == [[0, 2], [1, 2], [0, 2]]
    seq = ops.tile_sequence(3, 3, "morton")  # keeps that repeat
    assert seq[6:9] == [(0, 2), (1, 2), (0, 2)]
    assert len(seq) == 11 and len(set(seq)) == 9
    order = ops.tile_order_np(3, 3, "morton").tolist()
    assert order == [0, 3, 1, 4, 6, 7, 2, 5, 8]
    # the study's ragged grid under Hilbert: 16,384 cells for 3,713 tiles
    assert len(ops._curve(47, 79, "hilbert")) == 16384
    assert len(ops.tile_order_np(47, 79, "hilbert")) == 47 * 79


def test_tile_order_is_cached_per_grid_order_and_device():
    a = ops.tile_order(5, 3, "hilbert", "cpu")
    assert a is ops.tile_order(5, 3, "hilbert", torch.device("cpu"))
    assert a.dtype == torch.int32
    assert a is not ops.tile_order(5, 3, "morton", "cpu")


@pytest.mark.parametrize("order", range(6))
def test_hilbert_decode_equals_jax(order):
    t = np.arange(1 << (2 * order))
    for got, want in zip(morton.hilbert_decode_2d(t, order),
                         j_morton.hilbert_decode_2d(t, order)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mnk,blocks,want", [
    ((256, 96, 200), (128, 128, 64), (128, 96, 64, 2, 1)),
    ((8192, 8192, 8192), (128, 128, 64), (128, 128, 64, 64, 64)),
    ((6000, 10000, 4000), (128, 128, 64), (128, 128, 64, 47, 79)),
    ((6000, 10000, 4000), (256, 256, 256), (256, 256, 256, 24, 40)),
    ((100, 50, 7), (256, 256, 256), (100, 50, 7, 1, 1)),
])
def test_grid_follows_the_jax_block_rule(mnk, blocks, want):
    assert ops.grid(*mnk, *blocks) == want


def test_wave_panels_counts_distinct_panels_per_wave():
    # 2 x 2 tiles in waves of 2: row-major {(0,0),(0,1)} then {(1,0),(1,1)}
    assert ops.wave_panels([0, 1, 2, 3], 2, 2) == 3 + 3
    assert ops.wave_panels([0, 2, 1, 3], 2, 2) == 3 + 3
    assert ops.wave_panels([0, 3, 1, 2], 2, 2) == 4 + 4
    assert ops.wave_panels([0, 1, 2, 3], 2, 4) == 4


def test_plain_version_rounds_the_fp32_product_to_a_dtype():
    a = torch.from_numpy(_draw((33, 17), 3)).bfloat16()
    b = torch.from_numpy(_draw((17, 9), 4)).bfloat16()
    got = morton_matmul_ref(a, b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (a.float() @ b.float()).bfloat16())
    assert torch.equal(ops.morton_matmul(a, b, order="hilbert"), got)


def test_wrapper_refuses_what_it_does_not_take():
    a = torch.zeros((8, 16))
    b = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        ops.morton_matmul(a, b.bfloat16())
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        ops.morton_matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="no morton_matmul for devices"):
        ops.morton_matmul(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="want a"):
        ops.morton_matmul(a, b[:8])
    with pytest.raises(ValueError, match="order"):
        ops.morton_matmul(a, b, order="zigzag")
    with pytest.raises(ValueError, match="positive"):
        ops.morton_matmul(a, b, block_k=0)
    with pytest.raises(ValueError, match="trace"):
        ops.morton_matmul(a, b, trace=ops.new_trace(1, 1, "cpu"))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.morton_matmul_cuda(a, b)


@pytest.mark.parametrize("shape,offset,ready", [
    ((64, 32), 0, True),     # rows of 64 bytes from an aligned base
    ((70, 45), 0, False),    # rows of 90 bytes
    ((64, 32), 1, False),    # rows of 64 bytes from a base 2 bytes off
    ((8, 8), 8, True)])      # 16 bytes off: aligned again
def test_tma_eligibility_of_bf16_operands(shape, offset, ready):
    """TMA reads a bf16 matrix as it is only from a 16-byte aligned base
    with rows a multiple of 16 bytes long."""
    base = torch.zeros(shape[0] * shape[1] + offset + 16, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    t = base[offset:offset + shape[0] * shape[1]].view(shape)
    assert ops.tma_ready(t) is ready


@pytest.mark.parametrize("shape", [(70, 45), (3, 8), (5, 1)])
def test_tma_copy_pads_rows_with_zeros_and_is_counted(shape):
    t = torch.from_numpy(_draw(shape, 9)).to(torch.bfloat16)
    ops.reset_launches()
    got = ops.tma_copy(t)
    assert ops.padded_copies == 1 and ops.tma_ready(got)
    assert got.shape == (shape[0], -(-shape[1] // 8) * 8)
    assert torch.equal(got[:, :shape[1]], t) and not bool(got[:, shape[1]:].any())
    ops.reset_launches()
    assert ops.padded_copies == 0
