"""Port parity: the multi-rank cutout and write over torch.distributed.

Each case runs 1-4 gloo ranks in spawned processes (tests/torch_dist_worker.py),
each holding its curve segment, and holds what every rank reads against the
JAX functions on the 1-device mesh of tests/test_distributed.py and against
numpy.  Each test joins its ranks with a timeout (a hang fails the test) and
meets through a ``file://`` rendezvous under its own ``tmp_path``.
"""
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as worker
from repro.core.cuboid import CuboidGrid as JGrid
from repro.core.distributed import distributed_cutout as j_cutout
from repro.core.distributed import distributed_write_cutout as j_write
from repro.core.distributed import pack_to_cuboids as j_pack
from repro.core.distributed import shard_cuboids as j_shard
from repro_torch.core import morton
from repro_torch.core.cuboid import CuboidGrid
from repro_torch.core.distributed import pack_to_cuboids, shard_cuboids

JOIN_TIMEOUT = 120  # seconds for all ranks of one case


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))


def spawn(world, case, tmp_path):
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    procs = [ctx.Process(target=worker.run, args=(r, world, init, case, str(tmp_path)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_TIMEOUT)
        assert not any(p.is_alive() for p in procs), "a rank did not finish"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def reference(case, mesh):
    """The JAX functions on the 1-device mesh and numpy, for one case."""
    grid = JGrid(tuple(case["volume"]), tuple(case["cuboid"]))
    vol = worker.case_volume(case)
    packed = j_shard(jnp.asarray(j_pack(vol, grid)), mesh)
    want = {}
    for i, (lo, hi) in enumerate(case["boxes"]):
        got = np.asarray(j_cutout(packed, grid, lo, hi, mesh))
        np.testing.assert_array_equal(got, vol[tuple(slice(l, h) for l, h in zip(lo, hi))])
        want[f"cut{i}"] = got
    expect = vol.copy()
    for lo, data in case["writes"]:
        packed = j_write(packed, grid, lo, jnp.asarray(data), mesh)
        expect[tuple(slice(l, l + s) for l, s in zip(lo, data.shape))] = data
    want["after"] = np.asarray(j_cutout(packed, grid, (0,) * grid.rank,
                                        grid.volume_shape, mesh))
    np.testing.assert_array_equal(want["after"], expect)
    return want


def writes(dtype, shape_lo):
    rng = np.random.default_rng(21)
    patch = rng.integers(1, 200, size=(6, 5, 3)).astype(dtype)
    zeros = np.zeros((9, 4, 3), dtype=dtype)   # zeros clobber: an explicit mask
    mixed = (rng.integers(0, 2, size=(11, 13, 5)) * 77).astype(dtype)
    return [((5, 6, 2), patch), ((2, 10, 1), zeros), (shape_lo, mixed)]


CASES = {
    # tests/test_distributed.py's grid and boxes, plus boxes across segments
    "uint8": dict(volume=(32, 32, 8), cuboid=(8, 8, 4), dtype="uint8", seed=1,
                  boxes=[((0, 0, 0), (8, 8, 4)), ((3, 5, 1), (27, 30, 7)),
                         ((8, 8, 0), (24, 24, 8)), ((15, 0, 3), (17, 32, 5)),
                         ((31, 31, 7), (32, 32, 8))]),
    # a ragged grid (padding cells) in uint16 and float32
    "uint16": dict(volume=(36, 20, 12), cuboid=(8, 8, 4), dtype="uint16", seed=2,
                   boxes=[((0, 0, 0), (36, 20, 12)), ((7, 9, 3), (33, 19, 11))]),
    "float32": dict(volume=(16, 16, 8), cuboid=(8, 8, 4), dtype="float32", seed=3,
                    boxes=[((1, 2, 3), (15, 14, 8))]),
}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_distributed_cutout_and_write_match_jax_and_numpy(name, world, tmp_path, mesh1):
    case = dict(CASES[name])
    case["writes"] = writes(case["dtype"], (20, 3, 2) if name != "float32" else (3, 3, 3))
    want = reference(case, mesh1)
    got = spawn(world, case, tmp_path)
    grid = CuboidGrid(case["volume"], case["cuboid"])
    segs = morton.partition_curve(grid.n_cells, world)
    packed_after = pack_to_cuboids(torch.from_numpy(want["after"].copy()), grid).numpy()
    for r, out in enumerate(got):
        for k, w in want.items():
            assert out[k].dtype == w.dtype
            np.testing.assert_array_equal(out[k], w, err_msg=f"rank {r} {k}")
        a, b = segs[r]
        np.testing.assert_array_equal(out["shard"], packed_after[a:b])


def test_more_ranks_than_cells(tmp_path, mesh1):
    """Two cells over four ranks: two ranks own nothing (empty segments),
    and they still take part in every gather."""
    case = dict(volume=(16, 8, 4), cuboid=(8, 8, 4), dtype="int32", seed=4,
                boxes=[((0, 0, 0), (16, 8, 4)), ((7, 1, 1), (9, 8, 3))],
                writes=[((6, 2, 0), np.full((4, 3, 2), -5, np.int32))])
    want = reference(case, mesh1)
    got = spawn(4, case, tmp_path)
    assert [o["shard"].shape[0] for o in got] == [1, 1, 0, 0]
    for out in got:
        for k, w in want.items():
            np.testing.assert_array_equal(out[k], w)


def test_shard_cuboids_is_the_curve_segment():
    grid = CuboidGrid((36, 20, 12), (8, 8, 4))
    packed = pack_to_cuboids(torch.arange(36 * 20 * 12, dtype=torch.int32)
                             .reshape(36, 20, 12), grid)
    for world in (1, 3, 4, 200):
        parts = [shard_cuboids(packed, r, world) for r in range(world)]
        assert torch.equal(torch.cat(parts), packed)
        assert [p.shape[0] for p in parts] == [b - a for a, b in
                                               morton.partition_curve(grid.n_cells, world)]
        assert parts[0].data_ptr() == packed.data_ptr()  # a view, no copy
