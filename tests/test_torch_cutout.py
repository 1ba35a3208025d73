"""Port parity: packed layout, cutout gather, writes and the hierarchy.

The same seeded numpy inputs go through the JAX reference (`repro`) and the
PyTorch port (`repro_torch`, on the CPU); data movement must be bit-exact.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cutout as jcut
from repro.core.cuboid import CuboidGrid as JGrid
from repro.core.cuboid import DatasetSpec as JSpec
from repro.core.distributed import pack_to_cuboids as j_pack
from repro.core.distributed import unpack_from_cuboids as j_unpack
from repro.core.store import CuboidStore
from repro.kernels.cutout_gather.ops import cutout_gather as j_gather
from repro_torch.core import cutout as tcut
from repro_torch.core.cuboid import CuboidGrid, DatasetSpec
from repro_torch.core.distributed import pack_to_cuboids, unpack_from_cuboids
from repro_torch.core.store import DeviceCuboidStore
from repro_torch.kernels.cutout_gather.ops import build_plan, cutout_gather

CPU = "cpu"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("shapes", [((20, 12, 6), (8, 8, 4)),
                                    ((64, 64, 32), (8, 8, 8)),
                                    ((33, 17, 9), (16, 8, 4))])
def test_pack_unpack_bit_exact(dtype, shapes):
    vol_shape, cs = shapes
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 250, size=vol_shape).astype(dtype)
    want = j_pack(vol, JGrid(vol_shape, cs))
    got = pack_to_cuboids(torch.from_numpy(vol), CuboidGrid(vol_shape, cs))
    np.testing.assert_array_equal(_np(got), want)
    assert got.dtype == torch.from_numpy(vol).dtype
    back = unpack_from_cuboids(got, CuboidGrid(vol_shape, cs))
    np.testing.assert_array_equal(_np(back), j_unpack(want, JGrid(vol_shape, cs)))


@pytest.mark.parametrize("dtype", ["float32", "uint8", "int32"])
@pytest.mark.parametrize("box", [((0, 0, 0), (32, 32, 16)),
                                 ((8, 16, 8), (40, 48, 16)),
                                 ((5, 3, 2), (37, 45, 14)),   # unaligned
                                 ((60, 0, 31), (64, 64, 32))])  # volume edge
def test_cutout_gather_matches_jax(dtype, box):
    shape, cs = (64, 64, 32), (8, 8, 8)
    rng = np.random.default_rng(42)
    vol = rng.integers(0, 200, size=shape).astype(dtype)
    packed_np = j_pack(vol, JGrid(shape, cs))
    lo, hi = box
    want = np.asarray(j_gather(jnp.asarray(packed_np), JGrid(shape, cs), lo, hi))
    got = cutout_gather(torch.from_numpy(packed_np), CuboidGrid(shape, cs), lo, hi)
    assert got.dtype == torch.from_numpy(packed_np).dtype
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(want, vol[tuple(slice(l, h) for l, h in zip(lo, hi))])


def test_build_plan_matches_jax():
    from repro.kernels.cutout_gather.ops import build_plan as j_plan

    shape, cs = (64, 48, 32), (8, 16, 8)
    for lo, hi in [((0, 0, 0), (64, 48, 32)), ((5, 17, 3), (41, 30, 29))]:
        g1, c1, a1 = j_plan(JGrid(shape, cs), lo, hi)
        g2, c2, a2 = build_plan(CuboidGrid(shape, cs), lo, hi)
        assert g1 == g2 and list(a1) == list(a2)
        np.testing.assert_array_equal(c1, c2)
        assert c2.dtype == np.int32


def _pair(spec_kwargs):
    jspec = JSpec(**spec_kwargs)
    tspec = DatasetSpec(**spec_kwargs)
    return CuboidStore(jspec), DeviceCuboidStore(tspec, device=CPU)


def _assert_levels_equal(jstore, tstore):
    spec = jstore.spec
    for r in range(spec.n_resolutions):
        shape = spec.grid(r).volume_shape
        want = jcut.cutout(jstore, r, (0,) * len(shape), shape)
        got = _np(tcut.cutout(tstore, r, (0,) * len(shape), shape))
        np.testing.assert_array_equal(got, want, err_msg=f"level {r}")


@pytest.mark.parametrize("dtype", ["uint8", "float32", "uint16"])
@pytest.mark.parametrize("vol_shape", [(64, 48, 20), (37, 45, 14)])
def test_ingest_write_hierarchy_match_jax(dtype, vol_shape):
    kw = dict(name="em", volume_shape=vol_shape, dtype=dtype,
              n_resolutions=3, base_cuboid=(16, 8, 4))
    jstore, tstore = _pair(kw)
    rng = np.random.default_rng(7)
    vol = rng.integers(0, 255, size=vol_shape).astype(dtype)
    vol[: vol_shape[0] // 3] = 0                     # an all-zero region
    jcut.ingest(jstore, 0, vol)
    tcut.ingest(tstore, 0, vol)
    _assert_levels_equal(jstore, tstore)

    # overwrite with zeros mixed in (zeros keep the stored voxel), then
    # preserve over a box that hangs past the volume edge
    patch = rng.integers(0, 3, size=(9, 11, 5)).astype(dtype) * 77
    for lo, disc in [((3, 5, 2), "overwrite"), ((vol_shape[0] - 4, 1, 10),
                                                "preserve")]:
        jcut.write_cutout(jstore, 0, lo, patch, discipline=disc)
        tcut.write_cutout(tstore, 0, lo, patch, discipline=disc)
    _assert_levels_equal(jstore, tstore)

    jcut.build_hierarchy(jstore)
    tcut.build_hierarchy(tstore)
    _assert_levels_equal(jstore, tstore)


def test_label_hierarchy_and_rebuild_match_jax():
    """Stride-sampled label pyramid, rebuilt over stale upper levels."""
    kw = dict(name="lab", volume_shape=(40, 40, 8), dtype="uint32",
              n_resolutions=3, base_cuboid=(8, 8, 4))
    jstore, tstore = _pair(kw)
    rng = np.random.default_rng(11)
    lab = (rng.integers(0, 4, size=(40, 40, 8)) * 1000003).astype(np.uint32)
    jcut.ingest(jstore, 0, lab)
    tcut.ingest(tstore, 0, lab)
    jcut.build_hierarchy(jstore, labels=True)
    tcut.build_hierarchy(tstore, labels=True)
    # a second write + rebuild merges over the existing upper levels
    patch = np.full((8, 8, 4), 7, dtype=np.uint32)
    jcut.write_cutout(jstore, 0, (16, 16, 0), patch)
    tcut.write_cutout(tstore, 0, (16, 16, 0), patch)
    jcut.build_hierarchy(jstore, labels=True)
    tcut.build_hierarchy(tstore, labels=True)
    for r in range(3):
        shape = kw["volume_shape"] if r == 0 else jstore.spec.grid(r).volume_shape
        want = jcut.cutout(jstore, r, (0, 0, 0), shape)
        got = _np(tcut.cutout(tstore, r, (0, 0, 0), shape)).view(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_slabbed_write_matches_single_box(monkeypatch):
    """A write split into cuboid-plane slabs equals the one-box write."""
    kw = dict(name="em", volume_shape=(64, 32, 16), dtype="uint8",
              n_resolutions=2, base_cuboid=(8, 8, 8))
    jstore, tstore = _pair(kw)
    vol = np.random.default_rng(5).integers(0, 255, size=(64, 32, 16),
                                            dtype=np.uint8)
    monkeypatch.setattr(tcut, "SLAB_ELEMENTS", 8 * 8 * 8 * 4)
    jcut.ingest(jstore, 0, vol)
    tcut.ingest(tstore, 0, vol)
    jcut.build_hierarchy(jstore)
    tcut.build_hierarchy(tstore)
    _assert_levels_equal(jstore, tstore)


def test_unwritten_level_reads_zero_and_exception_waits():
    spec = DatasetSpec("z", (16, 16, 8), n_resolutions=2, base_cuboid=(8, 8, 4))
    store = DeviceCuboidStore(spec, device=CPU)
    out = tcut.cutout(store, 1, (0, 0, 0), (8, 8, 8))
    assert out.shape == (8, 8, 8) and not out.any()
    assert store.peek(1) is None and store.nbytes == 0
    with pytest.raises(NotImplementedError):
        tcut.write_cutout(store, 0, (0, 0, 0), np.ones((2, 2, 2), np.uint8),
                          discipline="exception")


def test_reference_write_race_loses_an_update():
    """Reference fault (pinned): `write_cutout` reads, merges and stores a
    cuboid with no lock across the three steps, so two writers of disjoint
    voxels in one cuboid can both read the old block and the second store
    drops the first writer's voxels."""
    store = CuboidStore(JSpec("w", (16, 16, 8), base_cuboid=(8, 8, 4)))
    barrier = threading.Barrier(2)
    fetch = store.fetch_runs

    def fetch_then_meet(*args, **kwargs):
        out = fetch(*args, **kwargs)
        barrier.wait(timeout=10)   # both writers hold the old block
        return out

    store.fetch_runs = fetch_then_meet
    writers = [threading.Thread(target=jcut.write_cutout, args=(
        store, 0, (x0, 0, 0), np.full((4, 8, 4), v, np.uint8)))
        for x0, v in ((0, 1), (4, 2))]
    for w in writers:
        w.start()
    for w in writers:
        w.join(timeout=10)
    assert not any(w.is_alive() for w in writers)
    block = jcut.cutout(store, 0, (0, 0, 0), (8, 8, 4))
    assert (block[:4] == 1).all() != (block[4:] == 2).all()  # one write lost


def test_port_concurrent_writes_keep_every_update():
    """The device store serialises read-modify-write: many writers of
    disjoint voxels in shared cuboids all survive."""
    spec = DatasetSpec("w", (32, 16, 8), base_cuboid=(8, 8, 4))
    store = DeviceCuboidStore(spec, device=CPU)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writers = [threading.Thread(target=tcut.write_cutout, args=(
            store, 0, (x0, 0, 0), np.full((1, 16, 8), x0 + 1, np.uint8)))
            for x0 in range(32)]
        for w in writers:
            w.start()
        for w in writers:
            w.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in writers)
    vol = _np(tcut.cutout(store, 0, (0, 0, 0), (32, 16, 8)))
    np.testing.assert_array_equal(vol[:, 0, 0], np.arange(1, 33))
    assert (vol == vol[:, :1, :1]).all()
