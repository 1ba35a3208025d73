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
        np.testing.assert_array_equal(got.view(want.dtype), want, err_msg=f"level {r}")


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
    """An unwritten level reads zeros and is not allocated; the
    ``exception`` discipline, ported now, merges as ``preserve`` (a stored
    voxel wins) and leaves other levels unallocated; an unknown
    discipline raises."""
    spec = DatasetSpec("z", (16, 16, 8), n_resolutions=2, base_cuboid=(8, 8, 4))
    store = DeviceCuboidStore(spec, device=CPU)
    out = tcut.cutout(store, 1, (0, 0, 0), (8, 8, 8))
    assert out.shape == (8, 8, 8) and not out.any()
    assert store.peek(1) is None and store.nbytes == 0
    tcut.write_cutout(store, 0, (0, 0, 0), np.full((2, 2, 2), 5, np.uint8))
    tcut.write_cutout(store, 0, (1, 1, 1), np.full((2, 2, 2), 9, np.uint8),
                      discipline="exception")
    got = _np(tcut.cutout(store, 0, (0, 0, 0), (3, 3, 3)))
    want = np.zeros((3, 3, 3), np.uint8)
    want[1:, 1:, 1:] = 9
    want[:2, :2, :2] = 5
    np.testing.assert_array_equal(got, want)
    assert store.peek(1) is None
    with pytest.raises(ValueError, match="unknown discipline"):
        tcut.write_cutout(store, 0, (0, 0, 0), np.ones((2, 2, 2), np.uint8),
                          discipline="merge")


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


# -- time series (rank 4) and channels -------------------------------------

TS = dict(name="ts", volume_shape=(32, 32, 8, 16), scaled_dims=(0, 1),
          base_cuboid=(8, 8, 4, 4))


@pytest.mark.parametrize("box", [((3, 4, 1, 2), (19, 22, 7, 13)),   # the reference's
                                 ((0, 0, 0, 0), (32, 32, 8, 16)),
                                 ((8, 8, 4, 4), (16, 24, 8, 12)),   # aligned
                                 ((31, 0, 7, 15), (32, 32, 8, 16)),  # volume edge
                                 ((5, 5, 5, 5), (6, 6, 6, 6))])
def test_4d_timeseries_cutout_matches_jax(box):
    """The reference's rank-4 case (tests/test_cutout.py
    `test_4d_timeseries_curve`) through the port's cutout, which goes
    through `cutout_gather` at rank 4."""
    jstore, tstore = _pair(TS)
    rng = np.random.default_rng(2)
    vol = rng.integers(0, 255, size=TS["volume_shape"], dtype=np.uint8)
    jcut.ingest(jstore, 0, vol)
    tcut.ingest(tstore, 0, vol)
    lo, hi = box
    want = jcut.cutout(jstore, 0, lo, hi)
    got = _np(tcut.cutout(tstore, 0, lo, hi))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol[tuple(slice(l, h) for l, h in zip(lo, hi))])


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_4d_write_and_hierarchy_match_jax(dtype):
    """Rank-4 writes (both disciplines, past the edge) and the hierarchy,
    level for level against the reference."""
    kw = TS | dict(n_resolutions=3, dtype=dtype, volume_shape=(24, 20, 8, 12))
    jstore, tstore = _pair(kw)
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 200, size=kw["volume_shape"]).astype(dtype)
    jcut.ingest(jstore, 0, vol)
    tcut.ingest(tstore, 0, vol)
    patch = (rng.integers(0, 3, size=(7, 9, 3, 5)) * 40).astype(dtype)
    for lo, disc in [((3, 2, 1, 4), "overwrite"), ((20, 15, 6, 9), "preserve")]:
        jcut.write_cutout(jstore, 0, lo, patch, discipline=disc)
        tcut.write_cutout(tstore, 0, lo, patch, discipline=disc)
    jcut.build_hierarchy(jstore)
    tcut.build_hierarchy(tstore)
    _assert_levels_equal(jstore, tstore)


@pytest.mark.parametrize("cs", [(8, 8, 4, 4), (4, 8, 2, 8), (16, 16, 8, 2)])
def test_cutout_gather_rank4_matches_slicing(cs):
    """`cutout_gather` on a rank-4 packed array (the port's own packing,
    held against the reference's) equals numpy slicing."""
    shape = (3 * cs[0] - 1, 2 * cs[1] + 3, 2 * cs[2], 3 * cs[3] - 2)
    vol = np.random.default_rng(4).integers(0, 250, size=shape).astype(np.uint8)
    packed_np = j_pack(vol, JGrid(shape, cs))
    packed = pack_to_cuboids(torch.from_numpy(vol), CuboidGrid(shape, cs))
    np.testing.assert_array_equal(_np(packed), packed_np)
    for lo, hi in [((0, 0, 0, 0), shape), ((1, 2, 1, 3), (shape[0] - 2, shape[1] - 1,
                                                           shape[2] - 1, shape[3] - 1))]:
        got = cutout_gather(packed, CuboidGrid(shape, cs), lo, hi)
        np.testing.assert_array_equal(_np(got), vol[tuple(slice(l, h)
                                                           for l, h in zip(lo, hi))])


def test_multichannel_separate_cuboids_match_jax():
    """The reference's channel case (tests/test_cutout.py
    `test_multichannel_separate_cuboids`): each channel has cuboids of its
    own, written, propagated and read per channel."""
    kw = dict(name="ch", volume_shape=(16, 16, 8), n_channels=3, n_resolutions=2,
              base_cuboid=(8, 8, 4), dtype="uint16")
    jstore, tstore = _pair(kw)
    rng = np.random.default_rng(6)
    for c in range(3):
        jcut.write_cutout(jstore, 0, (0, 0, 0), np.full((16, 16, 8), c + 1, np.uint16),
                          channel=c)
        tcut.write_cutout(tstore, 0, (0, 0, 0), np.full((16, 16, 8), c + 1, np.uint16),
                          channel=c)
    patch = rng.integers(0, 60000, size=(5, 6, 3)).astype(np.uint16)
    jcut.write_cutout(jstore, 0, (3, 9, 2), patch, channel=1, discipline="preserve")
    tcut.write_cutout(tstore, 0, (3, 9, 2), patch, channel=1, discipline="preserve")
    jcut.ingest(jstore, 0, patch, channel=2, offset=(10, 1, 4))
    tcut.ingest(tstore, 0, patch, channel=2, offset=(10, 1, 4))
    for c in range(3):
        jcut.build_hierarchy(jstore, channel=c)
        tcut.build_hierarchy(tstore, channel=c)
    for c in range(3):
        assert (_np(tcut.cutout(tstore, 0, (0, 0, 0), (16, 16, 8), channel=c))
                == (c + 1)).sum() > 0
        for r in range(2):
            shape = jstore.spec.grid(r).volume_shape
            np.testing.assert_array_equal(
                _np(tcut.cutout(tstore, r, (0, 0, 0), shape, channel=c)),
                jcut.cutout(jstore, r, (0, 0, 0), shape, channel=c))
    assert tstore.peek(0, 2) is not None
    with pytest.raises(ValueError, match="channel 3"):
        tstore.peek(0, 3)


def test_carry_takes_channels():
    from repro_torch import carry

    spec = DatasetSpec("ch", (16, 16, 8), n_channels=2, base_cuboid=(8, 8, 4),
                       dtype="uint16")
    rng = np.random.default_rng(8)
    vols = {(0, c): rng.integers(0, 65535, size=(16, 16, 8)).astype(np.uint16)
            for c in range(2)}
    store = carry.store_from_numpy(spec, vols, device=CPU)
    for c in range(2):
        np.testing.assert_array_equal(carry.store_to_numpy(store, channel=c)[0],
                                      vols[(0, c)])


# -- projections, batches, exception reports --------------------------------

BIG = 3_000_000_000  # a uint32 label past 2^31


def _projection_pair(dtype):
    kw = dict(name="p", volume_shape=(40, 36, 12), base_cuboid=(16, 16, 4),
              dtype=dtype)
    jstore, tstore = _pair(kw)
    rng = np.random.default_rng(9)
    if dtype == "uint32":
        vol = rng.integers(0, 4, size=kw["volume_shape"]).astype(np.uint32) * 1_000_000_007
        vol[5:9, 2:30, 3] = BIG
        vol[20, 20, :] = 2 ** 32 - 1
    else:
        vol = (rng.random(kw["volume_shape"]) * 250).astype(dtype)
    jcut.ingest(jstore, 0, vol)
    tcut.ingest(tstore, 0, vol)
    return jstore, tstore


@pytest.mark.parametrize("dtype", ["uint8", "uint32", "float32"])
@pytest.mark.parametrize("reduce", ["slice", "max", "mean"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_project_matches_jax(dtype, reduce, axis):
    """Bit-equal for integers (uint32 ids past 2^31 compare unsigned in
    ``max``; an integer ``mean`` averages in float64 and truncates); a
    float32 ``mean`` within a relative 1e-6 (numpy sums pairwise in
    float32)."""
    jstore, tstore = _projection_pair(dtype)
    for lo, hi in [((0, 0, 0), (40, 36, 12)), ((3, 5, 2), (37, 31, 11)),
                   ((-4, 30, 1), (50, 36, 9))]:
        want = jcut.project(jstore, 0, lo, hi, axis, reduce)
        got = tcut.project(tstore, 0, lo, hi, axis, reduce)
        got = _np(got).view(np.uint32) if dtype == "uint32" else _np(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "float32" and reduce == "mean":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    if dtype == "uint32" and reduce == "max":
        assert (got >= 2 ** 31).any()  # a signed max would not pick these


def test_project_refuses_an_unknown_reduction_and_an_empty_slice():
    jstore, tstore = _projection_pair("uint8")
    with pytest.raises(ValueError, match="unknown reduce"):
        tcut.project(tstore, 0, (0, 0, 0), (4, 4, 4), 0, "median")
    with pytest.raises(IndexError):
        jcut.project(jstore, 0, (0, 0, 12), (4, 4, 14), 2, "slice")
    with pytest.raises(IndexError):
        tcut.project(tstore, 0, (0, 0, 12), (4, 4, 14), 2, "slice")


def test_batch_cutout_matches_jax_in_request_order():
    jstore, tstore = _projection_pair("uint8")
    rng = np.random.default_rng(10)
    boxes = []
    for _ in range(12):
        lo = [int(rng.integers(-3, s - 1)) for s in (40, 36, 12)]
        hi = [l + int(rng.integers(1, 20)) for l in lo]
        boxes.append((lo, hi))
    want = jcut.batch_cutout(jstore, 0, boxes)
    got = tcut.batch_cutout(tstore, 0, boxes)
    assert len(got) == len(want) == len(boxes)
    for g, w, (lo, hi) in zip(got, want, boxes):
        np.testing.assert_array_equal(_np(g), w)
        np.testing.assert_array_equal(_np(g), _np(tcut.cutout(tstore, 0, lo, hi)))


@pytest.mark.parametrize("dtype", ["uint32", "uint8", "float32"])
def test_exception_reports_match_jax(dtype, monkeypatch):
    """``on_conflict`` gets the reference's calls: the same cuboids in
    ascending Morton order, origins, and full-cuboid old and new blocks,
    across slabs and at the volume edge; the merge is ``preserve``'s."""
    monkeypatch.setattr(tcut, "SLAB_ELEMENTS", 16 * 16 * 4 * 2)  # several slabs
    kw = dict(name="e", volume_shape=(45, 36, 12), base_cuboid=(16, 16, 4),
              dtype=dtype)
    jstore, tstore = _pair(kw)
    rng = np.random.default_rng(12)
    big = BIG if dtype == "uint32" else 7
    first = (rng.integers(0, 3, size=(45, 36, 12)) * big).astype(dtype)
    second = (rng.integers(0, 3, size=(30, 30, 9)) * 5).astype(dtype)
    second[0, 0, 0] = first[14, 5, 2]  # same label: no conflict
    jcut.ingest(jstore, 0, first)
    tcut.ingest(tstore, 0, first)
    calls = {"j": [], "t": []}
    for side, mod, store in (("j", jcut, jstore), ("t", tcut, tstore)):
        mod.write_cutout(store, 0, (14, 5, 2), second, discipline="exception",
                         on_conflict=lambda m, o, a, b, k=side: calls[k].append(
                             (m, tuple(o), a.copy(), b.copy())))
    assert len(calls["t"]) == len(calls["j"]) > 3
    for (m1, o1, a1, b1), (m2, o2, a2, b2) in zip(calls["j"], calls["t"]):
        assert (m1, o1) == (m2, o2)
        assert a2.dtype == a1.dtype and b2.dtype == b1.dtype
        np.testing.assert_array_equal(a2, a1)
        np.testing.assert_array_equal(b2, b1)
    _assert_levels_equal(jstore, tstore)
