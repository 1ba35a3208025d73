"""Port parity for the whole slice: ingest -> hierarchy -> parallel detection
-> batched annotation writes, against the JAX reference on the same volume.

One worker on each side, so the reference hands out identifiers in tile
order and the two metadata tables line up id for id.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import vision as jv
from repro.core import cutout as jcut
from repro.core.annotations import AnnotationProject as JProject
from repro.core.cuboid import DatasetSpec as JSpec
from repro.core.store import CuboidStore, MemoryBackend
from repro_torch import carry
from repro_torch import vision as tv
from repro_torch.core import cutout as tcut
from repro_torch.core.annotations import AnnotationProject
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import DeviceCuboidStore

SHAPE = (128, 128, 32)
TILE = (64, 64, 32)
KW = dict(name="cortex", volume_shape=SHAPE, dtype="float32",
          n_resolutions=2, base_cuboid=(32, 32, 16))
RUN = dict(r=0, tile=TILE, n_workers=1, threshold=2.0, min_voxels=4,
           batch_size=40, lowres_level=1)


def synthetic_cortex(shape=SHAPE, n_synapses=24, seed=7):
    """The volume of examples/synapse_pipeline.py."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(100, 4, size=shape).astype(np.float32)
    for _ in range(n_synapses):
        c = [int(rng.integers(8, s - 8)) for s in shape]
        xx, yy, zz = np.ogrid[:shape[0], :shape[1], :shape[2]]
        d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + ((zz - c[2]) * 2) ** 2
        vol += 90.0 * np.exp(-d2 / 9.0)
    vol[40:90, 40:50, :] += 60.0
    return vol


@pytest.fixture(scope="module")
def runs():
    vol = synthetic_cortex()
    jstore = CuboidStore(JSpec(**KW))
    jcut.ingest(jstore, 0, vol)
    jcut.build_hierarchy(jstore)
    jproj = JProject("detections", jstore.spec, write_path_backend=MemoryBackend())
    jn = jv.run_parallel_detection(jstore, jproj, **RUN)

    tstore = DeviceCuboidStore(DatasetSpec(**KW), device="cpu")
    tcut.ingest(tstore, 0, vol)
    tcut.build_hierarchy(tstore)
    tproj = AnnotationProject("detections", tstore.spec, device="cpu")
    tn = tv.run_parallel_detection(tstore, tproj, **RUN)
    return vol, jstore, jproj, jn, tstore, tproj, tn


def test_no_tile_response_at_the_threshold(runs):
    """Exact parity presumes no reference response within 1e-4 of the
    threshold (float sums differ in order between the two frameworks)."""
    _, jstore, *_ = runs
    for x0 in range(0, SHAPE[0], TILE[0]):
        for y0 in range(0, SHAPE[1], TILE[1]):
            tile = jcut.cutout(jstore, 0, (x0, y0, 0),
                               (x0 + TILE[0], y0 + TILE[1], SHAPE[2]))
            resp = np.asarray(jv.difference_of_gaussians(jnp.asarray(tile)))
            resp = (resp - resp.mean()) / (resp.std() + 1e-6)
            assert np.abs(resp - RUN["threshold"]).min() > 1e-4


def test_same_count_and_metadata(runs):
    *_, jproj, jn, _, tproj, tn = runs
    assert tn == jn >= 20
    ids = jproj.meta.query(("ann_type", "eq", "synapse"))
    assert tproj.meta.query(("ann_type", "eq", "synapse")) == ids
    for i in ids:
        j, t = jproj.meta.get(i), tproj.meta.get(i)
        assert t.kv == j.kv and t.ann_type == j.ann_type
        assert abs(t.confidence - j.confidence) <= 1e-6
        assert tproj.index.cuboids(i) == jproj.index.cuboids(i)


def test_annotation_volume_and_voxel_lists(runs):
    _, _, jproj, _, _, tproj, _ = runs
    want = jproj.read(0, (0, 0, 0), SHAPE)
    got = carry.store_to_numpy(tproj.store)[0]
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tproj.read(0, (0, 0, 0), SHAPE).numpy().view(np.uint32), want)
    for i in jproj.meta.query():
        np.testing.assert_array_equal(tproj.voxel_list(i, 0),
                                      jproj.voxel_list(i, 0))
        np.testing.assert_array_equal(tproj.centroid(i, 0),
                                      jproj.centroid(i, 0))


def test_carry_round_trip_from_jax_levels(runs):
    """The reference's dense levels load into a device store unchanged."""
    _, jstore, *_ = runs
    levels = {r: jcut.cutout(jstore, r, (0, 0, 0), jstore.spec.grid(r).volume_shape)
              for r in range(2)}
    store = carry.store_from_numpy(DatasetSpec(**KW), levels, device="cpu")
    back = carry.store_to_numpy(store)
    for r in range(2):
        np.testing.assert_array_equal(back[r], levels[r])
    sub = tcut.cutout(store, 1, (3, 5, 7), (50, 40, 30))
    np.testing.assert_array_equal(sub.numpy(), levels[1][3:50, 5:40, 7:30])


def test_batch_write_preserve_and_overlap_match_sequential():
    """A batch equals its objects written one by one, for both disciplines."""
    spec = DatasetSpec("p", (24, 24, 8), n_resolutions=1, base_cuboid=(8, 8, 4))
    rng = np.random.default_rng(2)
    objs = [((int(rng.integers(-2, 20)), int(rng.integers(0, 20)), 0),
             rng.random((6, 7, 5)) < 0.5) for _ in range(9)]
    for disc in ("overwrite", "preserve"):
        jproj = JProject("a", JSpec("p", (24, 24, 8), n_resolutions=1,
                                    base_cuboid=(8, 8, 4)))
        tproj = AnnotationProject("a", spec, device="cpu")
        seed = np.zeros((24, 24, 8), dtype=np.uint32)
        seed[10:14, 10:14, 2:6] = 99
        jproj.write(0, (0, 0, 0), seed)
        tproj.write(0, (0, 0, 0), seed)
        from repro.core.annotations import Annotation as JAnn
        from repro_torch.core.annotations import Annotation as TAnn
        jids = jproj.batch_write_objects(
            0, [(JAnn(0), lo, m.astype(np.uint32)) for lo, m in objs], disc)
        tids = tproj.batch_write_objects(
            0, [(TAnn(0), lo, torch.from_numpy(m)) for lo, m in objs], disc)
        assert jids == tids
        np.testing.assert_array_equal(
            tproj.read(0, (0, 0, 0), (24, 24, 8)).numpy().view(np.uint32),
            jproj.read(0, (0, 0, 0), (24, 24, 8)))
        for i in [99] + jids:
            assert tproj.index.cuboids(i) == jproj.index.cuboids(i)


class _CountingRows(dict):
    """A row dict that counts the keys iterated over."""
    visited = 0

    def __iter__(self):
        for k in super().__iter__():
            self.visited += 1
            yield k


@pytest.mark.parametrize("side", ["reference", "port"])
def test_metadata_create_cost(side):
    """Reference fault (pinned): `MetadataTable.create` rescans every row
    (``max(self._rows)``) on each insert, so n creates visit n(n+1)/2 keys
    — seconds per tile at the paper's detection counts.  The port keeps a
    running max and visits none, with the same ids."""
    from repro.core.annotations import MetadataTable as JTable
    from repro_torch.core.annotations import MetadataTable as TTable

    table = (JTable if side == "reference" else TTable)()
    table._rows = rows = _CountingRows()
    n = 200
    ids = [table.create(ann_type="synapse").ann_id for _ in range(n)]
    ids.append(table.create(ann_id=5000).ann_id)
    ids.append(table.create(ann_type="seed").ann_id)
    assert ids == list(range(1, n + 1)) + [5000, 5001]
    if side == "reference":
        assert rows.visited >= n * (n + 1) // 2
    else:
        assert rows.visited == 0


BIG_ID = 3_000_000_000  # past 2^31: a negative int32 on the device


def _big_id_projects():
    kw = dict(n_resolutions=1, base_cuboid=(16, 16, 4))
    return (JProject("a", JSpec("p", (32, 32, 16), **kw)),
            AnnotationProject("a", DatasetSpec("p", (32, 32, 16), **kw), device="cpu"))


def _big_id_block():
    block = np.zeros((8, 8, 4), dtype=np.uint32)
    block[[1, 2, 5, 7], [0, 3, 3, 6], [0, 1, 2, 3]] = BIG_ID
    return block


@pytest.mark.parametrize("labels", ["numpy", "torch_uint32"])
def test_label_ids_past_2_31_write_and_list(labels):
    """Ids are uint32 at the boundaries: a label of 3e9 is indexed and
    listed under 3e9, as in the reference (which holds uint32 labels)."""
    jproj, tproj = _big_id_projects()
    block = _big_id_block()
    jproj.write(0, (0, 0, 0), block)
    tproj.write(0, (0, 0, 0), block if labels == "numpy" else torch.from_numpy(block))
    want = jproj.voxel_list(BIG_ID, 0)
    assert len(want) == 4
    np.testing.assert_array_equal(tproj.voxel_list(BIG_ID, 0), want)
    assert tproj.index.cuboids(BIG_ID) == jproj.index.cuboids(BIG_ID)
    np.testing.assert_array_equal(
        tproj.read(0, (0, 0, 0), (32, 32, 16)).numpy().view(np.uint32),
        jproj.read(0, (0, 0, 0), (32, 32, 16)))


def test_label_ids_past_2_31_batch_write():
    from repro.core.annotations import Annotation as JAnn
    from repro_torch.core.annotations import Annotation as TAnn

    jproj, tproj = _big_id_projects()
    mask = _big_id_block() != 0
    lo = (13, 9, 2)  # across cuboid boundaries
    jids = jproj.batch_write_objects(0, [(JAnn(ann_id=BIG_ID), lo, mask.astype(np.uint32))])
    tids = tproj.batch_write_objects(0, [(TAnn(ann_id=BIG_ID), lo, torch.from_numpy(mask))])
    assert jids == tids == [BIG_ID]
    want = jproj.voxel_list(BIG_ID, 0)
    assert len(want) == 4
    np.testing.assert_array_equal(tproj.voxel_list(BIG_ID, 0), want)
    assert tproj.index.cuboids(BIG_ID) == jproj.index.cuboids(BIG_ID)
    np.testing.assert_array_equal(
        tproj.read(0, (0, 0, 0), (32, 32, 16)).numpy().view(np.uint32),
        jproj.read(0, (0, 0, 0), (32, 32, 16)))
