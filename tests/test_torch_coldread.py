"""Port parity: cold reads and write-through of the device store over the
host tiers.

One tier's contents (written by the reference, moved with `carry`) go
under the reference `CuboidStore` and under the port's `DeviceCuboidStore`
over a port `CuboidStore`; cutouts, `CutoutStats` (with and without
``max_runs``) and the first cold read's path counters must be equal, with
decode workers 1 and 4, with and without a `CuboidCache`.  The same
writes in each discipline, ``ingest`` and ``build_hierarchy`` must leave
equal keys, equal decompressed cuboids and equal ``write_stats.writes``.
Residency: a cuboid is loaded once however many readers want it, a failed
load is retried, and a lazy cuboid counts as resident.  The port's witness
is on for every test (`torch_witness`).
"""
import threading
import time

import numpy as np
import pytest
from torch_witness import port_witness  # noqa: F401

from repro.cluster import cache as jcache
from repro.core import cutout as jcut
from repro.core import store as jstore
from repro.core import wal as jwal
from repro.core.cuboid import DatasetSpec as JSpec
from repro_torch import carry
from repro_torch.cluster import attach_cache, enable_write_behind
from repro_torch.core import cutout as tcut
from repro_torch.core import morton
from repro_torch.core import store as tstore
from repro_torch.core import wal as twal
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import (CuboidStore, DecodePolicy, DeviceCuboidStore,
                                    MemoryBackend, decompress, host_view)
from repro_torch.kernels.cutout_gather.ops import build_plan

SHAPE = (32, 32, 16)
CUBOID = (8, 8, 4)
BIG = 3_000_000_000  # a uint32 id past 2^31: a negative int32 on the device

POLICIES = {"workers1": dict(workers=1, chunk=2, prefetch_segments=0),
            "workers4": dict(workers=4, chunk=2, prefetch_segments=0),
            "pipelined4": dict(workers=4, chunk=2, prefetch_segments=2)}


def spec_kw(shape=SHAPE, dtype="uint8", **kw):
    return dict(name="cr", volume_shape=shape, dtype=dtype, base_cuboid=CUBOID, **kw)


def volume(seed=0, shape=SHAPE, dtype=np.uint8, lo=1, hi=255):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(dtype)


def seeded_boxes(n, seed=5, shape=SHAPE):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lo = [int(rng.integers(0, s - 1)) for s in shape]
        hi = [int(rng.integers(l + 1, s + 1)) for l, s in zip(lo, shape)]
        out.append((lo, hi))
    return out


def ref_items(vol, kw, channel=0):
    """The compressed cuboids of ``vol`` as the reference stores them."""
    ref = jstore.CuboidStore(JSpec(**kw))
    jcut.ingest(ref, 0, vol, channel=channel)
    return carry.backend_items(ref.read_backend)


def pair_over(items, kw, policy="workers1", cache_bytes=0):
    """The reference store and the port's device store over its own host
    store, each over a `MemoryBackend` holding ``items``."""
    pol = POLICIES[policy]
    ref = jstore.CuboidStore(JSpec(**kw), backend=carry.backend_from_items(
        items, jstore.MemoryBackend()), decode_policy=jstore.DecodePolicy(**pol))
    host = CuboidStore(DatasetSpec(**kw), backend=carry.backend_from_items(items),
                       decode_policy=DecodePolicy(**pol))
    if cache_bytes:
        jcache.attach_cache(ref, cache_bytes)
        attach_cache(host, cache_bytes)
    return ref, DeviceCuboidStore(host.spec, device="cpu", backing=host)


def same_stats(a, b):
    assert (a.cuboids_read, a.runs, a.bytes_assembled, a.bytes_discarded, a.zero_copy) == \
        (b.cuboids_read, b.runs, b.bytes_assembled, b.bytes_discarded, b.zero_copy)


@pytest.mark.parametrize("policy,cached", [
    ("workers1", False), ("workers4", False), ("workers1", True), ("workers4", True),
    ("pipelined4", True)])  # lookahead lands in a cache, as the reference's
def test_cold_reads_match_reference(policy, cached):
    """Cold, then warm: every box equals the reference's cutout, with the
    same `CutoutStats`; the first (all-cold) read takes the reference's
    path through the tiers: the same lookups, runs and decodes."""
    kw = spec_kw()
    ref, dev = pair_over(ref_items(volume(1), kw), kw, policy, 64 << 20 if cached else 0)
    for i, (lo, hi) in enumerate(seeded_boxes(8)):
        for _ in range(2):
            js, ts = jcut.CutoutStats(), tcut.CutoutStats()
            want = jcut.cutout(ref, 0, lo, hi, stats=js)
            got = tcut.cutout(dev, 0, lo, hi, stats=ts)
            np.testing.assert_array_equal(got.numpy(), want)
            same_stats(ts, js)
            if i == 0 and _ == 0:
                a, b = dev.backing.read_stats, ref.read_stats
                assert (a.reads, a.seeks, a.decoded_blocks, a.cache_hits + a.cache_misses) \
                    == (b.reads, b.seeks, b.decoded_blocks, b.cache_hits + b.cache_misses)
    rs = dev.backing.read_stats
    assert rs.decoded_blocks == dev.load_stats.cuboids  # each cuboid decoded once
    if cached:
        assert rs.reads + dev.backing.write_stats.reads == rs.cache_hits + rs.cache_misses


@pytest.mark.parametrize("max_runs", [None, 1, 2, 5])
def test_max_runs_changes_only_what_is_loaded(max_runs):
    kw = spec_kw()
    vol = volume(2)
    ref, dev = pair_over(ref_items(vol, kw), kw)
    grid = dev.spec.grid(0)
    loaded = 0
    for lo, hi in seeded_boxes(6, seed=8):
        js, ts = jcut.CutoutStats(), tcut.CutoutStats()
        got = tcut.cutout(dev, 0, lo, hi, stats=ts, max_runs=max_runs)
        np.testing.assert_array_equal(got.numpy(), jcut.cutout(ref, 0, lo, hi, stats=js,
                                                               max_runs=max_runs))
        np.testing.assert_array_equal(
            got.numpy(), vol[tuple(slice(l, h) for l, h in zip(lo, hi))])
        same_stats(ts, js)
        loaded = max(loaded, len(morton.runs_to_indices(grid.box_to_runs(lo, hi, max_runs))))
    assert dev.resident_count(0) >= loaded
    if max_runs == 1:  # one run from the first cell to the last: more loads
        exact = DeviceCuboidStore(dev.spec, device="cpu", backing=dev.backing)
        for lo, hi in seeded_boxes(6, seed=8):
            tcut.cutout(exact, 0, lo, hi)
        assert exact.resident_count(0) < dev.resident_count(0)


def test_unbacked_cutout_counts_as_the_reference():
    kw = spec_kw()
    vol = volume(3)
    ref = jstore.CuboidStore(JSpec(**kw))
    jcut.ingest(ref, 0, vol)
    dev = carry.store_from_numpy(DatasetSpec(**kw), {0: vol}, device="cpu")
    for lo, hi in seeded_boxes(6, seed=3) + [((8, 8, 4), (24, 24, 12)), ((0, 0, 0), SHAPE)]:
        js, ts = jcut.CutoutStats(), tcut.CutoutStats()
        np.testing.assert_array_equal(tcut.cutout(dev, 0, lo, hi, stats=ts).numpy(),
                                      jcut.cutout(ref, 0, lo, hi, stats=js))
        same_stats(ts, js)
    assert ts.zero_copy == 1


def test_lazy_cuboids_read_as_zeros_and_count_as_resident():
    kw = spec_kw()
    items = ref_items(volume(4), kw)
    kept = items[::3]  # the backend lacks two thirds of the cuboids
    ref, dev = pair_over(kept, kw)
    np.testing.assert_array_equal(tcut.cutout(dev, 0, (0, 0, 0), SHAPE).numpy(),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    grid = dev.spec.grid(0)
    assert dev.resident_count(0) == grid.n_cells
    assert dev.load_stats.cuboids == grid.n_cells
    tcut.cutout(dev, 0, (0, 0, 0), SHAPE)
    assert dev.load_stats.cuboids == grid.n_cells  # warm: no second load


@pytest.mark.parametrize("dtype,channels", [("uint16", 2), ("uint32", 1), ("float32", 1)])
def test_cold_reads_of_wide_and_multichannel_data(dtype, channels):
    """uint16 (through a signed view) and uint32 ids past 2^31 (int32 bits)
    come off the tiers bit for bit, per channel."""
    kw = spec_kw(dtype=dtype, n_channels=channels)
    items = []
    vols = []
    for c in range(channels):
        if dtype == "uint32":
            vol = volume(c, dtype=np.uint32, lo=0, hi=5) * np.uint32(BIG // 4)
        elif dtype == "float32":
            vol = np.random.default_rng(c).standard_normal(SHAPE).astype(np.float32)
        else:
            vol = volume(c, dtype=np.uint16, lo=0, hi=65535)
        vols.append(vol)
        items += ref_items(vol, kw, channel=c)
    ref, dev = pair_over(items, kw, "workers4")
    for c in range(channels):
        for lo, hi in seeded_boxes(4, seed=c):
            got = tcut.cutout(dev, 0, lo, hi, channel=c)
            np.testing.assert_array_equal(host_view(got, dtype),
                                          jcut.cutout(ref, 0, lo, hi, channel=c))


def test_rank4_cold_reads_match_reference():
    shape = (16, 16, 8, 6)
    kw = dict(name="ts", volume_shape=shape, dtype="uint8", base_cuboid=(8, 8, 4, 4))
    vol = volume(5, shape=shape)
    ref, dev = pair_over(ref_items(vol, kw), kw, "workers4")
    for lo, hi in seeded_boxes(5, seed=6, shape=shape):
        js, ts = jcut.CutoutStats(), tcut.CutoutStats()
        np.testing.assert_array_equal(tcut.cutout(dev, 0, lo, hi, stats=ts).numpy(),
                                      jcut.cutout(ref, 0, lo, hi, stats=js))
        same_stats(ts, js)


class SlowBackend(MemoryBackend):
    """A backend whose batch reads take a while (and can fail once)."""

    def __init__(self, delay=0.1, fail_once=False):
        super().__init__()
        self.delay, self.fail_once, self.calls = delay, fail_once, 0

    def get_many(self, keys):
        self.calls += 1
        time.sleep(self.delay)
        if self.fail_once:
            self.fail_once = False
            raise IOError("disk hiccup")
        return super().get_many(keys)


def test_concurrent_readers_load_each_cuboid_once():
    kw = spec_kw()
    vol = volume(6)
    backend = carry.backend_from_items(ref_items(vol, kw), SlowBackend())
    host = CuboidStore(DatasetSpec(**kw), backend=backend,
                       decode_policy=DecodePolicy(**POLICIES["workers4"]))
    dev = DeviceCuboidStore(host.spec, device="cpu", backing=host)
    boxes = [((0, 0, 0), (24, 24, 12)), ((4, 4, 2), (32, 32, 16)), ((0, 0, 0), SHAPE)]
    start = threading.Barrier(6)
    errors = []

    def reader(i):
        try:
            start.wait(timeout=30)
            lo, hi = boxes[i % len(boxes)]
            got = tcut.cutout(dev, 0, lo, hi).numpy()
            np.testing.assert_array_equal(got, vol[tuple(slice(l, h) for l, h in zip(lo, hi))])
        except Exception as e:  # surfaced on the main thread
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    n = dev.spec.grid(0).n_cells
    assert dev.load_stats.cuboids == n == dev.resident_count(0)
    assert host.read_stats.decoded_blocks == n  # nothing decoded twice
    assert dev.load_stats.waits >= 1
    assert not dev._loading


def test_failed_load_releases_its_claim():
    kw = spec_kw()
    vol = volume(7)
    backend = carry.backend_from_items(ref_items(vol, kw), SlowBackend(0.0, fail_once=True))
    host = CuboidStore(DatasetSpec(**kw), backend=backend,
                       decode_policy=DecodePolicy(**POLICIES["workers1"]))
    dev = DeviceCuboidStore(host.spec, device="cpu", backing=host)
    with pytest.raises(IOError, match="hiccup"):
        tcut.cutout(dev, 0, (0, 0, 0), (16, 16, 8))
    assert not dev._loading and dev.resident_count(0) == 0
    np.testing.assert_array_equal(tcut.cutout(dev, 0, (0, 0, 0), (16, 16, 8)).numpy(),
                                  vol[:16, :16, :8])


# ------------------------------------------------------ write-through --


def _write_sequence(seed, kw, labels):
    """(lo, data, discipline) writes at level 0: overlapping, unaligned,
    some all zero, in every discipline."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(kw["dtype"])
    out = []
    for i, (lo, hi) in enumerate(seeded_boxes(10, seed=seed, shape=kw["volume_shape"])):
        shape = [h - l for l, h in zip(lo, hi)]
        data = rng.integers(0, 4, size=shape).astype(dtype)
        if labels:
            data = data * dtype.type(BIG // 3)
        if i % 5 == 4:
            data[:] = 0
        out.append((lo, data, ("overwrite", "preserve", "exception")[i % 3]))
    return out


def assert_same_contents(jhost, thost):
    """Equal keys and equal decompressed cuboids, level by level."""
    jkeys, tkeys = jhost.stored_keys(), thost.stored_keys()
    assert tkeys == jkeys
    for r, c, m in jkeys:
        shape = jhost.spec.grid(r).cuboid_shape
        dtype = np.dtype(jhost.spec.dtype)
        np.testing.assert_array_equal(thost.read_cuboid(r, m, c), jhost.read_cuboid(r, m, c))
        blob = thost.write_backend.get((r, c, m)) if thost.write_backend is not None \
            and (r, c, m) in thost.write_backend else thost.read_backend.get((r, c, m))
        assert decompress(blob, shape, dtype).shape == tuple(shape)


TIERS = {  # (store module, wal module, directory) -> CuboidStore backends
    "memory": lambda st, wl, tmp: dict(backend=st.MemoryBackend()),
    "two_paths": lambda st, wl, tmp: dict(backend=st.MemoryBackend(),
                                          write_path_backend=st.MemoryBackend()),
    "log": lambda st, wl, tmp: dict(backend=st.DirectoryBackend(str(tmp / "read")),
                                    write_path_backend=wl.LogBackend(str(tmp / "wal"))),
}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32"])
def test_write_through_leaves_the_reference_contents(tmp_path, tier, dtype):
    """The same writes (every discipline, conflicts reported alike),
    ingest and hierarchy build leave the same keys, cuboids and write
    counts on the host tiers; a second device store over the backing, and
    a reopened log, read what the first wrote."""
    labels = dtype == "uint32"
    kw = spec_kw(dtype=dtype, n_resolutions=2)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jhost = jstore.CuboidStore(JSpec(**kw), **TIERS[tier](jstore, jwal, tmp_path / "j"))
    thost = CuboidStore(DatasetSpec(**kw), **TIERS[tier](tstore, twal, tmp_path / "t"))
    dev = DeviceCuboidStore(thost.spec, device="cpu", backing=thost)
    jconf, tconf = [], []
    base = volume(8, dtype=np.dtype(dtype), lo=0, hi=3)
    jcut.ingest(jhost, 0, base, offset=(0, 0, 0))
    tcut.ingest(dev, 0, base)
    for lo, data, disc in _write_sequence(9, kw, labels):
        jcut.write_cutout(jhost, 0, lo, data, discipline=disc,
                          on_conflict=lambda *a: jconf.append(a))
        tcut.write_cutout(dev, 0, lo, data, discipline=disc,
                          on_conflict=lambda *a: tconf.append(a))
    jcut.build_hierarchy(jhost, labels=labels)
    tcut.build_hierarchy(dev, labels=labels)
    assert len(tconf) == len(jconf) > 0
    for (tm, to, told, tnew), (jm, jo, jold, jnew) in zip(tconf, jconf):
        assert (tm, tuple(to)) == (jm, tuple(jo))
        np.testing.assert_array_equal(told, jold)
        np.testing.assert_array_equal(tnew, jnew)
    assert thost.write_stats.writes == jhost.write_stats.writes
    assert_same_contents(jhost, thost)
    for r in range(2):
        shape = jhost.spec.grid(r).volume_shape
        fresh = DeviceCuboidStore(thost.spec, device="cpu", backing=thost)
        np.testing.assert_array_equal(host_view(tcut.cutout(fresh, r, (0,) * 3, shape), dtype),
                                      jcut.cutout(jhost, r, (0,) * 3, shape))
    if tier == "log":
        again = CuboidStore(thost.spec, **TIERS[tier](tstore, twal, tmp_path / "t"))
        assert again.stored_keys() == jhost.stored_keys()


def test_write_through_with_cache_and_write_behind():
    """With a cache and a write-behind queue on the backing, the write is
    readable at once through the backing, and the flushed backend holds
    the reference's contents."""
    kw = spec_kw()
    jhost = jstore.CuboidStore(JSpec(**kw))
    thost = CuboidStore(DatasetSpec(**kw))
    attach_cache(thost, 1 << 20)
    queue = enable_write_behind(thost, max_items=16, batch_items=4)
    dev = DeviceCuboidStore(thost.spec, device="cpu", backing=thost)
    try:
        for lo, data, disc in _write_sequence(11, kw, labels=False):
            jcut.write_cutout(jhost, 0, lo, data, discipline=disc)
            tcut.write_cutout(dev, 0, lo, data, discipline=disc)
            for m in range(dev.spec.grid(0).n_cells):
                np.testing.assert_array_equal(thost.read_cuboid(0, m), jhost.read_cuboid(0, m))
        thost.flush()
        assert queue.depth == 0
        assert thost.write_stats.writes == jhost.write_stats.writes
        assert_same_contents(jhost, thost)
    finally:
        thost.close()


def test_write_returns_only_after_the_write_path_holds_it():
    """A backend that records each put_many: by the time write_cutout
    returns, every cuboid of the box is on the write path."""
    kw = spec_kw()
    landed = []

    class Recording(MemoryBackend):
        def put_many(self, items):
            landed.extend(k for k, _ in items)
            super().put_many(items)

    thost = CuboidStore(DatasetSpec(**kw), backend=MemoryBackend(),
                        write_path_backend=Recording())
    dev = DeviceCuboidStore(thost.spec, device="cpu", backing=thost)
    grid = dev.spec.grid(0)
    lo, hi = (3, 5, 1), (21, 17, 11)
    tcut.write_cutout(dev, 0, lo, volume(12, shape=(18, 12, 10)))
    want = {(0, 0, int(m)) for m in build_plan(grid, lo, hi)[1]}
    assert set(landed) == want
    assert not list(thost.read_backend.keys())  # the write path absorbed it
