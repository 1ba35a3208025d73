"""Port parity: the host storage tiers under the device store.

The single-node cases of tests/test_tiers.py on the port's `LogBackend`,
`DirectoryBackend`, `MemoryBackend`, tiered `CuboidStore`, compaction and
write-behind queue, held against the reference `CuboidStore` as the
oracle; the on-disk formats opened across the packages both ways; and the
device store over a tiered store, whose acknowledged writes survive a
reopen.  The port's witness is on for every test (`torch_witness`).
"""
import os
import threading
import time

import numpy as np
import pytest
from torch_witness import port_witness  # noqa: F401

from repro.core import cutout as jcut
from repro.core import store as jstore
from repro.core import wal as jwal
from repro.core.cuboid import DatasetSpec as JSpec
from repro_torch import carry
from repro_torch.cluster.cache import enable_write_behind
from repro_torch.core import cutout as tcut
from repro_torch.core import wal as twal
from repro_torch.core.compact import Compactor, compact_store
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import (CuboidStore, DeviceCuboidStore, DirectoryBackend,
                                    MemoryBackend, decompress, set_crash_hook)
from repro_torch.core.wal import HEADER_BYTES, LogBackend, TierPolicy, tiered_store

SHAPE = (32, 32, 16)
CUBOID = (8, 8, 4)
N_CELLS = 64  # 4 x 4 x 4 grid


def spec(**kw):
    return DatasetSpec(name="rb", volume_shape=SHAPE, dtype="uint8",
                       base_cuboid=CUBOID, **kw)


def jspec(**kw):
    return JSpec(name="rb", volume_shape=SHAPE, dtype="uint8",
                 base_cuboid=CUBOID, **kw)


def volume(seed=0):
    return np.random.default_rng(seed).integers(1, 255, size=SHAPE, dtype=np.uint8)


def rand_box(rng):
    lo = [int(rng.integers(0, s - 1)) for s in SHAPE]
    hi = [int(rng.integers(l + 1, s + 1)) for l, s in zip(lo, SHAPE)]
    return lo, hi


class SimulatedCrash(BaseException):
    """Raised by the crash hook; BaseException so nothing swallows it."""


@pytest.fixture
def crash_at():
    """Install a hook that raises at one named crash point."""
    def arm(point, after=0):
        state = {"n": 0}

        def hook(name):
            if name == point:
                state["n"] += 1
                if state["n"] > after:
                    raise SimulatedCrash(point)

        set_crash_hook(hook)
        return state

    yield arm
    set_crash_hook(None)


def log_policy(**kw):
    kw.setdefault("write_tier", "log")
    kw.setdefault("fsync", False)  # the fsync *ordering* tests force it on
    return TierPolicy(**kw)


def tiered(root=None, **store_kw):
    return tiered_store(spec(), root=root, policy=log_policy(), **store_kw)


def device(backing):
    return DeviceCuboidStore(backing.spec, device="cpu", backing=backing)


def read_all(dstore):
    return tcut.cutout(dstore, 0, (0, 0, 0), SHAPE).numpy()


# ------------------------------------------------------- LogBackend unit --


def test_log_backend_roundtrip_and_tombstones(tmp_path):
    log = LogBackend(str(tmp_path), fsync=False)
    log.put((0, 0, 1), b"aa")
    log.put_many([((0, 0, 2), b"bb"), ((1, 0, 3), b"cc")])
    assert log.get((0, 0, 1)) == b"aa"
    assert log.get_many([(0, 0, 2), (1, 0, 3), (9, 9, 9)]) == [b"bb", b"cc", None]
    assert (0, 0, 2) in log and (9, 9, 9) not in log
    log.delete((0, 0, 2))
    assert sorted(log.keys()) == [(0, 0, 1), (1, 0, 3)]
    assert log.tombstone_keys() == {(0, 0, 2)}
    assert log.probe((0, 0, 2)) == (True, None)
    assert log.probe((5, 5, 5)) == (False, None)
    assert log.probe_many([(0, 0, 1), (0, 0, 2), (5, 5, 5)]) == [
        (True, b"aa"), (True, None), (False, None)]
    s = log.stats()
    assert s["live_keys"] == 2 and s["tombstones"] == 1
    assert s["appends"] == 4 and s["torn_truncated"] == 0


def test_log_backend_rotation_and_seal(tmp_path):
    log = LogBackend(str(tmp_path), segment_bytes=128, fsync=False)
    for m in range(6):
        log.put((0, 0, m), bytes(64))
    assert log.stats()["segments"] >= 3
    sealed = log.sealed_segments()
    assert sealed == sorted(sealed) and len(sealed) >= 2
    log.seal_active()
    assert log.stats()["active_bytes"] == 0
    for m in range(6):
        assert log.get((0, 0, m)) == bytes(64)


def _log_ops(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        key = (0, 0, int(rng.integers(0, 10)))
        if rng.random() < 0.25:
            ops.append((key, None))
        else:
            ops.append((key, bytes(rng.integers(0, 256, size=rng.integers(1, 50),
                                                dtype=np.uint8))))
    return ops


def test_log_backend_reopen_rebuilds_index(tmp_path):
    log = LogBackend(str(tmp_path), segment_bytes=256, fsync=False)
    want = {}
    for key, blob in _log_ops(0):
        log.put(key, blob) if blob is not None else log.delete(key)
        want[key] = blob
    log.close()
    for _ in range(2):  # replay is idempotent
        reopened = LogBackend(str(tmp_path), segment_bytes=256, fsync=False)
        for key, blob in want.items():
            assert reopened.get(key) == blob
            assert reopened.probe(key) == (True, blob)
        assert reopened.torn_truncated == 0
        reopened.close()


@pytest.mark.parametrize("cut", ["header", "payload", "crc"])
def test_log_backend_truncates_torn_tail(tmp_path, cut):
    log = LogBackend(str(tmp_path), fsync=False)
    log.put((0, 0, 1), b"x" * 20)
    log.put((0, 0, 2), b"y" * 20)
    path = log._segment_path(log._active)
    size = os.path.getsize(path)
    log.close()
    chop = {"header": 20 + HEADER_BYTES - 4, "payload": 8, "crc": 20}[cut]
    with open(path, "r+b") as f:
        f.truncate(size - chop)
    reopened = LogBackend(str(tmp_path), fsync=False)
    assert reopened.torn_truncated == 1
    assert reopened.get((0, 0, 1)) == b"x" * 20
    assert reopened.probe((0, 0, 2)) == (False, None)
    reopened.put((0, 0, 3), b"z")
    reopened.close()
    again = LogBackend(str(tmp_path), fsync=False)
    assert again.torn_truncated == 0
    assert again.get((0, 0, 3)) == b"z"


def test_log_backend_rejects_corrupt_crc(tmp_path):
    log = LogBackend(str(tmp_path), fsync=False)
    log.put((0, 0, 1), b"a" * 30)
    path = log._segment_path(log._active)
    log.close()
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 1)
        f.write(b"\xff")
    reopened = LogBackend(str(tmp_path), fsync=False)
    assert reopened.torn_truncated == 1
    assert reopened.probe((0, 0, 1)) == (False, None)


def test_log_backend_crash_before_sync_is_not_indexed(tmp_path, crash_at):
    log = LogBackend(str(tmp_path), fsync=False)
    log.put((0, 0, 1), b"ok")
    crash_at("wal.append.written")
    with pytest.raises(SimulatedCrash):
        log.put((0, 0, 2), b"lost")
    assert log.probe((0, 0, 2)) == (False, None)
    assert log.get((0, 0, 1)) == b"ok"
    set_crash_hook(None)
    reopened = LogBackend(str(tmp_path), fsync=False)
    assert reopened.get((0, 0, 1)) == b"ok"
    assert reopened.probe((0, 0, 2)) in ((False, None), (True, b"lost"))


# ------------------------------------------- DirectoryBackend durability --


def test_directory_backend_fsync_ordering(tmp_path, monkeypatch):
    calls = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (calls.append("replace"), real_replace(a, b))[1])
    be = DirectoryBackend(str(tmp_path), fsync=True)
    be.put((0, 0, 0), b"warm")  # pay the one-time mkdir-chain syncs
    calls.clear()
    be.put((0, 0, 1), b"blob")
    assert calls == ["fsync", "replace", "fsync"]
    calls.clear()
    DirectoryBackend(str(tmp_path / "nosync")).put((0, 0, 1), b"blob")
    assert "fsync" not in calls


@pytest.mark.parametrize("point", ["dir.put.written", "dir.put.synced"])
def test_directory_backend_crash_before_rename(tmp_path, crash_at, point):
    be = DirectoryBackend(str(tmp_path), fsync=True)
    be.put((0, 0, 1), b"old")
    crash_at(point)
    with pytest.raises(SimulatedCrash):
        be.put((0, 0, 1), b"new")
    set_crash_hook(None)
    assert be.get((0, 0, 1)) == b"old"
    reopened = DirectoryBackend(str(tmp_path), fsync=True)
    assert reopened.swept_tmp == 1
    assert reopened.get((0, 0, 1)) == b"old"
    assert not [f for f in os.listdir(tmp_path / "0" / "0") if f.endswith(".tmp")]


def test_directory_backend_crash_after_rename_keeps_new_value(tmp_path, crash_at):
    be = DirectoryBackend(str(tmp_path), fsync=True)
    be.put((0, 0, 1), b"old")
    crash_at("dir.put.renamed")
    with pytest.raises(SimulatedCrash):
        be.put((0, 0, 1), b"new")
    set_crash_hook(None)
    reopened = DirectoryBackend(str(tmp_path), fsync=True)
    assert reopened.get((0, 0, 1)) == b"new"
    assert reopened.swept_tmp == 0


def test_tmp_sweep_counts_into_path_stats(tmp_path):
    root = tmp_path / "data"
    be = DirectoryBackend(str(root))
    be.put((0, 0, 1), b"keep")
    (root / "0" / "0" / "00000000000000ff.bin.tmp").write_bytes(b"torn")
    (root / "0" / "junk.tmp").write_bytes(b"torn")
    store = CuboidStore(spec(), backend=DirectoryBackend(str(root)))
    assert store.read_stats.tmp_swept == 2
    assert store.read_backend.get((0, 0, 1)) == b"keep"
    assert list(store.read_backend.keys()) == [(0, 0, 1)]


def test_fsync_defaults_are_the_reference_defaults(tmp_path):
    """The knobs became arguments with the reference's defaults: off for a
    directory tier, on for the log (the ack boundary) and a tier policy's
    write tier; the compression level is the spec's; decode workers are
    the core count with one segment of lookahead."""
    assert DirectoryBackend(str(tmp_path / "a")).fsync is False
    assert LogBackend(str(tmp_path / "b")).fsync is True
    read, write = TierPolicy(write_tier="log").build(str(tmp_path / "c"))
    assert read.fsync is False and write.fsync is True
    assert TierPolicy().write_tier == "dir"
    store = CuboidStore(spec(compress_level=6))
    assert store.compression_level == 6
    assert store.decode_policy.workers == (os.cpu_count() or 1)
    assert store.decode_policy.prefetch_segments == 1


def test_memory_backend_keys_vs_put_many_race():
    be = MemoryBackend()
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            be.put_many([((0, 0, i + j), b"x") for j in range(16)])
            i += 16

    def scanner():
        try:
            while not stop.is_set():
                be.keys()
                be.get_many([(0, 0, 0), (0, 0, 1)])
                (0, 0, 2) in be
        except RuntimeError as e:  # pragma: no cover - the failure it guards
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)]
    threads += [threading.Thread(target=scanner) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors


# ---------------------------------------------- the on-disk format, both ways --


def _write_log(mod, root, seed):
    log = mod.LogBackend(str(root), segment_bytes=256, fsync=False)
    for key, blob in _log_ops(seed):
        log.put(key, blob) if blob is not None else log.delete(key)
    log.put_many([((1, 2, 7), b"seven"), ((0, 1, 3), b"three")])
    log.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_log_segments_open_in_the_other_package(tmp_path, writer):
    """A log directory written by either package opens in the other with
    equal keys, values, tombstones and segment gauges."""
    mods = {"reference": jwal, "port": twal}
    _write_log(mods[writer], tmp_path, seed=4)
    other = mods["port" if writer == "reference" else "reference"]
    a = mods[writer].LogBackend(str(tmp_path), segment_bytes=256, fsync=False)
    b = other.LogBackend(str(tmp_path), segment_bytes=256, fsync=False)
    assert sorted(a.keys()) == sorted(b.keys())
    assert a.tombstone_keys() == b.tombstone_keys()
    for k in a.keys():
        assert a.get(k) == b.get(k)
    assert a.stats() == b.stats()
    a.close()
    b.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_tier_opens_in_the_other_package(tmp_path, writer):
    items = [((r, c, m), bytes([r, c, m % 256]) * (m + 1))
             for r in range(2) for c in range(2) for m in (0, 5, 300)]
    be = {"reference": jstore.DirectoryBackend, "port": DirectoryBackend}
    be[writer](str(tmp_path)).put_many(items)
    other = be["port" if writer == "reference" else "reference"](str(tmp_path))
    assert carry.backend_items(other) == sorted(items)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tiered_store_reopens_in_the_other_package(tmp_path, writer):
    """Writes through either package's stack (the port's from the device
    store, acknowledged on return), partly compacted, reopen in the
    other's tiered store with the same keys and cutouts."""
    rng = np.random.default_rng(9)
    boxes = [rand_box(rng) for _ in range(6)]
    if writer == "reference":
        w = jwal.tiered_store(jspec(), root=str(tmp_path),
                              policy=jwal.TierPolicy(write_tier="log", fsync=False))
        jcut.write_cutout(w, 0, (0, 0, 0), volume(2))
        w.compact()
        for i, (lo, hi) in enumerate(boxes):
            jcut.write_cutout(w, 0, lo, np.zeros([h - l for l, h in zip(lo, hi)], np.uint8)
                              if i % 3 == 2 else volume(i)[:hi[0] - lo[0], :hi[1] - lo[1],
                                                               :hi[2] - lo[2]])
    else:
        w = tiered(str(tmp_path))
        d = device(w)
        tcut.write_cutout(d, 0, (0, 0, 0), volume(2))
        w.compact()
        for i, (lo, hi) in enumerate(boxes):
            tcut.write_cutout(d, 0, lo, np.zeros([h - l for l, h in zip(lo, hi)], np.uint8)
                              if i % 3 == 2 else volume(i)[:hi[0] - lo[0], :hi[1] - lo[1],
                                                               :hi[2] - lo[2]])
    keys = w.stored_keys()
    want = (jcut.cutout(w, 0, (0, 0, 0), SHAPE) if writer == "reference"
            else read_all(device(w)))
    w.close()
    if writer == "reference":
        back = tiered(str(tmp_path))
        got = read_all(device(back))
    else:
        back = jwal.tiered_store(jspec(), root=str(tmp_path),
                                 policy=jwal.TierPolicy(write_tier="log", fsync=False))
        got = jcut.cutout(back, 0, (0, 0, 0), SHAPE)
    assert back.stored_keys() == keys
    np.testing.assert_array_equal(got, want)
    back.close()


# ------------------------------------------------ tiered store vs oracle --


def host_walk(ref, sub, seed, n_ops=120, compact_every=25):
    """Host-level ops on the port's tiered store and the reference oracle;
    whole-volume reads assembled by the reference's planned cutout over
    each (`fetch_blocks` is one interface)."""
    rng = np.random.default_rng(seed)
    for i in range(n_ops):
        m = int(rng.integers(0, N_CELLS))
        roll = rng.random()
        if roll < 0.45:
            data = rng.integers(0, 5, size=CUBOID).astype(np.uint8)
            if rng.random() < 0.3:
                data[:] = 0  # lazy-zero delete -> log tombstone
            ref.write_cuboid(0, m, data)
            sub.write_cuboid(0, m, data)
        elif roll < 0.85:
            np.testing.assert_array_equal(sub.read_cuboid(0, m), ref.read_cuboid(0, m))
        else:
            lo, hi = rand_box(rng)
            np.testing.assert_array_equal(jcut.cutout(sub, 0, lo, hi),
                                          jcut.cutout(ref, 0, lo, hi))
        if i % compact_every == compact_every - 1:
            sub.compact()
    sub.flush()
    assert sub.stored_keys() == ref.stored_keys()
    np.testing.assert_array_equal(jcut.cutout(sub, 0, (0, 0, 0), SHAPE),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_store_matches_oracle(seed):
    ref, sub = jstore.CuboidStore(jspec()), tiered()
    try:
        jcut.write_cutout(ref, 0, (0, 0, 0), volume(seed))
        tcut.write_cutout(device(sub), 0, (0, 0, 0), volume(seed))
        host_walk(ref, sub, seed)
    finally:
        sub.close()


def test_tiered_store_with_write_behind_matches_oracle():
    ref, sub = jstore.CuboidStore(jspec()), tiered()
    enable_write_behind(sub, max_items=64, batch_items=16)
    try:
        host_walk(ref, sub, seed=7)
    finally:
        sub.close()


def device_walk(ref, dstore, seed, n_ops=40, compact_every=10):
    """Writes and cutouts through the device store over a tiered backing,
    against the same calls on the reference oracle."""
    rng = np.random.default_rng(seed)
    sub = dstore.backing
    for i in range(n_ops):
        lo, hi = rand_box(rng)
        if rng.random() < 0.5:
            data = rng.integers(0, 3, size=[h - l for l, h in zip(lo, hi)]).astype(np.uint8)
            disc = ("overwrite", "preserve")[int(rng.integers(0, 2))]
            jcut.write_cutout(ref, 0, lo, data, discipline=disc)
            tcut.write_cutout(dstore, 0, lo, data, discipline=disc)
        else:
            np.testing.assert_array_equal(tcut.cutout(dstore, 0, lo, hi).numpy(),
                                          jcut.cutout(ref, 0, lo, hi))
        if i % compact_every == compact_every - 1:
            sub.compact()
    sub.flush()
    assert sub.stored_keys() == ref.stored_keys()
    assert sub.write_stats.writes == ref.write_stats.writes


@pytest.mark.parametrize("write_behind", [False, True])
def test_device_store_over_tiers_matches_oracle(write_behind):
    ref, sub = jstore.CuboidStore(jspec()), tiered()
    if write_behind:
        enable_write_behind(sub, max_items=64, batch_items=16)
    try:
        dstore = device(sub)
        device_walk(ref, dstore, seed=5)
        np.testing.assert_array_equal(read_all(device(sub)),
                                      jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    finally:
        sub.close()


def test_acked_writes_survive_reopen(tmp_path):
    """Everything written through the device store is on the log when the
    write returns: a brand-new stack over the same root, with no flush
    and no close in between, reads every write."""
    root = str(tmp_path)
    ref = jstore.CuboidStore(jspec())
    sub = tiered(root)
    dstore = device(sub)
    jcut.write_cutout(ref, 0, (0, 0, 0), volume(3))
    tcut.write_cutout(dstore, 0, (0, 0, 0), volume(3))
    sub.compact(max_segments=1)  # partly compacted: both tiers populated
    device_walk(ref, dstore, seed=3, n_ops=20, compact_every=7)
    reborn = tiered(root)  # the first stack is left open, unflushed
    assert reborn.stored_keys() == ref.stored_keys()
    np.testing.assert_array_equal(read_all(device(reborn)),
                                  jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    reborn.close()
    sub.close()


def test_migrate_on_log_tier_applies_tombstones():
    sub = tiered()
    sub.write_cuboid(0, 1, np.ones(CUBOID, dtype=np.uint8))
    sub.compact()
    sub.write_cuboid(0, 1, np.zeros(CUBOID, dtype=np.uint8))  # tombstone
    sub.migrate()
    assert not sub.has_cuboid(0, 1)
    assert (0, 0, 1) not in sub.read_backend
    assert sub.write_backend.stats()["tombstones"] == 0
    sub.close()


def test_background_compactor_converges():
    sub = tiered()
    comp = Compactor(sub, interval=0.01, min_sealed=1)
    ref = jstore.CuboidStore(jspec())
    with comp:
        rng = np.random.default_rng(11)
        for _ in range(60):
            m = int(rng.integers(0, N_CELLS))
            data = rng.integers(0, 5, size=CUBOID).astype(np.uint8)
            ref.write_cuboid(0, m, data)
            sub.write_cuboid(0, m, data)
            sub.write_backend.seal_active()
            comp.poke()
        np.testing.assert_array_equal(read_all(device(sub)),
                                      jcut.cutout(ref, 0, (0, 0, 0), SHAPE))
    sub.compact()
    s = sub.write_backend.stats()
    assert s["live_keys"] == 0 and s["sealed"] == 0
    assert sub.stored_keys() == ref.stored_keys()
    assert sub.compactions["runs"] >= 1
    sub.close()


def test_reads_bit_identical_during_compaction():
    """A thread compacts while the device store reads (cold, then warm
    boxes) and the host store reads cuboids: every read equals the
    oracle, and the log ends empty."""
    ref, sub = jstore.CuboidStore(jspec()), tiered()
    dstore = device(sub)
    rng = np.random.default_rng(21)
    for i in range(12):
        lo, hi = rand_box(rng)
        data = volume(i)[:hi[0] - lo[0], :hi[1] - lo[1], :hi[2] - lo[2]]
        jcut.write_cutout(ref, 0, lo, data)
        tcut.write_cutout(dstore, 0, lo, data)
    want = jcut.cutout(ref, 0, (0, 0, 0), SHAPE)
    errors = []

    def compact_loop():
        try:
            for _ in range(3):
                compact_store(sub, batch_keys=4)
        except Exception as e:  # surfaced on the main thread
            errors.append(e)

    t = threading.Thread(target=compact_loop)
    t.start()
    fresh = device(sub)
    for _ in range(20):
        lo, hi = rand_box(rng)
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        np.testing.assert_array_equal(tcut.cutout(fresh, 0, lo, hi).numpy(), want[sl])
        m = int(rng.integers(0, N_CELLS))
        np.testing.assert_array_equal(sub.read_cuboid(0, m), ref.read_cuboid(0, m))
    t.join(timeout=60)
    assert not t.is_alive() and not errors
    sub.compact()
    assert sub.write_backend.stats()["live_keys"] == 0
    np.testing.assert_array_equal(read_all(device(sub)), want)
    sub.close()


# ----------------------------------------------------- crash recovery --


def test_crash_mid_flush_parks_queue_and_recovers(tmp_path, crash_at):
    root = str(tmp_path)
    sub = tiered(root)
    queue = enable_write_behind(sub, max_items=64, batch_items=8)
    data = np.full(CUBOID, 7, dtype=np.uint8)
    sub.write_cuboid(0, 1, data)
    sub.flush()
    crash_at("wal.append.written")
    sub.write_cuboid(0, 2, data)
    with pytest.raises(RuntimeError):
        sub.flush()
    set_crash_hook(None)
    assert queue.depth >= 1
    reborn = tiered(root)
    np.testing.assert_array_equal(reborn.read_cuboid(0, 1), data)
    got = reborn.read_cuboid(0, 2)
    assert (got == data).all() or not got.any()
    reborn.close()


def test_crash_mid_compaction_recovers_bit_identical(tmp_path, crash_at):
    root = str(tmp_path)
    ref = jstore.CuboidStore(jspec())
    sub = tiered(root)
    jcut.write_cutout(ref, 0, (0, 0, 0), volume(5))
    tcut.write_cutout(device(sub), 0, (0, 0, 0), volume(5))
    ref.write_cuboid(0, 2, np.zeros(CUBOID, dtype=np.uint8))
    sub.write_cuboid(0, 2, np.zeros(CUBOID, dtype=np.uint8))
    crash_at("compact.copied", after=1)
    with pytest.raises(SimulatedCrash):
        compact_store(sub, batch_keys=16)
    set_crash_hook(None)
    want = jcut.cutout(ref, 0, (0, 0, 0), SHAPE)
    np.testing.assert_array_equal(read_all(device(sub)), want)
    sub.close()
    reborn = tiered(root)
    np.testing.assert_array_equal(read_all(device(reborn)), want)
    reborn.compact()
    assert reborn.stored_keys() == ref.stored_keys()
    assert reborn.write_backend.stats()["live_keys"] == 0
    reborn.close()


def test_crash_between_drop_and_remove_is_idempotent(tmp_path, crash_at):
    root = str(tmp_path)
    sub = tiered(root)
    data = np.full(CUBOID, 3, dtype=np.uint8)
    for m in range(8):
        sub.write_cuboid(0, m, data)
    crash_at("compact.segment-removed")
    with pytest.raises(SimulatedCrash):
        sub.compact()
    set_crash_hook(None)
    sub.close()
    reborn = tiered(root)
    for m in range(8):
        np.testing.assert_array_equal(reborn.read_cuboid(0, m), data)
    reborn.compact()
    assert reborn.write_backend.stats()["live_keys"] == 0
    reborn.close()


def test_write_through_of_a_crashed_append_is_not_acknowledged(tmp_path, crash_at):
    """A write whose log append crashes raises out of `write_cutout`: it is
    not acknowledged, and a reopened stack serves the cuboid whole or not
    at all, never torn; the writes before it are all there."""
    root = str(tmp_path)
    sub = tiered(root)
    dstore = device(sub)
    tcut.write_cutout(dstore, 0, (0, 0, 0), volume(6))
    crash_at("wal.append.written")
    with pytest.raises(SimulatedCrash):
        tcut.write_cutout(dstore, 0, (0, 0, 0), np.full(CUBOID, 9, np.uint8))
    set_crash_hook(None)
    reborn = tiered(root)
    got = read_all(device(reborn))
    first = got[:8, :8, :4]
    assert (first == 9).all() or np.array_equal(first, volume(6)[:8, :8, :4])
    np.testing.assert_array_equal(got[8:], volume(6)[8:])
    blob = reborn.write_backend.get((0, 0, 0))
    assert decompress(blob, CUBOID, np.uint8).shape == CUBOID
    reborn.close()
    sub.close()
