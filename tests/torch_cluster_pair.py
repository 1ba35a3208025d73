"""Helpers shared by the port's cluster tests.

The same seeded numpy data goes into a reference `ClusterStore` (the JAX
package's, driven by its numpy cutout engine) and into the port's
`DeviceCuboidStore` on the CPU over a port `ClusterStore`; the helpers
here build such pairs and compare what they hold.  The reference cluster
is given every knob explicitly, so no environment setting reaches it.
"""
import numpy as np

from repro.cluster import ClusterStore as JClusterStore
from repro.core import cutout as jcut
from repro.core.cuboid import DatasetSpec as JSpec
from repro_torch import carry
from repro_torch.cluster import ClusterStore
from repro_torch.core import cutout as tcut
from repro_torch.core.cuboid import DatasetSpec
from repro_torch.core.store import DeviceCuboidStore, host_view

SHAPE = (32, 32, 16)
CUBOID = (8, 8, 4)
N_CELLS = 64  # the 4 x 4 x 4 grid of level 0


def spec_kw(name="cl", shape=SHAPE, dtype="uint8", **kw):
    return dict(name=name, volume_shape=shape, dtype=dtype, base_cuboid=CUBOID, **kw)


def volume(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).integers(1, 255, size=shape, dtype=np.uint8)


def rand_box(rng, shape=SHAPE):
    lo = [int(rng.integers(0, s - 1)) for s in shape]
    hi = [int(rng.integers(l + 1, s + 1)) for l, s in zip(lo, shape)]
    return lo, hi


def knobs(**kw):
    """Cluster arguments with the reference's environment knobs pinned."""
    return dict(dict(cache_bytes=0, write_behind=False, replication=1), **kw)


def ref_cluster(n_nodes=2, name="cl", vol=None, **kw):
    """A reference cluster, with ``vol`` ingested at level 0."""
    ref = JClusterStore(JSpec(**spec_kw(name)), n_nodes=n_nodes, **knobs(**kw))
    if vol is not None:
        jcut.ingest(ref, 0, vol)
    return ref


def port_store(n_nodes=2, name="cl", vol=None, **kw):
    """The port's device store on the CPU over a port cluster, with
    ``vol`` ingested at level 0 through the device store."""
    spec = DatasetSpec(**spec_kw(name))
    store = DeviceCuboidStore(spec, device="cpu", backing=ClusterStore(
        spec, n_nodes=n_nodes, **knobs(**kw)))
    if vol is not None:
        tcut.ingest(store, 0, vol)
    return store


def fresh(store):
    """A new device store over the same host store (nothing resident)."""
    return DeviceCuboidStore(store.spec, device="cpu", backing=store.backing)


def read(store, r, lo, hi, **kw):
    """A port cutout as a numpy array of the dataset's dtype."""
    return host_view(tcut.cutout(store, r, lo, hi, **kw), store.spec.dtype)


def write(store, r, lo, data, **kw):
    tcut.write_cutout(store, r, lo, data, **kw)


def assert_same_cluster(ref, port):
    """Both clusters (flushed first) hold the same topology and, node by
    node, the same keys with byte-identical blobs in each backend."""
    want, got = carry.cluster_items(ref), carry.cluster_items(port)
    assert got["n_nodes"] == want["n_nodes"]
    assert got["replication"] == want["replication"]
    assert set(got["bounds"]) == set(want["bounds"])
    for r in want["bounds"]:
        np.testing.assert_array_equal(got["bounds"][r], want["bounds"][r])
    for i, (g, w) in enumerate(zip(got["nodes"], want["nodes"])):
        for path in ("read", "write"):
            assert (g[path] is None) == (w[path] is None), (i, path)
            if w[path] is not None:
                assert [k for k, _ in g[path]] == [k for k, _ in w[path]], (i, path)
                assert [b for _, b in g[path]] == [b for _, b in w[path]], (i, path)
    assert port.keys_per_node() == ref.keys_per_node()
