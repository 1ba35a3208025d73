"""Port parity: the synapse detector's numerics against the JAX reference.

Floats agree within the fp32 tolerance of the kernel tests; component
labels, masks and detections agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import vision as jv
from repro_torch import vision as tv

# the fp32 tolerance of tests/test_kernels.py, scaled by the data's range
RTOL = 2e-5


def _close(got: torch.Tensor, want, x):
    atol = 2e-5 * float(np.abs(x).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=atol)


def synthetic_volume(shape=(48, 48, 16), n_blobs=5, seed=3):
    """The reference's test volume (tests/test_vision.py)."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(100, 3, size=shape).astype(np.float32)
    for _ in range(n_blobs):
        c = [rng.integers(6, s - 6) for s in shape]
        xx, yy, zz = np.ogrid[:shape[0], :shape[1], :shape[2]]
        d2 = ((xx - c[0]) ** 2 + (yy - c[1]) ** 2 + ((zz - c[2]) * 2) ** 2)
        vol += 80.0 * np.exp(-d2 / 8.0)
    return vol


@pytest.mark.parametrize("sigmas,radius", [((1.0, 1.0, 0.5), 4),
                                           ((3.0, 0.0, 1.5), 4),
                                           ((6.0, 6.0, 3.0), 8)])
def test_gaussian_blur_matches_jax(sigmas, radius):
    x = np.random.default_rng(0).normal(50, 20, size=(24, 20, 10)).astype(np.float32)
    want = jv.gaussian_blur(jnp.asarray(x), sigmas, radius)
    _close(tv.gaussian_blur(torch.from_numpy(x), sigmas, radius), want, x)


def test_difference_of_gaussians_matches_jax():
    x = synthetic_volume()
    want = jv.difference_of_gaussians(jnp.asarray(x))
    _close(tv.difference_of_gaussians(torch.from_numpy(x)), want, x)


def _cc_equal(mask: np.ndarray):
    want = np.asarray(jv.connected_components(jnp.asarray(mask)))
    got = tv.connected_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_cc_two_blobs_and_diagonal():
    mask = np.zeros((12, 12, 4), dtype=bool)
    mask[1:4, 1:4, 1:3] = True
    mask[8:11, 8:11, 1:3] = True
    lab = _cc_equal(mask)
    assert len(set(np.unique(lab)) - {0}) == 2
    diag = np.zeros((6, 6, 2), dtype=bool)
    diag[0, 0, 0] = diag[1, 1, 0] = True
    lab = _cc_equal(diag)
    assert lab[0, 0, 0] != lab[1, 1, 0]


@pytest.mark.parametrize("density", [0.2, 0.35, 0.55])
def test_cc_random_masks(density):
    rng = np.random.default_rng(int(density * 100))
    _cc_equal(rng.random((17, 13, 9)) < density)


def test_cc_long_serpentine():
    """One snake through a whole plane: the slowest case for propagation."""
    mask = np.zeros((15, 15, 2), dtype=bool)
    for i in range(0, 15, 2):
        mask[i, :, 0] = True
        if i + 1 < 15:
            mask[i + 1, 14 if (i // 2) % 2 == 0 else 0, 0] = True
    lab = _cc_equal(mask)
    assert len(np.unique(lab[mask])) == 1


def test_cc_components_touch_every_face():
    """No wrap-around: components on opposite faces stay apart."""
    mask = np.zeros((8, 7, 6), dtype=bool)
    mask[0], mask[-1] = True, True
    mask[2:6, 0, 2:4], mask[2:6, -1, 2:4] = True, True
    mask[3, 3, 0], mask[3, 3, -1] = True, True
    lab = _cc_equal(mask)
    assert lab[0, 0, 0] != lab[-1, 0, 0]
    assert lab[3, 3, 0] != lab[3, 3, -1]


def test_large_structure_mask_matches_jax():
    rng = np.random.default_rng(9)
    low = rng.normal(100, 4, size=(16, 16, 8)).astype(np.float32)
    low[4:12, 5:8, :] += 60.0  # a vessel
    want = np.asarray(jv.large_structure_mask(jnp.asarray(low)))
    got = tv.large_structure_mask(torch.from_numpy(low)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("seed,min_voxels", [(3, 4), (5, 8), (8, 4)])
def test_detect_synapses_matches_jax(seed, min_voxels):
    vol = synthetic_volume(seed=seed, n_blobs=6)
    # The masks can only agree exactly if no reference response sits at the
    # threshold within the float tolerance: check that on these seeds.
    resp = np.asarray(jv.difference_of_gaussians(jnp.asarray(vol)))
    resp = (resp - resp.mean()) / (resp.std() + 1e-6)
    assert np.abs(resp - 2.0).min() > 1e-4

    jdets, jlab = jv.detect_synapses(vol, threshold=2.0, min_voxels=min_voxels)
    tdets, tlab = tv.detect_synapses(vol, threshold=2.0, min_voxels=min_voxels,
                                     device="cpu")
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    assert len(tdets) == len(jdets) >= 3
    for t, j in zip(tdets, jdets):
        assert t.n_voxels == j.n_voxels
        assert t.bbox_lo == j.bbox_lo and t.bbox_hi == j.bbox_hi
        assert t.centroid == tuple(float(c) for c in j.centroid)
        assert abs(t.confidence - j.confidence) <= 1e-6


def test_detect_synapses_with_exclusion_and_empty():
    vol = synthetic_volume(seed=4)
    excl = np.zeros(vol.shape, dtype=bool)
    excl[:24] = True
    jdets, jlab = jv.detect_synapses(vol, min_voxels=4, exclusion_mask=excl)
    tdets, tlab = tv.detect_synapses(torch.from_numpy(vol), min_voxels=4,
                                     exclusion_mask=torch.from_numpy(excl))
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    assert [d.n_voxels for d in tdets] == [d.n_voxels for d in jdets]
    flat = np.full((8, 8, 4), 7.0, dtype=np.float32)
    dets, lab = tv.detect_synapses(flat, device="cpu")
    assert dets == [] and not lab.any()
