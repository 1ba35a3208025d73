"""Parallel synapse detection on the device — the paper's driving workload.

The paper extracted 19M synapse detections from bock11 with 20 parallel
workers reading cutouts and issuing batched annotation writes (§2, Fig 1):

  workers -> cutout (`cutout_gather` kernel) -> DoG blob filter + threshold
          -> connected components (min-label propagation + pointer jumping)
          -> size filter -> large-structure mask from a LOW resolution level
          -> batch annotation writes (batches of 40)

Every function mirrors its counterpart in the reference detector and keeps
its numerics: separable Gaussian blur with edge padding in float32, the
population standard deviation, linear-interpolated quantiles, and
component labels equal to the minimum flat index + 1 of each 6-connected
component.  Per-component statistics come from one device pass (unique +
scatter reductions) instead of one host pass per label.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.annotations import Annotation, AnnotationProject
from ..core.cutout import cutout
from ..core.store import DeviceCuboidStore
from ..device import DeviceLike, resolve_device


def _gauss_kernel(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


def gaussian_blur(vol: torch.Tensor, sigmas: Tuple[float, ...],
                  radius: int = 4) -> torch.Tensor:
    """Separable anisotropic Gaussian blur (sigma per dim; EM Z is coarse).

    Edge padding, then a sum of ``2*radius+1`` shifted slices per axis.  The
    reference convolves with the flipped kernel; the kernel is symmetric,
    so the weights line up unflipped.
    """
    out = vol.to(torch.float32)
    for d, s in enumerate(sigmas):
        if s <= 0:
            continue
        k = _gauss_kernel(s, radius).tolist()
        n = out.shape[d]
        padded = torch.cat([out.narrow(d, 0, 1).expand(
                                *[radius if i == d else -1
                                  for i in range(out.ndim)]),
                            out,
                            out.narrow(d, n - 1, 1).expand(
                                *[radius if i == d else -1
                                  for i in range(out.ndim)])], dim=d)
        acc = padded.narrow(d, 0, n) * k[0]
        for j in range(1, 2 * radius + 1):
            acc.add_(padded.narrow(d, j, n), alpha=k[j])
        out = acc
    return out


def difference_of_gaussians(vol, sigma1=(1.0, 1.0, 0.5),
                            sigma2=(3.0, 3.0, 1.5), radius=4):
    """Band-pass blob response; synapses are bright compact blobs."""
    return gaussian_blur(vol, sigma1, radius) - gaussian_blur(
        vol, sigma2, radius)


# Sweeps between convergence tests in `connected_components`: each test is
# a host sync, and a converged sweep is a no-op, so extra sweeps are safe.
CC_SWEEPS_PER_CHECK = 4


def connected_components(mask: torch.Tensor,
                         connectivity: int = 6) -> torch.Tensor:
    """Label 6-connected components: min flat index + 1 per component.

    The fixpoint of the reference's min-label propagation is unique, so a
    faster schedule reaches the same labels: each sweep takes the min over
    face neighbours (no wrap-around) and then jumps every label to the
    label of the voxel it names (``lab <- lab[lab - 1]``, which stays
    inside the component).  Convergence is tested every
    `CC_SWEEPS_PER_CHECK` sweeps; the sweep count stays bounded by
    ``mask.numel()`` as in the reference.
    """
    if connectivity != 6:
        raise ValueError("only 6-connectivity is supported")
    fg = mask != 0
    n = mask.numel()
    big = n + 2
    lab = torch.where(fg, torch.arange(1, n + 1, dtype=torch.int32,
                                       device=mask.device).reshape(mask.shape),
                      0)
    it = 0
    while True:
        prev = lab
        for _ in range(CC_SWEEPS_PER_CHECK):
            padded = torch.where(fg, lab, big)
            best = padded.clone()
            for d in range(mask.ndim):
                m = mask.shape[d]
                if m < 2:
                    continue
                hi = best.narrow(d, 1, m - 1)
                torch.minimum(hi, padded.narrow(d, 0, m - 1), out=hi)
                lo = best.narrow(d, 0, m - 1)
                torch.minimum(lo, padded.narrow(d, 1, m - 1), out=lo)
            lab = torch.where(fg, best, 0)
            flat = lab.reshape(-1)
            jumped = flat[(flat - 1).clamp_(min=0).long()].reshape(mask.shape)
            lab = torch.where(fg, torch.minimum(lab, jumped), 0)
            it += 1
        if it >= n or torch.equal(lab, prev):
            return lab


def _quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile of all of ``x`` in float32, computed the
    way the reference's ``quantile`` does; ``kthvalue`` has no 2^24-element
    limit (``torch.quantile`` refuses larger inputs)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(
        n - 1, dtype=torch.float32)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    i_lo = int(min(max(low.item(), 0), n - 1))
    i_hi = int(min(max(high.item(), 0), n - 1))
    v_lo = flat.kthvalue(i_lo + 1).values
    v_hi = v_lo if i_hi == i_lo else flat.kthvalue(i_hi + 1).values
    return v_lo * low_w.to(x.device) + v_hi * high_w.to(x.device)


def large_structure_mask(lowres_vol: torch.Tensor, sigma=(6.0, 6.0, 3.0),
                         radius=8, quantile=0.9) -> torch.Tensor:
    """Mask of large bright structures (vessels, somata) at low resolution.

    Paper §3.1: computed at res 5, where large structures are detectable
    and the whole level fits in memory; the heavy blur washes out
    synapse-scale blobs.
    """
    smooth = gaussian_blur(lowres_vol, sigma, radius)
    return smooth >= _quantile_linear(smooth, quantile)


@dataclasses.dataclass
class Detection:
    centroid: Tuple[float, ...]
    n_voxels: int
    bbox_lo: Tuple[int, ...]
    bbox_hi: Tuple[int, ...]
    confidence: float


def detect_synapses(vol, threshold: float = 2.0, min_voxels: int = 8,
                    max_voxels: int = 512,
                    exclusion_mask: Optional[torch.Tensor] = None,
                    device: DeviceLike = "cuda"
                    ) -> Tuple[List[Detection], torch.Tensor]:
    """Detect synapse-like blobs in one cutout.

    Returns the detections in ascending order of component label and the
    int32 label volume renumbered 1..K in that order.  A tensor ``vol``
    runs on its own device; anything else is moved to ``device``.
    """
    if not isinstance(vol, torch.Tensor):
        vol = torch.as_tensor(vol, device=resolve_device(device))
    x = vol.to(torch.float32)
    resp = difference_of_gaussians(x)
    # population std, as the reference's ``std()``
    resp = (resp - resp.mean()) / (resp.std(correction=0) + 1e-6)
    mask = resp > threshold
    if exclusion_mask is not None:
        mask &= ~torch.as_tensor(exclusion_mask, device=mask.device)
    labels = connected_components(mask)
    out_labels = torch.zeros_like(labels)
    nz = labels.nonzero()                                    # (N, rank)
    if nz.shape[0] == 0:
        return [], out_labels
    labs = labels[tuple(nz.T)]
    uniq, inv, counts = torch.unique(labs, return_inverse=True,
                                     return_counts=True)
    n_lab, rank = uniq.shape[0], nz.shape[1]
    idx = inv[:, None].expand(-1, rank)
    lo = torch.full((n_lab, rank), torch.iinfo(torch.int64).max,
                    device=nz.device).scatter_reduce_(0, idx, nz, "amin")
    hi = torch.full((n_lab, rank), -1, device=nz.device).scatter_reduce_(
        0, idx, nz, "amax") + 1
    csum = torch.zeros((n_lab, rank), dtype=torch.int64,
                       device=nz.device).index_add_(0, inv, nz)
    # Deterministic per-label response sums: sort by label, one float64
    # scan, differences at segment ends (no atomics).
    order = torch.argsort(inv, stable=True)
    scan = torch.cumsum(resp[tuple(nz.T)].to(torch.float64)[order], 0)
    ends = torch.cumsum(counts, 0) - 1
    rsum = torch.diff(scan[ends], prepend=scan.new_zeros(1))
    keep = (counts >= min_voxels) & (counts <= max_voxels)
    new_id = torch.cumsum(keep.to(torch.int32), 0) * keep
    out_labels[tuple(nz.T)] = new_id.to(torch.int32)[inv]
    n = counts.to(torch.float64)
    cent = csum.to(torch.float64) / n[:, None]
    conf = torch.sigmoid((rsum / n).to(torch.float32))
    sel = keep.nonzero().squeeze(1)
    rows = zip(cent[sel].tolist(), counts[sel].tolist(), lo[sel].tolist(),
               hi[sel].tolist(), conf[sel].tolist())
    dets = [Detection(tuple(c), int(k), tuple(a), tuple(b), float(p))
            for c, k, a, b, p in rows]
    return dets, out_labels


def scale_mask(excl_full: torch.Tensor, levels_up: int, lo, hi) -> torch.Tensor:
    """The tile [lo, hi) of a low-resolution mask, upsampled in X and Y by
    ``2**levels_up`` (Z is not scaled between levels)."""
    f = 1 << levels_up
    sub = excl_full[lo[0] // f:max(lo[0] // f + 1, -(-hi[0] // f)),
                    lo[1] // f:max(lo[1] // f + 1, -(-hi[1] // f)),
                    lo[2]:hi[2]]
    out = sub.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)
    return out[:hi[0] - lo[0], :hi[1] - lo[1], :hi[2] - lo[2]]


def tiling(vol_shape: Sequence[int], tile: Sequence[int]):
    """Boxes (lo, hi) of the detection tiling, X outermost, clipped."""
    tiles = []
    for x0 in range(0, vol_shape[0], tile[0]):
        for y0 in range(0, vol_shape[1], tile[1]):
            for z0 in range(0, vol_shape[2], tile[2]):
                lo = (x0, y0, z0)
                hi = tuple(min(v, o + s) for v, o, s in zip(vol_shape, lo, tile))
                tiles.append((lo, hi))
    return tiles


def detect_tile(image_store: DeviceCuboidStore, project: AnnotationProject,
                r: int, lo, hi, exclusion_mask: Optional[torch.Tensor] = None,
                threshold: float = 2.0, min_voxels: int = 8,
                batch_size: int = 40) -> int:
    """One worker step: cutout -> detect -> batch-write the tile's objects.

    Each object is written as its label mask cropped to its bounding box,
    which stores the same voxels and index entries as a whole-tile mask.
    Returns the number of synapses written.
    """
    vol = cutout(image_store, r, lo, hi)
    dets, labels = detect_synapses(vol, threshold=threshold,
                                   min_voxels=min_voxels,
                                   exclusion_mask=exclusion_mask)
    objs = []
    for i, d in enumerate(dets):
        crop = tuple(slice(a, b) for a, b in zip(d.bbox_lo, d.bbox_hi))
        objs.append((Annotation(0, ann_type="synapse", confidence=d.confidence,
                                kv={"n_voxels": d.n_voxels}),
                     [o + a for o, a in zip(lo, d.bbox_lo)],
                     labels[crop] == i + 1))
    written = 0
    for i in range(0, len(objs), batch_size):
        written += len(project.batch_write_objects(r, objs[i:i + batch_size]))
    return written


def run_parallel_detection(image_store: DeviceCuboidStore,
                           project: AnnotationProject,
                           r: int, tile: Sequence[int],
                           n_workers: int = 4,
                           threshold: float = 2.0,
                           min_voxels: int = 8,
                           batch_size: int = 40,
                           lowres_level: Optional[int] = None) -> int:
    """The full paper workflow: parallel workers over a tiling of the volume.

    Each worker runs `detect_tile` (cutout -> detect -> batch-write
    annotations in batches of ``batch_size``, the size the paper found
    doubled throughput).  Returns the number of synapses written.
    """
    excl_full = None
    if lowres_level is not None and lowres_level < image_store.spec.n_resolutions:
        lg = image_store.spec.grid(lowres_level)
        low = cutout(image_store, lowres_level, (0,) * 3, lg.volume_shape)
        excl_full = large_structure_mask(low.to(torch.float32))

    def work(box):
        lo, hi = box
        excl = (None if excl_full is None
                else scale_mask(excl_full, lowres_level - r, lo, hi))
        return detect_tile(image_store, project, r, lo, hi, excl,
                           threshold=threshold, min_voxels=min_voxels,
                           batch_size=batch_size)

    tiles = tiling(image_store.spec.grid(r).volume_shape, tile)
    with cf.ThreadPoolExecutor(max_workers=n_workers) as ex:
        return sum(ex.map(work, tiles))
