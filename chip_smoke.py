#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py [--out FILE]        # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse          # control flow only, tiny, CPU

Phases (any failure raises and the exit code is non-zero):

1. Print the card's name and power limit, build the CUDA kernels from the
   sources under ``src/repro_torch/kernels`` and time the build.
2. The main path, once, through the port's entry points, with every kernel
   launch count set to 0 just before it and read just after: a seeded
   synthetic EM volume (uint8, 8192 x 8192 x 256 at level 0 — 65,536
   cuboids of 128 x 128 x 16, 16 GiB packed) made on the device slab by
   slab and ingested, the hierarchy built to level 5, and the paper's
   parallel synapse detection at level 2 (64 tiles of 512 x 512 x 64, 20
   workers, batches of 40, large-structure mask from level 5).
3. Results checked: 4 tiles re-run with cutouts through the plain gather
   give the stored annotations, one stored id per detected label and
   voxel for voxel; a stored level-1 box equals the downsampled level-0
   box; a small pipeline agrees between the card and the CPU reference
   path.  A torch.profiler window over 2 tiles gives the device's idle
   share.
4. Each kernel against its plain PyTorch version on the card (bit-exact
   for the gather) over dtypes, aligned, unaligned and volume-edge boxes,
   a 1024 x 1024 x 64 box of level 0 and a box whose cells lie past byte
   offset 2^31; timed with CUDA events (median of >= 20) beside the bound
   set by the card's memory rate.

The line before the last is the JSON kernel report; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

from repro_torch.core import cutout as cut  # noqa: E402
from repro_torch.core.annotations import AnnotationProject  # noqa: E402
from repro_torch.core.cuboid import (CuboidGrid, DatasetSpec,  # noqa: E402
                                     downsample_block)
from repro_torch.core.store import DeviceCuboidStore  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cutout_gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.cutout_gather.ref import cutout_gather_ref  # noqa: E402
from repro_torch.vision import synapse_detector as sd  # noqa: E402

KERNELS = {
    "cutout_gather": dict(
        route="cuda",
        source="src/repro_torch/kernels/cutout_gather/kernel.cu",
        replaces="src/repro/kernels/cutout_gather/kernel.py:30",
        ops=gather_ops),
}

FULL = dict(volume=(8192, 8192, 256), n_resolutions=6, r=2,
            tile=(512, 512, 64), lowres=5, workers=20, n_blobs=49152,
            slab=128)
TINY = dict(volume=(256, 256, 32), n_resolutions=3, r=1,
            tile=(64, 64, 32), lowres=2, workers=3, n_blobs=48, slab=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hbm_peak_bytes_per_s(name: str) -> float:
    """Published memory rate of the H100 (NVIDIA data sheet)."""
    return 2.0e12 if "PCIe" in name else 3.35e12  # PCIe, else SXM


# --------------------------------------------------------------- volume ----

def make_blobs(cfg, gen, dev):
    """Synapse-sized blob centres, spread like examples/synapse_pipeline.py
    at the detection level: ~4.6e-5 blobs per level-r voxel."""
    X, Y, Z = cfg["volume"]
    f = 1 << cfg["r"]
    margin = 8 * f
    u = torch.rand((cfg["n_blobs"], 3), generator=gen, device=dev)
    lo = torch.tensor([margin, margin, 8], device=dev)
    hi = torch.tensor([X - margin, Y - margin, Z - 8], device=dev)
    return (lo + u * (hi - lo)).long()


def make_slab(cfg, x0, centres, gen, dev):
    """Level-0 EM slab [x0, x0 + slab): noise + blobs + a vessel, uint8.

    The level-r picture reads like the example volume: noise sd 4, blobs of
    amplitude 90 with exp(-d2 / 9) profiles (Z twice as steep), a bright
    vessel of +60.  Level 0 is 2^r finer in X and Y, so blobs are 2^r wider
    there and the noise is 2^r stronger (averaging 4^r voxels divides it).
    """
    X, Y, Z = cfg["volume"]
    f = 1 << cfg["r"]
    n = cfg["slab"]
    vol = torch.randn((n, Y, Z), generator=gen, device=dev).mul_(4.0 * f).add_(100.0)
    w_xy, w_z = 7 * f, 4
    near = centres[(centres[:, 0] >= x0 - w_xy) & (centres[:, 0] < x0 + n + w_xy)]
    if near.shape[0]:
        ax = torch.arange(-w_xy, w_xy, device=dev)
        az = torch.arange(-w_z, w_z, device=dev)
        dx, dy, dz = torch.meshgrid(ax, ax, az, indexing="ij")
        prof = 90.0 * torch.exp(-(((dx / f) ** 2 + (dy / f) ** 2
                                   + (2.0 * dz) ** 2) / 9.0))
        xs = near[:, 0, None] + dx.reshape(1, -1)
        keep = (xs >= x0) & (xs < x0 + n)
        ys = near[:, 1, None] + dy.reshape(1, -1)
        zs = near[:, 2, None] + dz.reshape(1, -1)
        flat = ((xs - x0) * Y + ys) * Z + zs
        vals = prof.reshape(1, -1).expand_as(flat)
        vol.view(-1).index_add_(0, flat[keep], vals[keep])
    vx0, vx1 = X * 40 // 128, X * 90 // 128
    a, b = max(vx0, x0), min(vx1, x0 + n)
    if a < b:
        vol[a - x0:b - x0, Y * 40 // 128:Y * 50 // 128, :] += 60.0
    return vol.clamp_(0, 255).to(torch.uint8)


def timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


# ------------------------------------------------------------ main path ----

def main_path(cfg, dev, report):
    spec = DatasetSpec("bock11-share", cfg["volume"],
                       n_resolutions=cfg["n_resolutions"], dtype="uint8")
    gen = torch.Generator(device=dev).manual_seed(11)
    store = DeviceCuboidStore(spec, device=dev)
    centres = make_blobs(cfg, gen, dev)

    def ingest_all():
        for x0 in range(0, cfg["volume"][0], cfg["slab"]):
            cut.ingest(store, 0, make_slab(cfg, x0, centres, gen, dev),
                       offset=(x0, 0, 0))

    _, t_ingest = timed(dev, ingest_all)
    _, t_hier = timed(dev, lambda: cut.build_hierarchy(store))
    proj = AnnotationProject("synapses", spec, device=dev)
    n_written, t_detect = timed(dev, lambda: sd.run_parallel_detection(
        store, proj, r=cfg["r"], tile=cfg["tile"], n_workers=cfg["workers"],
        threshold=2.0, min_voxels=4, batch_size=40,
        lowres_level=cfg["lowres"]))
    det_voxels = int(np.prod(spec.grid(cfg["r"]).volume_shape))
    report["phases"] = dict(ingest_s=t_ingest, hierarchy_s=t_hier,
                            detect_s=t_detect)
    report["detections"] = n_written
    report["detect_voxels_per_s"] = det_voxels / t_detect
    report["packed_bytes"] = store.nbytes
    log(f"main path: ingest {t_ingest:.3f} s, hierarchy {t_hier:.3f} s, "
        f"detection {t_detect:.3f} s -> {n_written} synapses, "
        f"{det_voxels / t_detect:.4g} voxels/s through cutout->detect->annotate")
    return spec, store, proj


def check_results(cfg, dev, spec, store, proj, report):
    r = cfg["r"]
    if report["detections"] <= 0:
        raise RuntimeError("the main path wrote no detections")
    for lev in range(spec.n_resolutions):
        packed = store.peek(lev)
        if packed is None or not bool(packed.any()):
            raise RuntimeError(f"level {lev} is empty after build_hierarchy")
    # level 1 holds the downsampled level 0 (a box away from the edges)
    v1 = spec.grid(1).volume_shape
    lo1 = (v1[0] // 4, v1[1] // 3, 1)
    hi1 = (v1[0] // 2 + 3, v1[1] // 2 + 5, v1[2] - 1)
    want = downsample_block(cut.cutout(store, 0, (2 * lo1[0], 2 * lo1[1], lo1[2]),
                                       (2 * hi1[0], 2 * hi1[1], hi1[2])), (0, 1))
    if not torch.equal(cut.cutout(store, 1, lo1, hi1), want):
        raise RuntimeError("level 1 is not the downsampled level 0")

    # 4 tiles again, with cutouts through the plain gather: the detections
    # must be the stored ones, label for label
    grid = spec.grid(r)
    low = cut.cutout(store, cfg["lowres"], (0, 0, 0),
                     spec.grid(cfg["lowres"]).volume_shape)
    excl_full = sd.large_structure_mask(low.to(torch.float32))
    tiles = sd.tiling(grid.volume_shape, cfg["tile"])
    boxes = [tiles[i] for i in sorted({0, len(tiles) // 3,
                                       2 * len(tiles) // 3, len(tiles) - 1})]
    packed = store.peek(r)
    n_dets = 0
    for lo, hi in boxes:
        gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
        plan = torch.from_numpy(cells).to(dev)
        via_ref = cutout_gather_ref(packed, plan, gshape,
                                    [l - a for l, a in zip(lo, alo)],
                                    [h - l for l, h in zip(lo, hi)])
        via_kernel = cut.cutout(store, r, lo, hi)
        if not torch.equal(via_kernel, via_ref):
            raise RuntimeError(f"tile {lo}: kernel cutout != plain cutout")
        excl = sd.scale_mask(excl_full, cfg["lowres"] - r, lo, hi)
        dets, lab = sd.detect_synapses(via_ref, threshold=2.0, min_voxels=4,
                                       exclusion_mask=excl)
        stored = proj.read(r, lo, hi)
        fg = lab != 0
        if not torch.equal(stored != 0, fg):
            raise RuntimeError(f"tile {lo}: stored annotations != detections")
        # one stored id per detection label and one label per stored id
        pairs = torch.unique(torch.stack([stored[fg], lab[fg]]), dim=1)
        if not (pairs.shape[1] == len(dets)
                == int(torch.unique(pairs[0]).numel())
                == int(torch.unique(pairs[1]).numel())):
            raise RuntimeError(f"tile {lo}: stored ids != detections")
        n_dets += len(dets)
    report["recheck_tiles"] = dict(tiles=len(boxes), detections=n_dets)
    log(f"re-checked {len(boxes)} tiles through the plain gather: "
        f"{n_dets} detections, identical to the stored labels")


def where_time_goes(cfg, dev, spec, store, report, n_tiles=2):
    """torch.profiler over `detect_tile` on a few tiles, one worker: the
    ops that take the host's and the device's time, and the device's busy
    share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    r = cfg["r"]
    low = cut.cutout(store, cfg["lowres"], (0, 0, 0),
                     spec.grid(cfg["lowres"]).volume_shape)
    excl_full = sd.large_structure_mask(low.to(torch.float32))
    proj = AnnotationProject("profile", spec, device=dev)
    tiles = sd.tiling(spec.grid(r).volume_shape, cfg["tile"])[-n_tiles:]

    def run():
        return sum(sd.detect_tile(store, proj, r, lo, hi,
                                  sd.scale_mask(excl_full, cfg["lowres"] - r,
                                                lo, hi), min_voxels=4)
                   for lo, hi in tiles)

    run()  # warm the allocator and the kernels
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ops, busy = [], 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if str(e.device_type).endswith("CPU"):
            ops.append((e.key, e.count, e.self_cpu_time_total, dev_us))
        else:  # kernels, copies and fills as the device ran them
            busy += dev_us / 1e6
    top_dev = sorted(ops, key=lambda x: -x[3])[:8]
    top_cpu = sorted(ops, key=lambda x: -x[2])[:8]
    report["profile"] = dict(tiles=len(tiles), detections=n, wall_s=wall,
                             device_busy_s=busy, device_idle_share=1 - busy / wall,
                             top_device=top_dev, top_host=top_cpu)
    log(f"profile of {len(tiles)} tiles ({n} detections), one worker: wall "
        f"{wall:.3f} s, device busy {busy:.3f} s (idle share "
        f"{1 - busy / wall:.3f})")
    for label, top, col in (("device", top_dev, 3), ("host", top_cpu, 2)):
        log(f"  top {label} ops: " + "; ".join(
            f"{t[0][:48]} x{t[1]} {t[col] / 1e3:.1f} ms" for t in top))


def small_pipeline_vs_cpu(dev, report):
    """The example's 128 x 128 x 32 pipeline on the card and on the CPU."""
    rng = np.random.default_rng(7)
    shape = (128, 128, 32)
    vol = rng.normal(100, 4, size=shape).astype(np.float32)
    xx, yy, zz = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for _ in range(24):
        c = [int(rng.integers(8, s - 8)) for s in shape]
        d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + ((zz - c[2]) * 2) ** 2
        vol += 90.0 * np.exp(-d2 / 9.0)
    vol[40:90, 40:50, :] += 60.0
    spec = DatasetSpec("cortex", shape, dtype="float32", n_resolutions=2,
                       base_cuboid=(32, 32, 16))
    out = {}
    for d in (dev, torch.device("cpu")):
        store = DeviceCuboidStore(spec, device=d)
        cut.ingest(store, 0, vol)
        cut.build_hierarchy(store)
        proj = AnnotationProject("det", spec, device=d)
        n = sd.run_parallel_detection(store, proj, r=0, tile=(64, 64, 32),
                                      n_workers=1, threshold=2.0,
                                      min_voxels=4, lowres_level=1)
        out[d.type] = (n, proj.read(0, (0, 0, 0), shape).cpu())
    if out[dev.type][0] != out["cpu"][0] or not torch.equal(
            out[dev.type][1], out["cpu"][1]):
        raise RuntimeError("small pipeline: card and CPU results differ")
    report["small_pipeline_detections"] = out["cpu"][0]
    log(f"small pipeline: {out['cpu'][0]} detections, card == CPU")


# -------------------------------------------------------------- kernels ----

def event_times(dev, fn, reps=25):
    """Per-call device time (ms) by CUDA events, median of ``reps``.  The
    calls queue behind a device-side sleep so host launch gaps do not
    count."""
    fn()
    torch.cuda.synchronize(dev)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for i in range(reps):
        starts[i].record()
        fn(i)
        ends[i].record()
    torch.cuda.synchronize(dev)
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def gather_case(packed, grid, lo, hi, dev):
    gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
    plan = torch.from_numpy(cells).to(dev)
    args = (packed, plan, gshape, [l - a for l, a in zip(lo, alo)],
            [h - l for l, h in zip(lo, hi)])
    return args


def compare_gather(packed, grid, lo, hi, dev, label, errs):
    """Kernel vs plain on one box: bit-exact, and the largest value error."""
    args = gather_case(packed, grid, lo, hi, dev)
    got = gather_ops.cutout_gather_cuda(*args)
    want = cutout_gather_ref(*args)
    torch.cuda.synchronize(dev)
    same = (got.shape == want.shape
            and torch.equal(got.view(torch.uint8), want.view(torch.uint8)))
    if not same:
        raise RuntimeError(f"cutout_gather {label}: kernel != plain")
    errs.append(float((got.double() - want.double()).abs().max()))
    return args


def kernel_checks(dev, store, spec, cfg, report, peak):
    errs = []
    # dtypes x box kinds on a small level-shaped array
    gen = torch.Generator(device=dev).manual_seed(5)
    for cs in [(128, 128, 16), (64, 64, 64)]:
        grid = CuboidGrid((3 * cs[0] - 37, 2 * cs[1] + 11, 5 * cs[2] - 3), cs)
        for dt in (torch.uint8, torch.uint16, torch.int32, torch.float32):
            shape = (grid.n_cells,) + cs
            packed = (torch.randn(shape, generator=gen, device=dev)
                      if dt.is_floating_point else
                      torch.randint(0, 256, shape[:-1] + (cs[2] * dt.itemsize,),
                                    generator=gen, device=dev,
                                    dtype=torch.uint8).view(dt))
            v = grid.volume_shape
            for label, lo, hi in [
                    ("aligned", (0, 0, 0), (cs[0], cs[1], 2 * cs[2])),
                    ("unaligned", (5, 3, 2), (v[0] - 9, v[1] - 4, v[2] - 7)),
                    ("edge", (v[0] - 40, v[1] - 33, v[2] - 5), v),
                    ("voxel", (v[0] - 1, 17, 3), (v[0], 18, 4))]:
                compare_gather(packed, grid, lo, hi, dev,
                               f"{dt} {cs} {label}", errs)
    log(f"cutout_gather: {len(errs)} small cases bit-exact vs plain")

    # at the main path's shapes
    cases = {}
    r = cfg["r"]
    g_r = spec.grid(r)
    tiles = sd.tiling(g_r.volume_shape, cfg["tile"])[:16]
    cases["tile"] = [compare_gather(store.peek(r), g_r, lo, hi, dev,
                                    f"tile {lo}", errs) for lo, hi in tiles]
    g0 = spec.grid(0)
    big = [((1024 * i, 1024 * j, 64 * k), (1024 * (i + 1), 1024 * (j + 1), 64 * (k + 1)))
           for i, j, k in [(0, 0, 0), (7, 7, 3), (3, 5, 1), (6, 2, 2)]]
    cases["l0_1024x1024x64"] = [compare_gather(store.peek(0), g0, lo, hi, dev,
                                               f"level0 {lo}", errs)
                                for lo, hi in big]
    # cells past byte offset 2^31 (Morton cells >= 8192 at level 0)
    lo, hi = (8192 - 300, 8192 - 277, 200), (8192 - 3, 8192 - 1, 255)
    args = compare_gather(store.peek(0), g0, lo, hi, dev, "past 2^31", errs)
    first = int(args[1].min()) * g0.cuboid_voxels
    if first < 2 ** 31:
        raise RuntimeError("the far box does not reach past byte 2^31")
    cases["past_2^31"] = [args]
    log(f"cutout_gather: {len(errs)} cases bit-exact incl. cells from byte "
        f"{first} on")

    timings = {}
    for name, arglist in cases.items():
        out_bytes = sum(int(np.prod(a[4])) * a[0].element_size() for a in arglist)
        plan_bytes = sum(a[1].numel() * 4 for a in arglist)
        k = len(arglist)
        ms = event_times(dev, lambda i=0: gather_ops.cutout_gather_cuda(*arglist[i % k]))
        plain = event_times(dev, lambda i=0: cutout_gather_ref(*arglist[i % k]))
        per_bytes = (2 * out_bytes + plan_bytes) / k
        bound = per_bytes / peak * 1e3
        timings[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                             bytes=per_bytes, gbps=per_bytes / ms / 1e6,
                             hbm_share=bound / ms, boxes=k)
        log(f"cutout_gather {name}: {ms:.4f} ms/box (plain {plain:.4f} ms), "
            f"{per_bytes / ms / 1e6:.1f} GB/s = {100 * bound / ms:.1f}% of the "
            f"{peak / 1e12:.2f} TB/s HBM peak (bound {bound:.4f} ms)")
    report["cutout_gather"] = timings
    return max(errs), timings["tile"]


def rehearse():
    """Main path at a tiny size on the CPU: control flow only, no kernels,
    no timing claims and no result line."""
    dev = torch.device("cpu")
    report = {}
    spec, store, proj = main_path(TINY, dev, report)
    check_results(TINY, dev, spec, store, proj, report)
    log(json.dumps({"rehearsal": report}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of the control flow (no result line)")
    args = ap.parse_args(argv)
    if args.rehearse:
        return rehearse()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peak = hbm_peak_bytes_per_s(name)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    report = {"card": smi}

    t0 = time.perf_counter()
    for n in KERNELS:
        _build.library(n)
    report["build_s"] = time.perf_counter() - t0
    log(f"built {list(KERNELS)} in {report['build_s']:.2f} s")

    for k in KERNELS.values():
        k["ops"].reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    spec, store, proj = main_path(FULL, dev, report)
    launches = {n: k["ops"].launches for n, k in KERNELS.items()}
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the main path: {launches}; max memory allocated "
        f"{report['max_memory_allocated'] / 2 ** 30:.2f} GiB")
    for n, c in launches.items():
        if c <= 0:
            raise RuntimeError(f"kernel {n} was not launched on the main path")

    check_results(FULL, dev, spec, store, proj, report)
    where_time_goes(FULL, dev, spec, store, report)
    small_pipeline_vs_cpu(dev, report)
    err, tile = kernel_checks(dev, store, spec, FULL, report, peak)

    rows = []
    for n, k in KERNELS.items():
        rows.append(dict(name=n, route=k["route"], source=k["source"],
                         replaces=k["replaces"], launches=launches[n],
                         max_abs_err=err, ms=tile["ms"],
                         plain_ms=tile["plain_ms"], bound_ms=tile["bound_ms"],
                         bound_by="bytes", library_ms=None))
    report["kernels"] = rows
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
