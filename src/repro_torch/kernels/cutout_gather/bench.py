"""Time `cutout_gather` at the detection path's tile, a level-0 box and the
time series' box, beside each one's byte bound.

    python -m repro_torch.kernels.cutout_gather.bench [--against OLD.cu] [--reps N]

The rank-3 cases are the smoke's: sixteen 512 x 512 x 64 uint8 tiles of a
(2,048, 2,048, 256) level in 128 x 128 x 16 cuboids, and four 1,024 x 1,024
x 64 boxes of a (4,096, 4,096, 256) level; the rank-4 case is the 1,024 x
1,024 x 32 x 16 box of a (2,048, 2,048, 64, 16) uint8 series in 128 x 128 x
16 x 16 cuboids.  Data are random bytes from a seed; each time is the
median of ``--reps`` calls by CUDA events, the calls cycling over a case's
boxes.

With ``--against``, a source with the rank-3 C entry point that came
before the rank-4 one (out, packed, plan, X, Y, Zu, ox, oy, ozu, cx, cy,
czu, gy, gz, unit_bytes, stream) is built beside this source, both are
timed at the rank-3 cases in turns (other, this, this, other), and their
outputs are compared byte for byte.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import pathlib
import sys

import numpy as np
import torch

from .. import _bench, _build
from ...core.cuboid import CuboidGrid
from . import ops
from .ref import cutout_gather_ref

PEAK = 3.35e12  # H100 SXM HBM bytes/s (NVIDIA data sheet)


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(7)

    def level(shape, cs):
        grid = CuboidGrid(shape, cs)
        packed = torch.randint(0, 256, (grid.n_cells,) + cs, generator=gen, device=dev,
                               dtype=torch.uint8)
        return grid, packed

    def plan(grid, packed, lo, hi):
        gshape, cells, alo = ops.build_plan(grid, lo, hi)
        return (packed, torch.from_numpy(cells).to(dev), gshape,
                [l - a for l, a in zip(lo, alo)], [h - l for l, h in zip(lo, hi)])

    grid, packed = level((2048, 2048, 256), (128, 128, 16))
    tiles = [((512 * i, 512 * j, 64 * k), (512 * (i + 1), 512 * (j + 1), 64 * (k + 1)))
             for i in range(4) for j in range(4) for k in range(1)]
    yield "tile 512x512x64", 3, [plan(grid, packed, lo, hi) for lo, hi in tiles]
    grid, packed = level((4096, 4096, 256), (128, 128, 16))
    big = [((1024 * i, 1024 * j, 64 * k), (1024 * (i + 1), 1024 * (j + 1), 64 * (k + 1)))
           for i, j, k in [(0, 0, 0), (3, 3, 3), (1, 2, 1), (2, 0, 2)]]
    yield "level-0 1024x1024x64", 3, [plan(grid, packed, lo, hi) for lo, hi in big]
    del packed
    grid, packed = level((2048, 2048, 64, 16), (128, 128, 16, 16))
    yield "rank 4 1024x1024x32x16", 4, [plan(grid, packed, (0, 0, 0, 0),
                                             (1024, 1024, 32, 16))]


def old_entry(lib):
    fn = lib.cutout_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(packed, plan, gshape, offset, out_shape):
        out = torch.empty(out_shape, dtype=packed.dtype, device=packed.device)
        _, cx, cy, cz = packed.shape
        X, Y, Z = out_shape
        unit = ops._unit_bytes(packed.element_size(), (cz, offset[2], Z),
                               (packed.data_ptr(), out.data_ptr()))
        per = unit // packed.element_size()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(out.data_ptr(), packed.data_ptr(), plan.data_ptr(), X, Y, Z // per,
                 offset[0], offset[1], offset[2] // per, cx, cy, cz // per,
                 gshape[1], gshape[2], unit, stream)
        if err:
            raise RuntimeError(f"the other source's launch failed (cudaError {err})")
        return out
    return call


def cycling(fn, arglist):
    """A call of ``fn`` on the next argument tuple of ``arglist`` each time."""
    it = itertools.cycle(arglist)
    return lambda: fn(*next(it))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="an earlier kernel.cu with the rank-3 C entry point")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(_bench.card())
    this_lib = _build.BUILD_DIR / "bench" / "cutout_gather_this.so"
    print("this source:", _bench.compile_with_report(_build.source_of(ops.NAME), this_lib))
    other = None
    if args.against:
        other_lib = _build.BUILD_DIR / "bench" / "cutout_gather_other.so"
        print(f"{args.against}:", _bench.compile_with_report(args.against, other_lib))
        other = old_entry(ctypes.CDLL(str(other_lib)))
    for name, rank, arglist in cases(dev):
        k = len(arglist)
        nbytes = sum(2 * int(np.prod(a[4])) + a[1].numel() * 4 for a in arglist) / k
        bound = nbytes / PEAK * 1e3
        for a in arglist:
            got = ops.cutout_gather_cuda(*a)
            if not torch.equal(got, cutout_gather_ref(*a)):
                raise RuntimeError(f"{name}: kernel != plain")
            if other is not None and rank == 3 and not torch.equal(got, other(*a)):
                raise RuntimeError(f"{name}: this source != the other")
        mine = cycling(ops.cutout_gather_cuda, arglist)
        turns = [("this", mine)]
        if other is not None and rank == 3:
            theirs = cycling(other, arglist)
            turns = [("other", theirs), ("this", mine), ("this", mine), ("other", theirs)]
        times = [(who, _bench.event_ms(fn, args.reps)) for who, fn in turns]
        print(f"{name}: " + ", ".join(f"{who} {ms:.6f} ms" for who, ms in times)
              + f"; bound {bound:.6f} ms ({nbytes / 2 ** 20:.1f} MiB moved a call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
