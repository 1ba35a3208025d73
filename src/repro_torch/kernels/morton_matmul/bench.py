"""The tile-order study: `morton_matmul` on the card in its three orders.

    python -m repro_torch.kernels.morton_matmul.bench [--out FILE] [--reps N]
        [--against OLD.cu]

(with ``src`` on ``PYTHONPATH``, on a machine with a CUDA card and nvcc).
Prints the card, the compiler's register and spill report for
``kernel.cu``, how many ``HGMMA`` (wgmma) instructions its SASS holds, and
the kernel's blocks per SM.  With ``--against``, another source with the
same C entry point (an earlier ``kernel.cu``) is built with the same flags
and timed in turns with this one (other, this, this, other) in bf16 at
default blocks (Morton order) on both shapes, with the largest difference
between the two outputs.  Then for M = N = K = 8192
(a square grid) and M 6,000, N 10,000, K 4,000 (a ragged grid whose Morton
and Hilbert walks have clamped cells), in bf16 and fp32, at blocks 128 x
128 x 64 and 256 x 256 x 256:
- the three orders timed in turns (morton, hilbert, rowmajor, then
  rowmajor, hilbert, morton), each by CUDA events, median of ``--reps``;
- the plain version (``ref.py``: the fp32 product rounded to the dtype)
  and ``torch.matmul`` in the working dtype (a yardstick the port never
  calls), the same way;
- the bound: 2 M N K operations at the H100 SXM's bf16 tensor rate or
  its fp32 rate on the CUDA cores (TF32 would change the function), or the
  operands and result once at its memory rate (`device.h100_peaks`),
  whichever is longer;
- the orders' outputs bit-identical and within tolerance of the plain
  version (`rel_tol`: the JAX test's, grown with K past its K 512 in
  fp32), and a traced call per order (each tile once; the
  largest lag between a block's index and its start);
- the traffic model: `panel_traffic` at capacities 1, 4, 16 and 64, the
  same LRU over the kernel's launch order (`tile_order`), and the panels
  each wave of blocks in flight (SMs x blocks per SM) reads.
With ``--out`` the whole study is written as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import torch

from ...device import h100_peaks, resolve_device
from .. import _bench, _build
from . import ops
from .ref import morton_matmul_ref

HBM_BYTES_PER_S = h100_peaks().hbm_bytes_per_s  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: h100_peaks().bf16_flops, torch.float32: h100_peaks().fp32_flops}
SHAPES = [(8192, 8192, 8192), (6000, 10000, 4000)]
BLOCKS = [(128, 128, 64), (256, 256, 256)]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py:96
CAPACITIES = (1, 4, 16, 64)
TURNS = ("morton", "hilbert", "rowmajor", "rowmajor", "hilbert", "morton")


def _bind(lib: pathlib.Path):
    """`morton_matmul` (contiguous, aligned operands) through another build
    of the kernel's C entry point."""
    fn = ctypes.CDLL(str(lib)).morton_matmul_launch
    fn.argtypes = ops.ARGTYPES
    fn.restype = ctypes.c_int

    def matmul(a, b, blocks=(256, 256, 256), order="morton"):
        (M, K), N = a.shape, b.shape[1]
        bm, bn, bk, nm, nn = ops.grid(M, N, K, *blocks)
        tiles = ops.tile_order(nm, nn, order, a.device)
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), tiles.data_ptr(), None, M, N,
                 K, bm, bn, bk, nm * nn, int(a.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"morton_matmul launch failed (cudaError {err})")
        return out

    return matmul


def against(other, reps: int, dev) -> list:
    """This kernel and ``other`` in bf16 at default blocks on each shape, in
    turns (other, this, this, other)."""
    rows = []
    for M, N, K in SHAPES:
        a, b = inputs(M, N, K, torch.bfloat16, dev)
        diff = float((ops.morton_matmul(a, b).float() - other(a, b).float()).abs().max())
        runs = [("other", lambda: other(a, b)), ("this", lambda: ops.morton_matmul(a, b))]
        ms = {"other": [], "this": []}
        for name, fn in (runs[0], runs[1], runs[1], runs[0]):
            ms[name].append(_bench.event_ms(fn, reps))
        rows.append(dict(shape=[M, N, K], ms=ms, max_abs_diff=diff))
        print(f"--against {M} x {N} x {K} bf16: other {' / '.join(f'{t:.4f}' for t in ms['other'])}"
              f" ms; this {' / '.join(f'{t:.4f}' for t in ms['this'])} ms; max |this - other| "
              f"{diff:.4g}", flush=True)
        del a, b
        torch.cuda.empty_cache()
    return rows


def bound_ms(M: int, N: int, K: int, dtype: torch.dtype) -> tuple:
    """(bound in ms, "operations" or "bytes") of one product."""
    size = torch.empty((), dtype=dtype).element_size()
    t_ops = 2 * M * N * K / PEAK_FLOPS[dtype]
    t_bytes = size * (M * K + K * N + M * N) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def inputs(M: int, N: int, K: int, dtype: torch.dtype, dev, seed: int = 15):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((M, K), generator=gen, device=dev).to(dtype),
            torch.randn((K, N), generator=gen, device=dev).to(dtype))


def rel_tol(dtype: torch.dtype, K: int) -> float:
    """The JAX test's tolerance on |got - want| / (|want| + 1)
    (`tests/test_kernels.py:96`), which it holds at K up to 512.  In fp32
    two correct sums of K products in other orders part by an error that
    grows with K (the worst-case bound on a recursive sum by K times the
    unit roundoff), so past K 512 the fp32 tolerance grows as K / 512; in
    bf16 the output's rounding sets it."""
    return REL[dtype] * (max(1.0, K / 512) if dtype == torch.float32 else 1.0)


def time_orders(a, b, blocks, reps: int) -> dict:
    """Each order's two medians (ms), timed in the turns of ``TURNS``."""
    bm, bn, bk = blocks
    out: dict = {o: [] for o in ops.ORDERS}
    for order in TURNS:
        out[order].append(_bench.event_ms(
            lambda: ops.morton_matmul(a, b, block_m=bm, block_n=bn, block_k=bk,
                                      order=order), reps))
    return out


def check_orders(a, b, blocks, want) -> dict:
    """The orders' outputs bit-identical and within tolerance of ``want``
    (the plain version), each from a traced call."""
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk, nm, nn = ops.grid(M, N, K, *blocks)
    outs, lags = [], {}
    for order in ops.ORDERS:
        trace = ops.new_trace(nm, nn, a.device)
        got = ops.morton_matmul(a, b, block_m=bm, block_n=bn, block_k=bk, order=order,
                                trace=trace)
        lags[order] = ops.check_trace(trace, ops.tile_order(nm, nn, order, a.device))
        outs.append(got)
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise RuntimeError(f"morton_matmul {tuple(a.shape)} x {tuple(b.shape)} {blocks}: "
                           "the orders' outputs differ")
    w = want.float()
    diff = (outs[0].float() - w).abs()
    rel, tol = float((diff / (w.abs() + 1)).max()), rel_tol(a.dtype, K)
    if not rel < tol:
        raise RuntimeError(f"morton_matmul {tuple(a.shape)} x {tuple(b.shape)} {blocks} "
                           f"{a.dtype}: relative error {rel} past {tol}")
    return dict(max_abs_err=float(diff.max()), max_rel_err=rel, tol=tol, traces=lags)


def traffic(nm: int, nn: int, wave: int) -> dict:
    """Per order: `panel_traffic` by capacity, the LRU over the launch
    order, and the panels read wave by wave."""
    out = {}
    for order in ops.ORDERS:
        tiles = ops.tile_order_np(nm, nn, order)
        launch = [(int(t) // nn, int(t) % nn) for t in tiles]
        out[order] = dict(
            panel_traffic={c: ops.panel_traffic(nm, nn, order, c) for c in CAPACITIES},
            launch_lru={c: ops.lru_fetches(launch, c) for c in CAPACITIES},
            wave_panels=ops.wave_panels(tiles, nn, wave))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, help="write the study as JSON here")
    ap.add_argument("--reps", type=int, default=21, help="timed calls per median")
    ap.add_argument("--against", type=pathlib.Path,
                    help="another morton_matmul kernel source to time in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")  # and TF32 off for the plain version
    card = _bench.card()
    print(card)
    lib = _build.BUILD_DIR / "bench" / "mm.so"
    print("kernel.cu:", _bench.compile_with_report(_build.source_of(ops.NAME), lib), flush=True)
    sass = _bench.sass_counts(lib, ("HGMMA", "HMMA", "FFMA"))
    print(f"kernel.cu SASS: {sass}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    study = dict(card=card, sms=sms, sass=sass, cases=[])
    if args.against:
        other_lib = _build.BUILD_DIR / "bench" / "mm-other.so"
        print(f"{args.against}:", _bench.compile_with_report(args.against, other_lib), flush=True)
        study["against"] = dict(source=str(args.against),
                                rows=against(_bind(other_lib), args.reps, dev))
    for M, N, K in SHAPES:
        for dname, dtype in DTYPES.items():
            a, b = inputs(M, N, K, dtype, dev)
            want = morton_matmul_ref(a, b)
            plain = _bench.event_ms(lambda: morton_matmul_ref(a, b), args.reps)
            lib = _bench.event_ms(lambda: torch.matmul(a, b), args.reps)
            bound, by = bound_ms(M, N, K, dtype)
            per_sm = ops.blocks_per_sm(dtype)
            for blocks in BLOCKS:
                _, _, _, nm, nn = ops.grid(M, N, K, *blocks)
                case = dict(shape=[M, N, K], dtype=dname, blocks=list(blocks), grid=[nm, nn],
                            blocks_per_sm=per_sm, bound_ms=bound, bound_by=by,
                            plain_ms=plain, library_ms=lib,
                            checks=check_orders(a, b, blocks, want),
                            ms=time_orders(a, b, blocks, args.reps),
                            traffic=traffic(nm, nn, sms * per_sm))
                study["cases"].append(case)
                times = "; ".join(f"{o} {' / '.join(f'{t:.4f}' for t in ts)}"
                                  for o, ts in case["ms"].items())
                print(f"{M} x {N} x {K} {dname} blocks {blocks} (grid {nm} x {nn}): {times} ms; "
                      f"plain {plain:.4f} ms; torch.matmul {lib:.4f} ms; bound {bound:.4f} ms "
                      f"by {by}; max |kernel - plain| {case['checks']['max_abs_err']:.4g}",
                      flush=True)
                for o, t in case["traffic"].items():
                    print(f"  {o}: panel_traffic {t['panel_traffic']}, launch-order LRU "
                          f"{t['launch_lru']}, panels per wave of {sms * per_sm} "
                          f"{t['wave_panels']}, largest start lag "
                          f"{case['checks']['traces'][o]['max_start_lag']}", flush=True)
            del a, b, want
            torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(study, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
