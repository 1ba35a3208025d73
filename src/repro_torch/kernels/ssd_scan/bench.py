"""Time `ssd_scan` on the card at the ssm serving prefill's shape.

    python -m repro_torch.kernels.ssd_scan.bench [--against OTHER.cu]

(with ``src`` on ``PYTHONPATH``, on a machine with a CUDA card and nvcc).
Prints the compiler's register and spill report for ``kernel.cu``, then
the kernel's time by CUDA events (median of 25) at mamba2-370m's prefill
shape: B 32, S 2,048, H 32, P 64, N 128, Q 256, with x, B and C sliced
out of one bf16 projection and dt and A in Mamba-2's published ranges.
With ``--against``, another source with the same C entry point (an
earlier ``kernel.cu``) is built with the same flags and timed in turns
with this one (other, this, this, other), and the largest difference
between the two outputs is printed.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import sys

import torch

from ...configs import get_config
from .. import _bench, _build
from . import ops


def _bind(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).ssd_scan_launch
    fn.argtypes = ops.ARGTYPES
    fn.restype = ctypes.c_int

    def scan(x, dt, A, Bm, Cm, chunk):
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
        state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), state.data_ptr(), Bsz, S, H, P, N, min(chunk, S),
                 *x.stride()[:3], *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
                 int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan launch failed (cudaError {err})")
        return y, state

    return scan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="another ssd_scan kernel source to time in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(_bench.card())
    print("kernel.cu:", _bench.compile_with_report(_build.source_of("ssd_scan"),
                                                   _build.BUILD_DIR / "bench" / "this.so"),
          flush=True)
    cfg = get_config("mamba2-370m")
    B, S = 32, 2048
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    gen = torch.Generator(device=dev).manual_seed(20)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    A = -(1 + 15 * torch.rand((H,), generator=gen, device=dev))
    dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand((B, S, H), generator=gen,
                                                                  device=dev))
    runs = [("kernel.cu", lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q))]
    if args.against:
        lib = _build.BUILD_DIR / "bench" / "other.so"
        print(f"{args.against}:", _bench.compile_with_report(args.against, lib), flush=True)
        other = _bind(lib)
        (y0, s0), (y1, s1) = runs[0][1](), other(x, dt, A, Bm, Cm, Q)
        print(f"max |this - other|: y {float((y0 - y1).abs().max()):.3g} (max |y| "
              f"{float(y0.abs().max()):.3g}), state {float((s0 - s1).abs().max()):.3g}")
        mine = runs[0]
        runs = [(str(args.against), lambda: other(x, dt, A, Bm, Cm, Q)), mine, mine,
                (str(args.against), lambda: other(x, dt, A, Bm, Cm, Q))]
    for name, fn in runs:
        print(f"{name}: {_bench.event_ms(fn):.4f} ms at B {B}, S {S}, H {H}, P {P}, N {N}, "
              f"Q {Q}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
