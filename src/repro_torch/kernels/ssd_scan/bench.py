"""Time `ssd_scan` on the card at the ssm serving prefill's shape.

    python -m repro_torch.kernels.ssd_scan.bench [--against OTHER.cu ...]

(with ``src`` on ``PYTHONPATH``, on a machine with a CUDA card and nvcc).
Prints the compiler's register and spill report for ``kernel.cu`` and the
count of tensor-core (``HMMA``) and fp32 FMA instructions in its SASS,
then the kernel's time by CUDA events (median of 25) at mamba2-370m's
prefill shape: B 32, S 2,048, H 32, P 64, N 128, Q 256, with x, B and C
sliced out of one bf16 projection and dt and A in Mamba-2's published
ranges.  Each ``--against`` names another source with the same C entry
point (an earlier ``kernel.cu``, or a variant); each is built with the
same flags, the largest difference between its outputs and this one's
is printed (bf16 at the prefill shape, and fp32 at B 2, S 1,000, H 4),
and all are timed in turns (others, this, this, others reversed).
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
    ap.add_argument("--against", type=pathlib.Path, action="append", default=[],
                    help="another ssd_scan kernel source to time in turns with this one "
                         "(may be given more than once)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(_bench.card())
    lib = _build.BUILD_DIR / "bench" / "this.so"
    print("kernel.cu:", _bench.compile_with_report(_build.source_of("ssd_scan"), lib),
          flush=True)
    print(f"kernel.cu SASS: {_bench.sass_counts(lib, ('HMMA', 'FFMA'))}", flush=True)
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
    small = (x[:2, :1000, :4].float(), dt[:2, :1000, :4], A[:4], Bm[:2, :1000].float(),
             Cm[:2, :1000].float())  # the fp32 body
    this = _bind(lib)
    mine = ("kernel.cu", lambda: this(x, dt, A, Bm, Cm, Q))
    others = []
    for i, src in enumerate(args.against):
        other_lib = _build.BUILD_DIR / "bench" / f"other{i}.so"
        print(f"{src}:", _bench.compile_with_report(src, other_lib), flush=True)
        print(f"{src} SASS: {_bench.sass_counts(other_lib, ('HMMA', 'FFMA'))}", flush=True)
        other = _bind(other_lib)
        (y0, s0), (y1, s1) = mine[1](), other(x, dt, A, Bm, Cm, Q)
        (f0, g0), (f1, g1) = this(*small, 256), other(*small, 256)
        print(f"max |this - {src}|: bf16 y {float((y0 - y1).abs().max()):.3g} (max |y| "
              f"{float(y0.abs().max()):.3g}), state {float((s0 - s1).abs().max()):.3g} (max "
              f"|state| {float(s0.abs().max()):.3g}); fp32 y {float((f0 - f1).abs().max()):.3g}"
              f", state {float((g0 - g1).abs().max()):.3g}", flush=True)
        others.append((str(src), lambda o=other: o(x, dt, A, Bm, Cm, Q)))
    for name, fn in others + [mine, mine] + others[::-1]:
        print(f"{name}: {_bench.event_ms(fn):.4f} ms at B {B}, S {S}, H {H}, P {P}, N {N}, "
              f"Q {Q}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
