"""Time `moe_gemm` on the card at the MoE serving path's shapes.

    python -m repro_torch.kernels.moe_gemm.bench [--against OTHER.cu] [--backward]

(with ``src`` on ``PYTHONPATH``, on a machine with a CUDA card and nvcc).
Prints the compiler's register and spill report for ``kernel.cu`` and how
many ``HGMMA`` (wgmma), ``HMMA`` and ``FFMA`` instructions its SASS holds
(the bf16 body runs on wgmma, the fp32 body on FFMA), then
the kernel's time by CUDA events (median of 25) at granite-moe-1b-a400m's
expert shapes in bf16: the prefill's capacity buffer (32 prompts of 2,048
tokens: E 32, C 20,480, d 1,024, f 512) and a decode step's (32 tokens: C
10), with counts from a uniform top-8 routing of that many tokens and the
weights at the model's init scale.  Each time stands beside its bound:
operations 2 * 3 * d * f * sum(min(count, C)) at the bf16 tensor rate,
or bytes (live x rows, all y rows, the weights once) at the memory rate.
With ``--against``, another source with the same C entry point (an
earlier ``kernel.cu``) is built with the same flags and timed in turns
with this one (other, this, this, other), each also by the host's time to
enqueue a decode-step call through the same thin binding (the weights'
tensor maps are cached, so this is what a decode step pays), and the
largest difference between the two outputs is printed.  The wrapper
`ops.moe_gemm` is timed on the host too.

With ``--backward``, the backward instead (`ops.moe_gemm_grad_cuda`, bf16)
at a training microbatch's buffer: 8 sequences of 2,048 tokens routed at
capacity factor 4.0 (C 16,384, a quarter of the rows live) and at 1.25,
beside the plain recompute that the fp32 route runs (autograd through
`moe_gemm_ref` over every row in fp32) and the gradient's operations
bound: the 8 products of 2 * d * f * live rows it needs (g and u
recomputed, dh, dx's two, dWg, dWu and dWd) at the bf16 tensor rate.  The
kernel runs 12, its hi + lo split doubling the depth of dx's two and of
dWg and dWu.  Each gradient's difference from `moe_gemm_grad_ref` on the
same tensors is printed, in norm and at its largest, relative to the
reference's.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys

import torch

from ...configs import get_config
from ...models.moe import capacity
from .. import _bench, _build
from . import ops, ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12


def _bind(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).moe_gemm_launch
    fn.argtypes = ops.ARGTYPES
    fn.restype = ctypes.c_int

    def gemm(x, wg, wu, wd, counts):
        E, C, d = x.shape
        f = wg.shape[-1]
        h = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
        y = torch.empty_like(x)
        err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), counts.data_ptr(),
                 h.data_ptr(), y.data_ptr(), E, C, d, f, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"moe_gemm launch failed (cudaError {err})")
        return y

    return gemm


def inputs(tokens: int, dev, seed: int = 21, capacity_factor=None):
    """The expert weights (init scale 0.02), a capacity buffer for
    ``tokens`` tokens routed top-k uniformly, and its counts."""
    cfg = get_config("granite-moe-1b-a400m")
    if capacity_factor is not None:
        cfg = cfg.scaled(capacity_factor=capacity_factor)
    E, k, d, f = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    C = capacity(cfg, tokens)
    gen = torch.Generator(device=dev).manual_seed(seed)
    picks = torch.rand((tokens, E), generator=gen, device=dev).topk(k, dim=-1).indices
    counts = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
        0, picks.reshape(-1), torch.ones(tokens * k, dtype=torch.int32, device=dev))
    live = torch.arange(C, device=dev)[None, :] < counts[:, None]
    x = (torch.randn((E, C, d), generator=gen, device=dev) * live[..., None]).bfloat16()
    w = [(0.02 * torch.randn(s, generator=gen, device=dev)).bfloat16()
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return x, *w, counts


def bound_ms(x, counts, f: int) -> tuple:
    """(bound in ms, "operations" or "bytes") for one call on these inputs."""
    E, C, d = x.shape
    rows = int(counts.clamp(0, C).sum())
    ops_ = 2 * 3 * d * f * rows
    bytes_ = x.element_size() * (rows * d + E * C * d + 3 * E * d * f)
    t_ops, t_bytes = ops_ / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


GRAD_PRODUCTS = 8  # each 2 * d * f * live rows; see the module's docstring


def gap(got: torch.Tensor, want: torch.Tensor) -> str:
    """|got - want| relative to |want|, in norm and at the largest."""
    g, w = got.float(), want.float()
    return (f"{float((g - w).norm() / w.norm()):.3g} in norm, "
            f"{float((g - w).abs().max() / w.abs().max()):.3g} at most")


def backward(dev) -> None:
    """The ``--backward`` report."""
    for cf in (4.0, 1.25):
        x, wg, wu, wd, counts = inputs(8 * 2048, dev, capacity_factor=cf)
        E, C, d = x.shape
        f = wg.shape[-1]
        gen = torch.Generator(device=dev).manual_seed(22)
        dy = (torch.randn(x.shape, generator=gen, device=dev) * 0.02).bfloat16()
        rows = int(counts.clamp(0, C).sum())
        bound = GRAD_PRODUCTS * 2 * d * f * rows / BF16_FLOPS * 1e3
        args = (x, wg, wu, wd, counts, dy)
        got = ops.moe_gemm_grad_cuda(*args)
        want = ref.moe_gemm_grad_ref(*args)
        print(f"backward cf {cf}, from moe_gemm_grad_ref: " + "; ".join(
            f"{n} {gap(g, w)}" for n, g, w in zip(("dx", "dWg", "dWu", "dWd"), got, want)),
            flush=True)
        del got, want
        need = (True,) * 4
        for name, fn in (("kernel", lambda: ops.moe_gemm_grad_cuda(*args)),
                         ("plain recompute", lambda: ops._plain_grad(
                             [x, wg, wu, wd], counts, dy, need))):
            ms = _bench.event_ms(fn, reps=5 if name != "kernel" else 25)
            print(f"backward cf {cf} {name}: {ms:.4f} ms at E {E}, C {C}, d {d}, f {f}, "
                  f"{rows} live rows; bound {bound:.4f} ms by operations "
                  f"({100 * bound / ms:.2f}%)", flush=True)
        del x, wg, wu, wd, counts, dy, args
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="another moe_gemm kernel source to time in turns with this one")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernel beside the plain recompute instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(_bench.card())
    lib = _build.BUILD_DIR / "bench" / "this.so"
    print("kernel.cu:", _bench.compile_with_report(_build.source_of("moe_gemm"), lib),
          flush=True)
    print(f"kernel.cu SASS: {_bench.sass_counts(lib, ('HGMMA', 'HMMA', 'FFMA'))}", flush=True)
    if args.backward:
        backward(dev)
        print(_bench.card())
        return 0
    other = None
    if args.against:
        other_lib = _build.BUILD_DIR / "bench" / "other.so"
        print(f"{args.against}:", _bench.compile_with_report(args.against, other_lib),
              flush=True)
        other = _bind(other_lib)
    this = _bind(lib)
    for label, tokens in (("prefill", 32 * 2048), ("decode", 32)):
        a = inputs(tokens, dev)
        E, C, d = a[0].shape
        bound, by = bound_ms(a[0], a[-1], a[1].shape[-1])
        runs = [("kernel.cu", lambda: this(*a))]
        if other is not None:
            y0, y1 = runs[0][1](), other(*a)
            print(f"{label}: max |this - other| {float((y0 - y1).float().abs().max()):.3g} "
                  f"(max |y| {float(y0.float().abs().max()):.3g})")
            mine = runs[0]
            runs = [(str(args.against), lambda: other(*a)), mine, mine,
                    (str(args.against), lambda: other(*a))]
        decode = label == "decode"
        for name, fn in runs:
            ms = _bench.event_ms(fn)
            host = f"; host {_bench.host_us(fn):.1f} us a call" if decode else ""
            print(f"{label} {name}: {ms:.4f} ms at E {E}, C {C}, d {d}, f {a[1].shape[-1]}, "
                  f"{int(a[-1].clamp(0, C).sum())} live rows; bound {bound:.4f} ms by {by} "
                  f"({100 * bound / ms:.2f}%){host}", flush=True)
        if decode:
            print(f"{label} ops.moe_gemm: host {_bench.host_us(lambda: ops.moe_gemm(*a)):.1f} "
                  f"us a call", flush=True)
        del a
        torch.cuda.empty_cache()
    print(_bench.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
