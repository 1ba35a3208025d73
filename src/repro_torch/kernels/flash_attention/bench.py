"""Time `flash_attention` on the card at the serving prefills' shapes.

    python -m repro_torch.kernels.flash_attention.bench [--against OLD.cu] [--reps N]
                                                        [--backward]

(with ``src`` on ``PYTHONPATH``, on a machine with a CUDA card and nvcc).
Prints the card, the compiler's register and spill report for
``kernel.cu`` and how many ``HMMA`` (mma.sync) instructions its SASS
holds, then, in bf16 and causal, at the dense prefill (smollm-135m: B 32,
S 2,048, 9 query heads over 3 kv heads, D 64) and the MoE prefill
(granite-moe-1b-a400m: 16 over 8, D 64): the kernel's time by CUDA events
(median of ``--reps``) beside the bound (4 D operations per live (query
head, key) pair at the bf16 tensor rate, or q, k, v and out once at the
memory rate, whichever is longer), the plain version (``ref.py``) and
``scaled_dot_product_attention`` (a yardstick the port never calls), and
the largest difference from the plain version.  With ``--against``,
another source with the same C entry point (an earlier ``kernel.cu``) is
built with the same flags and timed in turns with this one (other, this,
this, other), with the largest difference between the two outputs.

With ``--backward``, the gradient instead (`ops.flash_attention_grad_cuda`,
bf16, causal) at a train-2k microbatch (granite-moe-1b-a400m: 8 x 2,048,
16 over 8 heads, D 64) and at arctic-480b's heads (2 x 2,048, 56 over 8,
D 128): its time beside its bound (10 D operations per live (query head,
key) pair at the bf16 tensor rate, or q, k, v, out, dO, dq, dk, dv and
the logsumexp once at the memory rate), the plain recompute the other
shapes take (autograd through ``ref.py``, from q, k and v) and
``scaled_dot_product_attention``'s backward (a yardstick the port never
calls), with each gradient's difference from `flash_attention_grad_ref`
and the twin's and the kernel's from the fp64 gradient, relative to its
norm.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys

import torch
import torch.nn.functional as F

from .. import _bench, _build
from . import ops
from .ref import (flash_attention_grad_f64, flash_attention_grad_ref, flash_attention_ref,
                  grad_gaps)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12
SHAPES = {"dense prefill (smollm-135m)": (32, 2048, 9, 3, 64),
          "MoE prefill (granite-moe-1b-a400m)": (32, 2048, 16, 8, 64)}
GRAD_SHAPES = {"train-2k microbatch (granite-moe-1b-a400m)": (8, 2048, 16, 8, 64),
               "arctic-480b heads": (2, 2048, 56, 8, 128)}


def _bind(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    fn.argtypes = ops.ARGTYPES
    fn.restype = ctypes.c_int

    def attention(q, k, v, scale):
        out = torch.empty_like(q)
        err = fn(*ops.launch_args(q, k, v, out, causal=True, scale=scale, window=None),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed (cudaError {err})")
        return out

    return attention


def bound_ms(B: int, S: int, H: int, K: int, D: int) -> tuple:
    """(bound in ms, "operations" or "bytes") of a causal bf16 prefill."""
    ops_ = 4 * B * H * D * (S * (S + 1) // 2)
    bytes_ = 2 * B * S * D * (2 * H + 2 * K)
    t_ops, t_bytes = ops_ / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def grad_bound_ms(B: int, S: int, H: int, K: int, D: int) -> tuple:
    """(bound in ms, "operations" or "bytes") of a causal bf16 gradient."""
    ops_ = 10 * B * H * D * (S * (S + 1) // 2)
    bytes_ = 2 * (4 * B * S * H * D + 4 * B * S * K * D) + 4 * B * H * S
    t_ops, t_bytes = ops_ / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def backward(dev, reps: int) -> None:
    """The ``--backward`` report."""
    for label, (B, S, H, K, D) in GRAD_SHAPES.items():
        q, k, v = inputs(B, S, H, K, D, dev)
        gen = torch.Generator(device=dev).manual_seed(33)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
        attn = dict(causal=True, scale=D ** -0.5)
        out, lse = ops.flash_attention_cuda(q, k, v, lse=True, **attn)
        args = (q, k, v, out, lse, dout)
        got = ops.flash_attention_grad_cuda(*args, **attn)
        want = flash_attention_grad_ref(*args, **attn)
        exact = flash_attention_grad_f64(q, k, v, dout, **attn)
        print(f"{label} backward: " + "; ".join(
            f"{n} {r['rel_norm']:.3g} from the twin in norm, {r['max_share']:.3g} at most; "
            f"from fp64 kernel {r['kernel_vs_f64']:.4g}, twin {r['twin_vs_f64']:.4g}"
            for n, r in grad_gaps(got, want, exact).items()), flush=True)
        del got, want, exact
        torch.cuda.empty_cache()
        bound, by = grad_bound_ms(B, S, H, K, D)
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in qkv), is_causal=True,
                                              scale=attn["scale"], enable_gqa=True)
        runs = (("kernel", lambda: ops.flash_attention_grad_cuda(*args, **attn), reps),
                ("plain recompute", lambda: torch.autograd.grad(
                    flash_attention_ref(*qkv, **attn), qkv, dout), max(3, reps // 5)),
                ("scaled_dot_product_attention backward", lambda: torch.autograd.grad(
                    sdpa, qkv, dout.transpose(1, 2), retain_graph=True), reps))
        for name, fn, n in runs:
            ms = _bench.event_ms(fn, n)
            print(f"{label} {name}: {ms:.4f} ms at B {B}, S {S}, H {H}, K {K}, D {D}; bound "
                  f"{bound:.4f} ms by {by} ({100 * bound / ms:.2f}%)", flush=True)
            torch.cuda.empty_cache()
        del q, k, v, dout, out, lse, args, qkv, sdpa
        torch.cuda.empty_cache()


def inputs(B: int, S: int, H: int, K: int, D: int, dev, seed: int = 16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="another flash_attention kernel source to time in turns with this one")
    ap.add_argument("--reps", type=int, default=25, help="timed calls per median")
    ap.add_argument("--backward", action="store_true",
                    help="time the gradient kernels beside the plain recompute instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _bench.card()
    print(card)
    lib = _build.BUILD_DIR / "bench" / "fa.so"
    print("kernel.cu:", _bench.compile_with_report(_build.source_of(ops.NAME), lib), flush=True)
    print(f"kernel.cu SASS: {_bench.sass_counts(lib, ('HMMA', 'HGMMA', 'FFMA'))}", flush=True)
    if args.backward:
        backward(dev, args.reps)
        print(card)
        return 0
    other = None
    if args.against:
        other_lib = _build.BUILD_DIR / "bench" / "fa-other.so"
        print(f"{args.against}:", _bench.compile_with_report(args.against, other_lib),
              flush=True)
        other = _bind(other_lib)
    for label, (B, S, H, K, D) in SHAPES.items():
        q, k, v = inputs(B, S, H, K, D, dev)
        scale = D ** -0.5
        mine = ("kernel.cu", lambda: ops.flash_attention(q, k, v, causal=True, scale=scale))
        got = mine[1]()
        want = torch.cat([flash_attention_ref(q[i:i + 8], k[i:i + 8], v[i:i + 8], causal=True,
                                              scale=scale) for i in range(0, B, 8)])
        print(f"{label}: max |kernel - plain| {float((got.float() - want.float()).abs().max()):.4g}"
              f" (mean |out| {float(want.float().abs().mean()):.4g})", flush=True)
        del want
        runs = [mine]
        if other is not None:
            print(f"{label}: max |this - other| "
                  f"{float((got.float() - other(q, k, v, scale).float()).abs().max()):.4g}")
            theirs = (str(args.against), lambda: other(q, k, v, scale))
            runs = [theirs, mine, mine, theirs]
        bound, by = bound_ms(B, S, H, K, D)
        for name, fn in runs:
            ms = _bench.event_ms(fn, args.reps)
            print(f"{label} {name}: {ms:.4f} ms at B {B}, S {S}, H {H}, K {K}, D {D}; bound "
                  f"{bound:.4f} ms by {by} ({100 * bound / ms:.2f}%)", flush=True)
        plain = _bench.event_ms(lambda: flash_attention_ref(q, k, v, causal=True, scale=scale),
                                max(3, args.reps // 5))
        lib_ms = _bench.event_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            scale=scale, enable_gqa=True), args.reps)
        print(f"{label}: plain {plain:.4f} ms; scaled_dot_product_attention {lib_ms:.4f} ms",
              flush=True)
        del q, k, v, got
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
