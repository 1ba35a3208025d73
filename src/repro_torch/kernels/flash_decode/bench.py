"""Time `flash_decode` on the card at the serving paths' decode shapes.

    python -m repro_torch.kernels.flash_decode.bench [--against OLD.cu] [--reps N] [--sweep]

(with ``src`` on ``PYTHONPATH``, on a machine with a CUDA card and nvcc).
Prints the card, the compiler's register and spill report for
``kernel.cu``, then, in bf16, at the dense decode (smollm-135m: B 32, a
cache of 2,176 positions with lengths 2,048-2,175, 9 query heads over 3 kv
heads, D 64) and the MoE decode (granite-moe-1b-a400m: 16 over 8, D 64):
the kernel's time by CUDA events (median of ``--reps``) at the splits
`split_plan` gives, beside the bound (each live cache row read once at
the memory rate), the plain version (``ref.py``) and
``scaled_dot_product_attention`` with the length mask (a yardstick the
port never calls), and the largest difference from the plain version.
With ``--against``, another source with the same C entry point (an
earlier ``kernel.cu``, which merged its splits in a second kernel through
fp32 scratch, here allocated for it, at its own split rule) is built with
the same flags and timed in turns with this one (other, this, this,
other), with the largest difference between the two outputs.  With
``--sweep``, this kernel is also timed at every split count from 1 to 8.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys

import torch
import torch.nn.functional as F

from ...device import h100_peaks
from .. import _bench, _build
from . import ops
from .ref import flash_decode_ref

HBM_BYTES_PER_S = h100_peaks().hbm_bytes_per_s  # H100 SXM
SHAPES = {"dense decode (smollm-135m)": (32, 2176, 9, 3, 64),
          "MoE decode (granite-moe-1b-a400m)": (32, 2176, 16, 8, 64)}
PROMPT = 2048  # the serving paths' prompt: lengths 2,048-2,175 over the run's 128 steps


def _bind(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).flash_decode_launch
    fn.argtypes = ops.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def run(fn, q, kc, vc, lens, scale, nsplit, parts=(None,) * 3):
    """One call of entry point ``fn`` at ``nsplit`` splits."""
    out = torch.empty_like(q)
    err = fn(*ops.launch_args(q, kc, vc, lens, out, nsplit, scale, parts),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed (cudaError {err})")
    return out


def old_splits(B: int, K: int, S: int, sms: int) -> int:
    """The split rule of the sources that merged in a second kernel: ~4
    blocks an SM, each split at least 256 positions long."""
    return max(1, min(-(-4 * sms // (B * K)), -(-S // 256)))


def bound_ms(lens: torch.Tensor, q: torch.Tensor, K: int, D: int) -> float:
    """Each live cache row of K and V read once, q read and out written
    once, lens read once, at the memory rate (ms)."""
    e = q.element_size()
    return (2 * e * int(lens.sum()) * K * D + 2 * e * q.numel() + 4 * lens.numel()) \
        / HBM_BYTES_PER_S * 1e3


def inputs(B: int, S: int, H: int, K: int, D: int, dev, seed: int = 17):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, kc, vc = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                 for s in ((B, 1, H, D), (B, S, K, D), (B, S, K, D)))
    lens = torch.randint(PROMPT, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    return q, kc, vc, lens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="another flash_decode kernel source to time in turns with this one")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per median")
    ap.add_argument("--sweep", action="store_true", help="also time 1 to 8 splits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _bench.card()
    print(card)
    lib = _build.BUILD_DIR / "bench" / "fd.so"
    print("kernel.cu:", _bench.compile_with_report(_build.source_of(ops.NAME), lib), flush=True)
    this = _bind(lib)
    other = None
    if args.against:
        other_lib = _build.BUILD_DIR / "bench" / "fd-other.so"
        print(f"{args.against}:", _bench.compile_with_report(args.against, other_lib),
              flush=True)
        other = _bind(other_lib)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (B, S, H, K, D) in SHAPES.items():
        q, kc, vc, lens = inputs(B, S, H, K, D, dev)
        scale = D ** -0.5
        plan = ops.plan_for(q, kc)
        mine = ("kernel.cu", lambda: run(this, q, kc, vc, lens, scale, plan.nsplit))
        got, want = mine[1](), flash_decode_ref(q, kc, vc, lens, scale=scale)
        print(f"{label}: {plan}; max |kernel - plain| "
              f"{float((got.float() - want.float()).abs().max()):.4g} "
              f"(mean |out| {float(want.float().abs().mean()):.4g})", flush=True)
        runs = [mine]
        if other is not None:
            n_old = old_splits(B, K, S, sms)
            part_o = torch.empty(B * K * n_old * (H // K) * D, dtype=torch.float32, device=dev)
            part_ml = torch.empty(2, B * K * n_old * (H // K), dtype=torch.float32, device=dev)
            parts = (part_o.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr())
            theirs = (f"{args.against} ({n_old} splits)",
                      lambda: run(other, q, kc, vc, lens, scale, n_old, parts))
            print(f"{label}: max |this - other| "
                  f"{float((got.float() - theirs[1]().float()).abs().max()):.4g}")
            runs = [theirs, mine, mine, theirs]
        bound = bound_ms(lens, q, K, D)
        for name, fn in runs:
            ms = _bench.event_ms(fn, args.reps)
            print(f"{label} {name}: {ms:.5f} ms at B {B}, S {S}, H {H}, K {K}, D {D}; bound "
                  f"{bound:.5f} ms by bytes ({100 * bound / ms:.2f}%)", flush=True)
        if args.sweep:
            for n in range(1, ops.MAX_SPLITS + 1):
                ms = _bench.event_ms(lambda: run(this, q, kc, vc, lens, scale, n), args.reps)
                print(f"{label} kernel.cu at {n} splits: {ms:.5f} ms", flush=True)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        plain = _bench.event_ms(lambda: flash_decode_ref(q, kc, vc, lens, scale=scale),
                                max(3, args.reps // 5))
        lib_ms = _bench.event_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
            scale=scale, enable_gqa=True), args.reps)
        print(f"{label}: plain {plain:.5f} ms; scaled_dot_product_attention {lib_ms:.5f} ms",
              flush=True)
        del q, kc, vc, got, want
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
