"""Flash decode wrapper: one new token against a (B, S, K, D) cache.

`flash_decode` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  The cache is read in place.  `launches` counts
kernel launches (one per call: the splits of the kv axis are merged inside
the launch), so a run can show that its path went through the kernel.
`split_plan` is the host's plan of a launch: how many splits, how long,
and the kernel's shared-memory ring for the head dim and dtype
(``kernel.cu``'s `flash_decode_stages` reports the same ring).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import _build, _wrap
from .ref import as_lens, flash_decode_ref

NAME = "flash_decode"
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GRID = 65535  # kv heads and batch are the grid's y and z

# kernel launches since the last reset (read by ocpbench's harness and chip_smoke)
_counts = _wrap.Counts(__name__, "launches")
reset_launches = _counts.reset
__getattr__ = _counts.get

_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, lens, out, part_o, part_m, part_l; B, S, K, G, D, 10 strides,
# nsplit; scale; dtype; stream
ARGTYPES = [ctypes.c_void_p] * 8 + [_I64] * 16 + [ctypes.c_float, _I64, ctypes.c_void_p]
# D, G, dtype; out (positions a stage, stages, shared memory)
STAGES_ARGTYPES = [_I64, _I64, _I64, ctypes.POINTER(_I64)]


def launch_args(q, k_cache, v_cache, lens, out, nsplit: int, scale: float, parts=(None,) * 3):
    """The entry point's arguments but the stream.  ``parts`` (part_o,
    part_m, part_l pointers) is read only by earlier sources, which merged
    the splits in a second kernel (their benches pass scratch here)."""
    B, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    return (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            out.data_ptr(), *parts, B, S, K, H // K, D, q.stride(0), q.stride(2),
            *(k_cache.stride(i) for i in range(3)), *(v_cache.stride(i) for i in range(3)),
            out.stride(0), out.stride(2), nsplit, scale, _DTYPES[q.dtype])


# the kernel's ring (kernel.cu `Layout`): 3 stages of 16 KB of K and V,
# 128 threads a block, LP lanes a cache row
STAGES = 3
STAGE_BYTES = 16384
THREADS = 128
MAX_SPLITS = 8          # the splits of one (kv head, sequence) are one cluster
MIN_SPLIT = 256         # positions of the cache a split, at least
BLOCKS_PER_SM = 2       # the split plan's aim (the split sweep of flash_decode/bench.py)


def stage_plan(D: int, elem: int, G: int) -> Tuple[int, int, int]:
    """(positions a stage, stages, dynamic shared memory of a block in
    bytes) of the kernel's instance for head dim D, element size ``elem``
    and G query heads per kv head."""
    vec = 16 // elem
    lp = min(D // vec, 32)
    groups = 4 * (32 // lp)
    row = D * elem
    tp = min(128, max(groups, STAGE_BYTES // (2 * row)))
    gm = 2 if G <= 2 else G if G <= 4 else 8  # query heads a pass
    ring = STAGES * 2 * tp * row
    merge_and_partial = (2 * groups * gm + groups * gm * D + 2 * gm + gm * D) * 4
    return tp, STAGES, max(ring, merge_and_partial)


@dataclass(frozen=True)
class SplitPlan:
    nsplit: int  # splits of the kv axis, one block each, one cluster a (kv head, sequence)
    chunk: int   # positions a split
    tp: int      # positions a stage of the ring
    stages: int
    smem: int    # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, K: int, S: int, G: int, D: int, elem: int, sms: int) -> SplitPlan:
    """The split count whose blocks (B K nsplit) come nearest to
    `BLOCKS_PER_SM` an SM, at most `MAX_SPLITS` and at most one per
    `MIN_SPLIT` positions of the cache."""
    tp, stages, smem = stage_plan(D, elem, G)
    want = int(BLOCKS_PER_SM * sms / max(B * K, 1) + 0.5)
    nsplit = max(1, min(MAX_SPLITS, want, -(-S // MIN_SPLIT)))
    return SplitPlan(nsplit, -(-S // nsplit), tp, stages, smem)


def plan_for(q: torch.Tensor, k_cache: torch.Tensor) -> SplitPlan:
    """`split_plan` for a call with these tensors on their card."""
    B, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return split_plan(B, K, S, H // K, D, q.element_size(), sms)


def kernel_stages(D: int, G: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """What the built kernel reports for (D, G, dtype): (positions a stage,
    stages, shared memory of a block), to hold `stage_plan` to."""
    out = (_I64 * 3)()
    fn = _build.entry(NAME, "flash_decode_stages", STAGES_ARGTYPES)
    _build.check(fn(D, G, _DTYPES[dtype], out), "flash_decode_stages")
    return tuple(out)


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lens: torch.Tensor, *,
                      scale: float, nsplit: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel; lens is a (B,) int32 tensor on the card.
    ``nsplit`` (1 to `MAX_SPLITS`) overrides the plan's split count, for
    checks of the in-launch merge at any cluster size."""
    dev = q.device
    if not (q.is_cuda and k_cache.device == dev and v_cache.device == dev
            and lens.device == dev):
        raise ValueError("q, caches and lens must be on the same CUDA device")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q and caches must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q (B,1,H,D) and caches (B,S,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    G = H // K
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or not lens.is_contiguous():
        raise ValueError("lens must be a contiguous (B,) int32 tensor")
    vec = 16 // q.element_size()  # the kernel reads cache rows as 16-byte vectors
    for c in (k_cache, v_cache):
        if c.stride(3) != 1 or c.data_ptr() % 16 or any(
                c.stride(i) % vec for i in range(3)):
            raise ValueError("cache rows must be contiguous and 16-byte aligned")
    if q.stride(3) != 1:
        raise ValueError("the head_dim axis of q must be contiguous")
    if B > MAX_GRID or K > MAX_GRID:
        raise ValueError(f"batch {B} or kv heads {K} above {MAX_GRID}")
    if nsplit is None:
        nsplit = plan_for(q, k_cache).nsplit
    elif not 1 <= nsplit <= MAX_SPLITS:
        raise ValueError(f"nsplit {nsplit}: want 1 to {MAX_SPLITS}")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    _build.launch(_build.entry(NAME, "flash_decode_launch", ARGTYPES), dev,
                  *launch_args(q, k_cache, v_cache, lens, out, nsplit, scale),
                  what="flash_decode launch")
    _counts.add("launches")
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len, *, scale: float) -> torch.Tensor:
    """q (B, 1, H, D); caches (B, S, K, D); cache_len an int or a (B,)
    tensor.  Positions >= cache_len are masked (cache_len >= 1).  Returns
    (B, 1, H, D) in q's dtype: the kernel on the card, the plain version for
    CPU tensors."""
    if q.is_cuda:
        lens = as_lens(cache_len, q.shape[0], q.device)
        return flash_decode_cuda(q, k_cache, v_cache, lens, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_decode for device {q.device}")
    return flash_decode_ref(q, k_cache, v_cache, cache_len, scale=scale)
