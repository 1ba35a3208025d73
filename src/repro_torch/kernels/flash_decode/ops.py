"""Flash decode wrapper: one new token against a (B, S, K, D) cache.

`flash_decode` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  The cache is read in place.  `launches` counts
kernel launches (one per call, whether or not the splits are merged by a
second kernel), so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from .ref import as_lens, flash_decode_ref

NAME = "flash_decode"
HEAD_DIMS = (16, 32, 64, 128, 256)

launches = 0  # kernel launches since the last reset (read by chip_smoke)
_count_guard = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_guard:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_guard:
        launches += 1


_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = _build.library(NAME).flash_decode_launch
    if fn.argtypes is None:  # untyped ctypes would cut pointers to 32 bits
        fn.argtypes = ([ctypes.c_void_p] * 8 + [_I64] * 16
                       + [ctypes.c_float, _I64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def n_splits(B: int, K: int, S: int, device: torch.device) -> int:
    """Splits of the kv axis: enough blocks for ~4 per SM, each split at
    least 256 positions long."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-4 * sms // (B * K))
    return max(1, min(want, -(-S // 256)))


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lens: torch.Tensor, *,
                      scale: float) -> torch.Tensor:
    """Launch the CUDA kernel; lens is a (B,) int32 tensor on the card."""
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
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    nsplit = n_splits(B, K, S, dev)
    if nsplit > 1:
        part_o = torch.empty(B * K * nsplit * G * D, dtype=torch.float32, device=dev)
        part_ml = torch.empty(2, B * K * nsplit * G, dtype=torch.float32, device=dev)
        parts = (part_o.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr())
    else:
        parts = (None, None, None)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), *parts, B, S, K, G, D,
                 q.stride(0), q.stride(2), *(k_cache.stride(i) for i in range(3)),
                 *(v_cache.stride(i) for i in range(3)), out.stride(0),
                 out.stride(2), nsplit, scale, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed (cudaError {err})")
    _count_launch()
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
