"""SSD scan wrapper: the model's layout in, kernel or plain version.

`ssd_scan` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  x, dt, B and C are read in place through their
strides, so the slices `models.ssm` cuts out of one projection go in
without a copy.  `launches` counts kernel launches, so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from .. import _build
from .ref import ssd_scan_ref

NAME = "ssd_scan"
MAX_CHUNK = 256
MAX_WIDTH = 128   # largest head dim P and state size N; both multiples of 8
MAX_GRID = 65535  # heads and batch are the grid's x and y

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
# x, dt, A, B, C, y, state; B, S, H, P, N, Q; the strides of x, dt, B, C;
# dtype; stream
ARGTYPES = [ctypes.c_void_p] * 7 + [_I64] * 6 + [_I64] * 10 + [_I64, ctypes.c_void_p]


def _entry():
    fn = _build.library(NAME).ssd_scan_launch
    if fn.argtypes is None:  # untyped ctypes would cut pointers to 32 bits
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C, chunk: int) -> None:
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A, B, C))):
        raise ValueError("x, dt, A, B and C must be on the same CUDA device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B and C must all be float32 or all bfloat16, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.shape != B.shape:
        raise ValueError(f"want x (B,S,H,P), dt (B,S,H), A (H,), B and C (B,S,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(B.shape[:2]) != (Bsz, S):
        raise ValueError(f"x {tuple(x.shape)} does not match dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)} or B {tuple(B.shape)}")
    for name, w in (("head dim P", P), ("state size N", N)):
        if w % 8 or not 8 <= w <= MAX_WIDTH:
            raise ValueError(f"{name} {w}: want a multiple of 8 up to {MAX_WIDTH}")
    if S < 1 or not 1 <= min(chunk, S) <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} over {S} steps: want 1 to {MAX_CHUNK} "
                         "steps per chunk")
    if Bsz > MAX_GRID or H > MAX_GRID:
        raise ValueError(f"batch {Bsz} or heads {H} above {MAX_GRID}")
    if any(t.stride(-1) != 1 for t in (x, B, C)) or A.stride(0) != 1:
        raise ValueError("the last axis of x, B and C, and A, must be contiguous")
    if any(t.stride(i) < 0 for t in (x, dt, B, C) for i in range(t.dim())):
        raise ValueError("negative strides are not taken")
    if any(t.data_ptr() % t.element_size() for t in (x, dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must be aligned to their element size")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int = MAX_CHUNK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; same contract as `ssd_scan_ref`."""
    _check(x, dt, A, B, C, chunk)
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, S, H, P, N,
                 min(chunk, S), x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2), B.stride(0),
                 B.stride(1), C.stride(0), C.stride(1), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed (cudaError {err})")
    _count_launch()
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = MAX_CHUNK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan over chunks of ``min(chunk, S)`` steps.

    x (B, S, H, P) fp32 or bf16; dt (B, S, H) fp32 (softplus'd steps); A
    (H,) fp32 < 0; B, C (B, S, N) in x's dtype.  Returns y (B, S, H, P)
    fp32 and the final state (B, H, P, N) fp32.  The kernel on the card;
    the plain version for CPU tensors.
    """
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cpu":
        raise ValueError(f"no ssd_scan for device {x.device}")
    return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
