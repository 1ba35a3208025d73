"""Grouped expert GEMM wrapper: kernel on the card, plain version on the CPU.

`moe_gemm` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  ``counts`` stays on the device: the kernel reads
it, so a call makes no host sync.  The wrapper allocates the output and
the kernel's scratch h (E, C, f).  `launches` counts calls of the entry
point (one per `moe_gemm` call: both phases), so a run can show that its
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from .ref import moe_gemm_ref

NAME = "moe_gemm"
BLOCK_ROWS = 64   # the kernel's row tile
MAX_GRID = 65535  # experts and row tiles are the grid's z and y

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
# x, w_gate, w_up, w_down, counts, h, y; E, C, d, f; dtype; stream
ARGTYPES = [ctypes.c_void_p] * 7 + [_I64] * 4 + [_I64, ctypes.c_void_p]


def _entry():
    fn = _build.library(NAME).moe_gemm_launch
    if fn.argtypes is None:  # untyped ctypes would cut pointers to 32 bits
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_gate, w_up, w_down, counts) -> None:
    dev = x.device
    ts = (x, w_gate, w_up, w_down)
    if not (x.is_cuda and all(t.device == dev for t in ts + (counts,))):
        raise ValueError("x, the weights and counts must be on the same CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"x and the weights must all be float32 or all bfloat16, got "
                         f"{[t.dtype for t in ts]}")
    if counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32, got {counts.dtype}")
    if x.dim() != 3 or any(t.dim() != 3 for t in ts) or counts.dim() != 1:
        raise ValueError(f"want x (E,C,d), w_gate and w_up (E,d,f), w_down (E,f,d), "
                         f"counts (E,); got {[tuple(t.shape) for t in ts + (counts,)]}")
    E, C, d = x.shape
    f = w_gate.shape[-1]
    if (tuple(w_gate.shape) != (E, d, f) or tuple(w_up.shape) != (E, d, f)
            or tuple(w_down.shape) != (E, f, d) or tuple(counts.shape) != (E,)):
        raise ValueError(f"x {tuple(x.shape)} does not match w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)} or "
                         f"counts {tuple(counts.shape)}")
    for name, w in (("d", d), ("f", f)):
        if w < 8 or w % 8:
            raise ValueError(f"{name} {w}: want a multiple of 8")
    if C < 1 or E > MAX_GRID or -(-C // BLOCK_ROWS) > MAX_GRID:
        raise ValueError(f"E {E} or C {C}: want 1 to {MAX_GRID} experts and row tiles")
    if not all(t.is_contiguous() for t in ts + (counts,)):
        raise ValueError("x, the weights and counts must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("x and the weights must be 16-byte aligned")


def moe_gemm_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as `moe_gemm_ref`."""
    _check(x, w_gate, w_up, w_down, counts)
    E, C, d = x.shape
    f = w_gate.shape[-1]
    h = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                 counts.data_ptr(), h.data_ptr(), y.data_ptr(), E, C, d, f,
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed (cudaError {err})")
    _count_launch()
    return y


def moe_gemm(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU expert GEMM over a capacity buffer.

    x (E, C, d) fp32 or bf16; w_gate, w_up (E, d, f) and w_down (E, f, d)
    in x's dtype; counts (E,) int32, the tokens dispatched to each expert
    (a count above C means all C rows).  Returns y (E, C, d) in x's dtype:
    ``silu(x Wg) * (x Wu)`` in fp32 rounded to the dtype, times Wd in fp32,
    rows at or past ``counts[e]`` 0.  The kernel on the card; the plain
    version for CPU tensors.
    """
    if x.is_cuda:
        return moe_gemm_cuda(x, w_gate, w_up, w_down, counts)
    if x.device.type != "cpu":
        raise ValueError(f"no moe_gemm for device {x.device}")
    return moe_gemm_ref(x, w_gate, w_up, w_down, counts)
