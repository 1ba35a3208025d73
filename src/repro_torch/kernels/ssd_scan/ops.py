"""SSD scan wrapper: the model's layout in, kernel or plain version.

`ssd_scan` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  x, dt, B and C are read in place through their
strides, so the slices `models.ssm` cuts out of one projection go in
without a copy.  `launches` counts kernel launches, so a run can show that
its path went through the kernel.  `body` says which of ``kernel.cu``'s two
bodies a dtype runs, and `tc_plan` is the host's view of the bf16 body's
launch (``kernel.cu``'s `ssd_scan_tc_plan` reports the same).

On the card the kernel runs inside `SsdScan`, an autograd Function: its
forward is the kernel, and its backward recomputes the scan through the
plain version and differentiates that (`_wrap.plain_grad`).  The JAX
package has no backward kernel either (its training path differentiates
the jnp chunked scan).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import _build, _wrap
from .ref import ssd_scan_ref

NAME = "ssd_scan"
MAX_CHUNK = 256
MAX_WIDTH = 128   # largest head dim P and state size N; both multiples of 8
MAX_GRID = 65535  # heads and batch are the grid's x and y

# the bf16 body (kernel.cu, namespace tc)
TC_ROWS = 128    # output rows a tile, 16 a warp of 8
TC_KEYS = 32     # key rows a stage of the cp.async double buffer


def body(dtype: torch.dtype) -> str:
    """Which body of the kernel a dtype runs: ``mma`` (bf16, mma.sync
    tensor cores, split operands) or ``fma`` (fp32, CUDA cores)."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"no ssd_scan body for {dtype}")


@dataclass(frozen=True)
class TcPlan:
    grid: Tuple[int, int]  # (heads, batch): CUDA's x, y; one head a block
    smem: int           # dynamic shared-memory bytes a block
    blocks_per_sm: int  # blocks an SM the launch bounds ask for
    warps: int          # warps a block, each 16 of a tile's 128 rows


def tc_plan(B: int, H: int, P: int, N: int) -> TcPlan:
    """The bf16 body's launch for these shapes: one block per (head,
    sequence); its shared memory holds a C tile, two stages of B and of x,
    the state as bf16 hi and lo, and cum, dt and w of a chunk (``kernel.cu``
    `tc::plan`)."""
    n16, p16 = -(-N // 16) * 16, -(-P // 16) * 16
    nl, xl = n16 + 8, p16 + 8  # padded rows, bf16
    smem = (2 * TC_ROWS * nl + 2 * 2 * TC_KEYS * nl + 2 * 2 * TC_KEYS * xl
            + 2 * 2 * p16 * nl + 4 * 3 * MAX_CHUNK)
    # two blocks an SM where y's and the state's registers fit 128 a thread
    blocks = 2 if P <= 64 else 1
    return TcPlan((H, B), smem, blocks, TC_ROWS // 16)


# kernel launches since the last reset (read by ocpbench's harness and chip_smoke)
_counts = _wrap.Counts(__name__, "launches")
reset_launches = _counts.reset
__getattr__ = _counts.get

_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, dt, A, B, C, y, state; B, S, H, P, N, Q; the strides of x, dt, B, C;
# dtype; stream
ARGTYPES = [ctypes.c_void_p] * 7 + [_I64] * 6 + [_I64] * 10 + [_I64, ctypes.c_void_p]
# P, N; out (shared memory, blocks an SM by the launch bounds and by the
# occupancy calculator, warps)
PLAN_ARGTYPES = [_I64, _I64, ctypes.POINTER(_I64)]


def kernel_tc_plan(P: int, N: int) -> Tuple[int, int, int, int]:
    """What the built kernel reports for its bf16 body at P and N:
    (shared-memory bytes a block, blocks an SM by its launch bounds, blocks
    an SM by CUDA's occupancy calculator, warps a block)."""
    out = (_I64 * 4)()
    fn = _build.entry(NAME, "ssd_scan_tc_plan", PLAN_ARGTYPES)
    _build.check(fn(P, N, out), "ssd_scan_tc_plan")
    return tuple(out)


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
    _build.launch(_build.entry(NAME, "ssd_scan_launch", ARGTYPES), x.device,
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, S, H, P, N,
                  min(chunk, S), x.stride(0), x.stride(1), x.stride(2),
                  dt.stride(0), dt.stride(1), dt.stride(2), B.stride(0),
                  B.stride(1), C.stride(0), C.stride(1), _DTYPES[x.dtype],
                  what="ssd_scan launch")
    _counts.add("launches")
    return y, state


class SsdScan(torch.autograd.Function):
    """The scan whose forward is ``forward`` (the CUDA kernel; the tests
    pass the plain version to reach the wiring on the CPU) and whose
    backward is autograd's through `ssd_scan_ref`, recomputed from the
    saved x, dt, A, B and C (`_wrap.plain_grad`, in the span
    ``ssd_scan.recompute``).
    x, B and C may be strided views of one tensor (the mixer's conv
    output): they are saved as they are, and autograd adds the three
    gradients into that tensor's.  The final state's cotangent is None
    where the caller drops the state (training)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, forward):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return forward(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        return _wrap.function_grads(ctx, "ssd_scan.recompute", ssd_scan_ref, (dy, dstate),
                                    chunk=ctx.chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = MAX_CHUNK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan over chunks of ``min(chunk, S)`` steps.

    x (B, S, H, P) fp32 or bf16; dt (B, S, H) fp32 (softplus'd steps); A
    (H,) fp32 < 0; B, C (B, S, N) in x's dtype.  Returns y (B, S, H, P)
    fp32 and the final state (B, H, P, N) fp32.  The kernel on the card
    (differentiable through `SsdScan`); the plain version, differentiable
    as it is, for CPU tensors.
    """
    if x.is_cuda:
        return SsdScan.apply(x, dt, A, B, C, chunk, ssd_scan_cuda)
    if x.device.type != "cpu":
        raise ValueError(f"no ssd_scan for device {x.device}")
    return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
