"""Grouped expert GEMM wrapper: kernel on the card, plain version on the CPU.

`moe_gemm` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  ``counts`` stays on the device: the kernel reads
it, so a call makes no host sync.  The wrapper allocates the output and
the kernel's scratch h (E, C, f).  `launches` counts calls of the entry
point (one per `moe_gemm` call: both phases), so a run can show that its
path went through the kernel.  `grid_plan` is the host's view of the
blocks each phase launches (bf16 runs the tensor-core body, fp32 the FMA
body; ``kernel.cu``'s `moe_gemm_tiles` reports the same tiles).

On the card the kernel runs inside `MoeGemm`, an autograd Function: its
forward is the kernel, and its backward recomputes the product through
the plain version and differentiates that.  The JAX package has no
backward kernel either (its MoE differentiates three einsums).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Tuple

import torch
from torch.profiler import record_function

from .. import _build
from .ref import moe_gemm_ref

NAME = "moe_gemm"
MAX_GRID = 65535  # experts and row tiles are the grid's z and y
# (rows, phase-1 columns of f, phase-2 columns of d) a block, by body
FMA_TILES = (64, 64, 128)
TC_TILES = (128, 128, 256)  # phase 2 takes 128 columns when d <= 128


@dataclass(frozen=True)
class Phase:
    """One launch: blocks of ``rows`` x ``cols`` over an (E, C, n) output,
    the grid (column tiles, row tiles, experts) in CUDA's x, y, z order."""
    name: str
    rows: int
    cols: int
    grid: Tuple[int, int, int]


@dataclass(frozen=True)
class Plan:
    body: str  # "wgmma" (bf16, tensor cores) or "fma" (fp32, CUDA cores)
    gate_up: Phase  # h (E, C, f)
    down: Phase     # y (E, C, d)


@functools.lru_cache(maxsize=256)
def grid_plan(E: int, C: int, d: int, f: int, dtype: torch.dtype) -> Plan:
    """The blocks of the kernel's two phases for these shapes and dtype."""
    if dtype == torch.bfloat16:
        body, (rows, c1, c2) = "wgmma", TC_TILES
        c2 = c2 if d > 128 else 128
    elif dtype == torch.float32:
        body, (rows, c1, c2) = "fma", FMA_TILES
    else:
        raise ValueError(f"no moe_gemm body for {dtype}")
    rt = -(-C // rows)
    return Plan(body, Phase("gate_up", rows, c1, (-(-f // c1), rt, E)),
                Phase("down", rows, c2, (-(-d // c2), rt, E)))

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


def kernel_tiles(dtype: torch.dtype, d: int) -> Tuple[str, int, int, int, int]:
    """What the built kernel reports for this dtype and d: (body, phase-1
    rows, columns, phase-2 rows, columns), to hold `grid_plan` to."""
    fn = _build.library(NAME).moe_gemm_tiles
    fn.argtypes = [_I64, _I64, ctypes.POINTER(_I64)]
    fn.restype = ctypes.c_int
    out = (_I64 * 5)()
    err = fn(_DTYPES[dtype], d, out)
    if err != 0:
        raise RuntimeError(f"moe_gemm_tiles failed (cudaError {err})")
    return ("fma", "wgmma")[out[0]], *out[1:]


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
    plan = grid_plan(E, max(C, 1), d, f, x.dtype)
    if C < 1 or E > MAX_GRID or plan.down.grid[1] > MAX_GRID:
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


class MoeGemm(torch.autograd.Function):
    """The expert GEMM whose forward is ``forward`` (the CUDA kernel; the
    tests pass the plain version to reach the wiring on the CPU) and whose
    backward is autograd's through `moe_gemm_ref`, recomputed from the
    saved x and weights (the profiler range ``moe_gemm.recompute``).  Rows
    at or past ``counts[e]`` get zero gradient (the plain version's
    `where`); ``counts`` gets none."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, counts, forward):
        ctx.save_for_backward(x, w_gate, w_up, w_down, counts)
        return forward(x, w_gate, w_up, w_down, counts)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad(), record_function("moe_gemm.recompute"):
            *ins, counts = ctx.saved_tensors
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ins, ctx.needs_input_grad)]
            y = moe_gemm_ref(*ins, counts)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(got) if t.requires_grad else None for t in ins), None, None)


def moe_gemm(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU expert GEMM over a capacity buffer.

    x (E, C, d) fp32 or bf16; w_gate, w_up (E, d, f) and w_down (E, f, d)
    in x's dtype; counts (E,) int32, the tokens dispatched to each expert
    (a count above C means all C rows).  Returns y (E, C, d) in x's dtype:
    ``silu(x Wg) * (x Wu)`` in fp32 rounded to the dtype, times Wd in fp32,
    rows at or past ``counts[e]`` 0.  The kernel on the card
    (differentiable through `MoeGemm`); the plain version, differentiable
    as it is, for CPU tensors.
    """
    if x.is_cuda:
        return MoeGemm.apply(x, w_gate, w_up, w_down, counts, moe_gemm_cuda)
    if x.device.type != "cpu":
        raise ValueError(f"no moe_gemm for device {x.device}")
    return moe_gemm_ref(x, w_gate, w_up, w_down, counts)
