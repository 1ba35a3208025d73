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
forward is the kernel.  Its backward, for bf16 tensors, is the backward
kernel (``kernel.cu``'s `moe_gemm_grad_launch`, through `moe_gemm_grad_cuda`:
the gradient over the live rows only, on the tensor cores, held to
`moe_gemm_grad_ref`; `grad_kernel_takes`); for fp32 tensors it recomputes
the product through the plain version and differentiates that
(`_wrap.plain_grad`), as the FMA forward's twin.  `backward_launches` and
`backward_plain` count the backward calls that took each route.  The JAX
package has no backward kernel (its MoE differentiates three einsums).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import _build, _wrap
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

# forward kernel launches, and backward calls that took the backward kernel
# or the plain recompute, since the last reset (read by ocpbench's harness
# and chip_smoke)
_counts = _wrap.Counts(__name__, "launches", "backward_launches", "backward_plain")
reset_launches = _counts.reset
__getattr__ = _counts.get

_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, w_gate, w_up, w_down, counts, h, y; E, C, d, f; dtype; stream
ARGTYPES = [ctypes.c_void_p] * 7 + [_I64] * 4 + [_I64, ctypes.c_void_p]
# x, w_gate, w_up, w_down, counts, dy, scratch, dx, dw_gate, dw_up, dw_down;
# E, C, d, f; stream
GRAD_ARGTYPES = [ctypes.c_void_p] * 11 + [_I64] * 4 + [ctypes.c_void_p]
# dtype, d; out (body, phase-1 rows, columns, phase-2 rows, columns)
TILES_ARGTYPES = [_I64, _I64, ctypes.POINTER(_I64)]


def kernel_tiles(dtype: torch.dtype, d: int) -> Tuple[str, int, int, int, int]:
    """What the built kernel reports for this dtype and d: (body, phase-1
    rows, columns, phase-2 rows, columns), to hold `grid_plan` to."""
    out = (_I64 * 5)()
    fn = _build.entry(NAME, "moe_gemm_tiles", TILES_ARGTYPES)
    _build.check(fn(_DTYPES[dtype], d, out), "moe_gemm_tiles")
    return ("fma", "wgmma")[out[0]], *out[1:]


def grad_kernel_takes(x: torch.Tensor) -> bool:
    """Whether the backward kernel covers a call on these tensors: bf16."""
    return x.dtype == torch.bfloat16


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
    _build.launch(_build.entry(NAME, "moe_gemm_launch", ARGTYPES), x.device,
                  x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                  counts.data_ptr(), h.data_ptr(), y.data_ptr(), E, C, d, f,
                  _DTYPES[x.dtype], what="moe_gemm launch")
    _counts.add("launches")
    return y


def moe_gemm_grad_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                       w_down: torch.Tensor, counts: torch.Tensor, dy: torch.Tensor):
    """Launch the backward kernel (bf16 only); same contract as
    `moe_gemm_grad_ref`: (dx, dw_gate, dw_up, dw_down).  The scratch
    (5, E, C, f) holds h and the hi and lo halves of dg and du."""
    _check(x, w_gate, w_up, w_down, counts)
    if x.dtype != torch.bfloat16 or dy.dtype != x.dtype or dy.shape != x.shape \
            or dy.device != x.device:
        raise ValueError(f"the backward kernel takes bfloat16 x and dy of x's shape, got x "
                         f"{x.dtype} {tuple(x.shape)}, dy {dy.dtype} {tuple(dy.shape)}")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    E, C, d = x.shape
    f = w_gate.shape[-1]
    scratch = torch.empty((5, E, C, f), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    _build.launch(_build.entry(NAME, "moe_gemm_grad_launch", GRAD_ARGTYPES), x.device,
                  x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                  counts.data_ptr(), dy.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
                  dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), E, C, d, f,
                  what="moe_gemm backward launch")
    _counts.add("backward_launches")
    return dx, dwg, dwu, dwd


class MoeGemm(torch.autograd.Function):
    """The expert GEMM whose forward is ``forward`` (the CUDA kernel; the
    tests pass the plain version to reach the wiring on the CPU) and whose
    backward, inside the span ``moe_gemm.recompute``, is chosen at
    forward: where ``backward`` is given and `grad_kernel_takes` the tensors
    (bf16), ``backward`` (the backward kernel, `moe_gemm_grad_cuda`, or a
    twin with its contract) on the saved tensors and dy; every other call
    autograd's through `moe_gemm_ref`, recomputed from the saved x and
    weights (`_wrap.plain_grad`).  Rows at or past ``counts[e]`` get zero
    gradient; ``counts`` gets none."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, counts, forward, backward=None):
        ctx.save_for_backward(x, w_gate, w_up, w_down, counts)
        ctx.grad = backward if backward is not None and grad_kernel_takes(x) else None
        return forward(x, w_gate, w_up, w_down, counts)

    @staticmethod
    def backward(ctx, dy):
        grads = _wrap.function_grads(ctx, "moe_gemm.recompute", moe_gemm_ref, (dy,))
        if ctx.grad is None:
            _counts.add("backward_plain")
        return grads


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
        return MoeGemm.apply(x, w_gate, w_up, w_down, counts, moe_gemm_cuda,
                             moe_gemm_grad_cuda)
    if x.device.type != "cpu":
        raise ValueError(f"no moe_gemm for device {x.device}")
    return moe_gemm_ref(x, w_gate, w_up, w_down, counts)
