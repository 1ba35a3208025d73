"""Flash attention wrapper: (B, S, heads, D) in, kernel or plain version.

`flash_attention` launches the hand-written CUDA kernel (``kernel.cu``)
for tensors on the card and uses the plain PyTorch version (``ref.py``)
only for tensors on the CPU.  `launches` counts kernel launches, so a run
can show that its path went through the kernel.  In bf16 the kernel runs
on the tensor cores and moves q, k and v in 16-byte chunks: a tensor whose
base or strides do not allow that goes to the same kernel as an explicit
contiguous copy (`chunk_ready`), counted in `aligned_copies`.

On the card the kernel runs inside `FlashAttention`, an autograd Function:
its forward is the kernel, and its backward recomputes attention through
the plain version and differentiates that.  The JAX package has no
backward kernel either (its gradient is XLA's autodiff of jnp code), so
the gradient is that of the function the kernel computes, with its casts.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ...obs.trace import span
from .. import _build
from .ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 64  # query heads per kv head: one block holds them all

launches = 0  # kernel launches since the last reset (read by chip_smoke)
aligned_copies = 0  # bf16 inputs copied for 16-byte chunks since the last reset
_count_guard = threading.Lock()


def reset_launches() -> None:
    global launches, aligned_copies
    with _count_guard:
        launches = aligned_copies = 0


def _count_launch() -> None:
    global launches
    with _count_guard:
        launches += 1


_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out; B, Sq, Skv, K, G, D; 12 strides; causal, window; scale;
# dtype; stream
ARGTYPES = [ctypes.c_void_p] * 4 + [_I64] * 20 + [ctypes.c_float, _I64, ctypes.c_void_p]


def _entry():
    fn = _build.library(NAME).flash_attention_launch
    if fn.argtypes is None:  # untyped ctypes would cut pointers to 32 bits
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_args(q, k, v, out, *, causal: bool, scale: float, window: Optional[int]):
    """The C entry's arguments but the stream, for tensors the wrapper has
    checked."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, K,
            H // K, D, *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            int(causal), window or 0, scale, _DTYPES[q.dtype])


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def chunk_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 body can move ``t`` (B, S, heads, D) in 16-byte
    chunks: a 16-byte aligned base, and every stride a multiple of 8
    elements (the D axis contiguous)."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(t.stride(i) % 8 == 0 for i in range(3)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    global aligned_copies
    if chunk_ready(t):
        return t
    with _count_guard:
        aligned_copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, scale: float,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as `flash_attention_ref`."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on the same CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,D) and k, v (B,Skv,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    G = H // K
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv head; at most {MAX_GROUP}")
    if Sq > Skv and (causal or window is not None):
        # the offset Skv - Sq places the queries only for the causal and
        # window masks; unmasked (cross) attention takes any Sq
        raise ValueError(f"Sq {Sq} > Skv {Skv}: queries sit at the end of the keys")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head_dim axis of q, k and v must be contiguous")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*launch_args(q, k, v, out, causal=causal, scale=scale, window=window),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed (cudaError {err})")
    _count_launch()
    return out


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is ``forward`` (the CUDA kernel; the tests
    pass the plain version to reach the wiring on the CPU) and whose
    backward is autograd's through `flash_attention_ref`, recomputed from
    the saved q, k and v (the span ``flash_attention.recompute``).
    The recompute holds the plain version's (B, K, G, Sq, Skv) fp32 scores
    and probabilities for one layer at a time."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, window: Optional[int],
                forward):
        ctx.save_for_backward(q, k, v)
        ctx.attn = dict(causal=causal, scale=scale, window=window)
        return forward(q, k, v, causal=causal, scale=scale, window=window)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad(), span("flash_attention.recompute"):
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_ref(*qkv, **ctx.attn)
            dq, dk, dv = torch.autograd.grad(out, qkv, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, K, D) with H = K * G -> (B, Sq, H, D).

    Queries sit at the end of the keys (query i at position Skv - Sq + i).
    The kernel on the card (differentiable through `FlashAttention`); the
    plain version, differentiable as it is, for CPU tensors.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.is_cuda:
        return FlashAttention.apply(q, k, v, causal, scale, window,
                                    flash_attention_cuda)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention for device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               window=window)
