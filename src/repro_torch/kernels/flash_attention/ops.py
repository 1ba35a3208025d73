"""Flash attention wrapper: (B, S, heads, D) in, kernel or plain version.

`flash_attention` launches the hand-written CUDA kernel (``kernel.cu``)
for tensors on the card and uses the plain PyTorch version (``ref.py``)
only for tensors on the CPU.  `launches` counts kernel launches, so a run
can show that its path went through the kernel.  In bf16 the kernel runs
on the tensor cores and moves q, k and v in 16-byte chunks: a tensor whose
base or strides do not allow that goes to the same kernel as an explicit
contiguous copy (`chunk_ready`), counted in `aligned_copies`.

On the card the kernel runs inside `FlashAttention`, an autograd Function:
its forward is the kernel.  Where autograd records the call and the
gradient kernels cover it (`grad_kernel_takes`: bf16, causal
self-attention, D 64 or 128, any window), the forward also leaves each
row's logsumexp, and the backward is ``kernel.cu``'s gradient
(`flash_attention_grad_cuda`, held to `flash_attention_grad_ref`).  Every
other call's backward recomputes attention through the plain version and
differentiates that (`_wrap.plain_grad`), the gradient of the function the
kernel computes, with its casts (the JAX package has no backward kernel:
its gradient is XLA's autodiff of jnp code).  `backward_launches` and
`backward_plain` count the backward calls that took each route; neither
adds to `launches`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, _wrap
from .ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
GRAD_HEAD_DIMS = (64, 128)  # the gradient kernels' instances
MAX_GROUP = 64  # query heads per kv head: one block holds them all

# forward kernel launches, bf16 inputs copied for 16-byte chunks, and
# backward calls that took the gradient kernels or the plain recompute,
# since the last reset (read by ocpbench's harness and chip_smoke)
_counts = _wrap.Counts(__name__, "launches", "aligned_copies", "backward_launches",
                       "backward_plain")
reset_launches = _counts.reset
__getattr__ = _counts.get

_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out, lse (null: none); B, Sq, Skv, K, G, D; 12 strides; causal,
# window; scale; dtype; stream
ARGTYPES = [ctypes.c_void_p] * 5 + [_I64] * 20 + [ctypes.c_float, _I64, ctypes.c_void_p]
# q, k, v, out, dout, lse, delta, dq, dk, dv; B, S, K, G, D; 24 strides;
# window; scale; stream
GRAD_ARGTYPES = [ctypes.c_void_p] * 10 + [_I64] * 30 + [ctypes.c_float, ctypes.c_void_p]


def launch_args(q, k, v, out, lse, *, causal: bool, scale: float, window: Optional[int]):
    """The C entry's arguments but the stream, for tensors the wrapper has
    checked; ``lse`` None asks for no logsumexp."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Skv, K,
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
    if chunk_ready(t):
        return t
    _counts.add("aligned_copies")
    return t.clone(memory_format=torch.contiguous_format)


def grad_kernel_takes(q: torch.Tensor, k: torch.Tensor, *, causal: bool) -> bool:
    """Whether the gradient kernels cover a call on these tensors: bf16,
    causal self-attention (Sq = Skv), D in `GRAD_HEAD_DIMS`; any window."""
    return (q.dtype == torch.bfloat16 and k.dtype == q.dtype and causal
            and q.dim() == 4 and k.dim() == 4 and q.shape[1] == k.shape[1]
            and q.shape[-1] in GRAD_HEAD_DIMS)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, scale: float, window: Optional[int] = None,
                         lse: bool = False):
    """Launch the CUDA kernel; same contract as `flash_attention_ref`.
    With ``lse`` (bf16 at D 64 or 128 only), the kernel also writes each
    row's logsumexp: (out, lse (B, H, Sq) fp32 in base 2), the out bit for
    bit as without."""
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
    if lse and (q.dtype != torch.bfloat16 or D not in GRAD_HEAD_DIMS):
        raise ValueError(f"the logsumexp entry takes bfloat16 at D {GRAD_HEAD_DIMS}, got "
                         f"{q.dtype} at D {D}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    logsumexp = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if lse else None
    if out.numel() == 0:
        return (out, logsumexp) if lse else out
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    _build.launch(_build.entry(NAME, "flash_attention_launch", ARGTYPES), q.device,
                  *launch_args(q, k, v, out, logsumexp, causal=causal, scale=scale,
                               window=window), what="flash_attention launch")
    _counts.add("launches")
    return (out, logsumexp) if lse else out


def grad_args(q, k, v, out, dout, lse, delta, dq, dk, dv, *, scale: float,
              window: Optional[int]):
    """`attn_grad_launch`'s arguments but the stream, for tensors the
    wrapper has checked."""
    B, S, H, D = q.shape
    K = k.shape[2]
    ts = (q, k, v, out, dout, lse, delta, dq, dk, dv)
    return (*(t.data_ptr() for t in ts), B, S, K, H // K, D,
            *(x for t in (q, k, v, out, dout, dq, dk, dv) for x in _strides(t)),
            window or 0, scale)


def flash_attention_grad_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool, scale: float, window: Optional[int] = None):
    """Launch the gradient kernels; same contract as
    `flash_attention_grad_ref`: (dq, dk, dv), from the forward's ``out``
    and ``lse`` (``flash_attention_cuda(..., lse=True)``'s)."""
    ts = (q, k, v, out, dout)
    if not (q.is_cuda and all(t.device == q.device for t in ts + (lse,))):
        raise ValueError("q, k, v, out, lse and dout must be on the same CUDA device")
    if not grad_kernel_takes(q, k, causal=causal) or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"the gradient kernels take bfloat16 causal self-attention at D "
                         f"{GRAD_HEAD_DIMS}, got q {q.dtype} {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, causal {causal}")
    B, S, H, D = q.shape
    K = k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != D or H % K
            or H // K > MAX_GROUP or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, H, S) or lse.dtype != torch.float32):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    q, k, v, out, dout = (_aligned(t) for t in ts)
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, K, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk, dv
    _build.launch(_build.entry(NAME, "attn_grad_launch", GRAD_ARGTYPES), q.device,
                  *grad_args(q, k, v, out, dout, lse, delta, dq, dk, dv, scale=scale,
                             window=window), what="flash_attention backward launch")
    _counts.add("backward_launches")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is ``forward`` (the CUDA kernel; the tests
    pass the plain version to reach the wiring on the CPU) and whose
    backward, inside the span ``flash_attention.recompute``, follows what
    the call is: where ``backward`` is given and `grad_kernel_takes` the
    tensors, the forward is ``forward(..., lse=True)`` and the backward
    ``backward`` (the gradient kernels, `flash_attention_grad_cuda`, or a
    twin with their contract) on the saved q, k, v, out and lse; every
    other call's backward is autograd's through `flash_attention_ref`,
    recomputed from the saved q, k and v (`_wrap.plain_grad`), which holds
    the plain version's (B, K, G, Sq, Skv) fp32 scores and probabilities for
    one layer at a time.  `attend` gives ``backward`` only where autograd
    records the call."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, window: Optional[int],
                forward, backward=None):
        ctx.attn = dict(causal=causal, scale=scale, window=window)
        ctx.grad = backward if backward is not None and grad_kernel_takes(
            q, k, causal=causal) else None
        if ctx.grad is None:
            ctx.save_for_backward(q, k, v)
            return forward(q, k, v, causal=causal, scale=scale, window=window)
        out, lse = forward(q, k, v, causal=causal, scale=scale, window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _wrap.function_grads(ctx, "flash_attention.recompute", flash_attention_ref,
                                     (dout,), **ctx.attn)
        if ctx.grad is None:
            _counts.add("backward_plain")
        return grads


def attend(q, k, v, causal: bool, scale: float, window: Optional[int], forward, backward):
    """``FlashAttention.apply``, with ``backward`` (and so the forward's
    logsumexp) only where autograd records the call: grad mode on and an
    input that requires a gradient.  Under ``torch.no_grad`` or
    ``torch.inference_mode`` the forward is the plain entry."""
    taped = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, scale, window, forward,
                                backward if taped else None)


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
        return attend(q, k, v, causal, scale, window, flash_attention_cuda,
                      flash_attention_grad_cuda)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention for device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               window=window)
