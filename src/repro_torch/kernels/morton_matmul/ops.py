"""Curve-ordered tiled matmul: kernel on the card, plain version on the CPU,
and the tile orders with their panel-traffic model.

`morton_matmul` launches the hand-written CUDA kernel (``kernel.cu``) for
tensors on the card and uses the plain PyTorch version (``ref.py``) only
for tensors on the CPU.  The tile grid follows the JAX wrapper's rule for
block sizes (`grid`): a dimension larger than its block is cut into
blocks with a ragged last one (the JAX wrapper pads it; the kernel masks
it), a smaller one is one block.  The kernel's block b computes tile
``tile_order(nm, nn, order)[b]``: the curve's first visit of each tile,
from the TPU kernel's own index maps.  `tile_sequence` and `panel_traffic`
are the JAX package's traffic model, kept as it behaves (consecutive
repeats removed, later repeats kept).  `launches` counts kernel launches,
so a run can show that its path went through the kernel.

In bf16 the kernel runs on the tensor cores and reads its operands by TMA,
which takes only 16-byte aligned bases and rows a multiple of 16 bytes
apart.  An operand laid out otherwise goes to the same kernel as an
explicit zero-padded copy (`tma_copy`), counted in `padded_copies`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import morton
from .. import _build
from .ref import morton_matmul_ref

NAME = "morton_matmul"
ORDERS = ("morton", "hilbert", "rowmajor")

launches = 0  # kernel launches since the last reset (read by chip_smoke)
padded_copies = 0  # bf16 operands copied for TMA since the last reset
_count_guard = threading.Lock()


def reset_launches() -> None:
    global launches, padded_copies
    with _count_guard:
        launches = padded_copies = 0


def _count_launch() -> None:
    global launches
    with _count_guard:
        launches += 1


_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a, b, out, tiles, trace; M, N, K, bm, bn, bk, n_tiles; dtype; stream
ARGTYPES = [ctypes.c_void_p] * 5 + [_I64] * 7 + [_I64, ctypes.c_void_p]


def _entry():
    fn = _build.library(NAME).morton_matmul_launch
    if fn.argtypes is None:  # untyped ctypes would cut pointers to 32 bits
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ tile grid ----

def grid(M: int, N: int, K: int, block_m: int, block_n: int,
         block_k: int) -> Tuple[int, int, int, int, int]:
    """(bm, bn, bk, nm, nn): the JAX wrapper's blocks and tile grid.

    A dimension larger than its block keeps the block and gets a ragged
    last one; a dimension that fits one block is one block of its size
    (`repro.kernels.morton_matmul.ops.morton_matmul`)."""
    if min(M, N, K) < 1 or min(block_m, block_n, block_k) < 1:
        raise ValueError(f"want positive dims and blocks, got {(M, N, K)} and "
                         f"{(block_m, block_n, block_k)}")
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    return bm, bn, bk, -(-M // bm), -(-N // bn)


def _curve(nm: int, nn: int, order: str) -> np.ndarray:
    """The TPU kernel's index maps (kernel.py:63-84) over its whole grid:
    (cells, 2) tile coordinates in curve order, padded cells clamped onto
    real tiles, repeats kept."""
    if order == "morton":
        bits = morton.grid_bits((nm, nn))
        ij = morton.morton_decode(np.arange(1 << morton.total_bits(bits)), bits)
    elif order == "hilbert":
        h = max(morton.grid_bits((nm, nn)))
        ij = np.stack(morton.hilbert_decode_2d(np.arange(1 << (2 * h)), h), axis=-1)
    elif order == "rowmajor":
        t = np.arange(nm * nn)
        ij = np.stack([t // nn, t % nn], axis=-1)
    else:
        raise ValueError(order)
    return np.minimum(ij, [nm - 1, nn - 1])


def tile_sequence(nm: int, nn: int, order: str) -> List[Tuple[int, int]]:
    """The (i, j) visit order for each schedule (consecutive dups removed)."""
    seq: List[Tuple[int, int]] = []
    for i, j in _curve(nm, nn, order).tolist():
        if not seq or (i, j) != seq[-1]:
            seq.append((i, j))
    return seq


def lru_fetches(seq: Sequence[Tuple[int, int]], capacity: int = 1) -> int:
    """(A, B)-panel fetches of a tile sequence under an LRU cache of
    ``capacity`` panels per operand."""
    a_cache: OrderedDict = OrderedDict()
    b_cache: OrderedDict = OrderedDict()
    fetches = 0
    for i, j in seq:
        for cache, key in ((a_cache, i), (b_cache, j)):
            if key in cache:
                cache.move_to_end(key)
            else:
                fetches += 1
                cache[key] = True
                if len(cache) > capacity:
                    cache.popitem(last=False)
    return fetches


def panel_traffic(nm: int, nn: int, order: str, capacity: int = 1) -> int:
    """#(A,B)-panel HBM fetches of `tile_sequence` under an LRU panel cache
    of ``capacity`` panels per operand.

    ``capacity=1`` models the TPU's Pallas pipeline (an operand's copy is
    skipped iff its block index is unchanged from the previous grid step);
    larger capacities model an explicit panel cache, or the blocks a GPU
    holds at once sharing L2.  Hilbert wins at capacity 1 (every step
    changes one coordinate); Morton needs capacity >= 2.
    """
    return lru_fetches(tile_sequence(nm, nn, order), capacity)


def tile_order_np(nm: int, nn: int, order: str) -> np.ndarray:
    """The kernel's launch order: tile ids ``i * nn + j`` (int32) at the
    curve's first visit of each tile, a permutation of the nm * nn tiles."""
    ij = _curve(nm, nn, order)
    ids = ij[:, 0] * nn + ij[:, 1]
    _, first = np.unique(ids, return_index=True)
    return ids[np.sort(first)].astype(np.int32)


@functools.lru_cache(maxsize=64)
def _tile_order_on(nm: int, nn: int, order: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tile_order_np(nm, nn, order)).to(device)


def tile_order(nm: int, nn: int, order: str, device="cpu") -> torch.Tensor:
    """`tile_order_np` as an int32 tensor on ``device``, built once per
    (nm, nn, order, device): later calls make no host-to-device copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _tile_order_on(nm, nn, order, dev)


def wave_panels(tiles: Sequence[int], nn: int, wave: int) -> int:
    """Distinct A and B panels summed over consecutive waves of ``wave``
    blocks of a launch order (tile ids): the panels each wave of blocks in
    flight reads, if nothing of an earlier wave is still cached."""
    t = np.asarray(tiles, dtype=np.int64)
    total = 0
    for w in range(0, len(t), wave):
        chunk = t[w:w + wave]
        total += len(np.unique(chunk // nn)) + len(np.unique(chunk % nn))
    return total


# --------------------------------------------------------------- tracing ----

def new_trace(nm: int, nn: int, device) -> torch.Tensor:
    """Zeros for the kernel's ``trace``: 3 nm nn + 1 int32."""
    return torch.zeros(3 * nm * nn + 1, dtype=torch.int32, device=device)


def check_trace(trace: torch.Tensor, tiles: torch.Tensor) -> dict:
    """Hold a trace to its launch: block b computed tile ``tiles[b]``, every
    tile exactly once, and each block started once.  Returns the largest
    lag between a block's index and its place in the start order."""
    n = tiles.numel()
    tr = trace.cpu().long()
    if not torch.equal(tr[:n], tiles.cpu().long()):
        raise RuntimeError("morton_matmul: a block computed another tile than "
                           "tile_order gives it")
    if not bool((tr[n:2 * n] == 1).all()):
        raise RuntimeError(f"morton_matmul: tiles computed {tr[n:2 * n].min()} to "
                           f"{tr[n:2 * n].max()} times, want each once")
    starts = tr[2 * n:3 * n]
    if int(tr[3 * n]) != n or not torch.equal(starts.sort().values, torch.arange(n)):
        raise RuntimeError("morton_matmul: blocks did not each start once")
    return dict(tiles=n, max_start_lag=int((starts - torch.arange(n)).abs().max()))


# --------------------------------------------------------------- wrapper ----

TMA_ALIGN = 16  # bytes: TMA's base and row-stride alignment


def tma_ready(t: torch.Tensor) -> bool:
    """Whether a contiguous bf16 matrix can be read by TMA as it is: its
    base 16-byte aligned and its rows a multiple of 16 bytes long."""
    return (t.data_ptr() % TMA_ALIGN == 0
            and t.shape[1] * t.element_size() % TMA_ALIGN == 0)


def tma_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh (aligned) copy of matrix ``t`` whose rows are padded with
    zeros to a multiple of 16 bytes: the layout the kernel's bf16 body
    reads (rows of K or N rounded up to a multiple of 8 elements)."""
    global padded_copies
    per = TMA_ALIGN // t.element_size()
    rows, cols = t.shape
    out = torch.zeros((rows, -(-cols // per) * per), dtype=t.dtype, device=t.device)
    out[:, :cols] = t
    with _count_guard:
        padded_copies += 1
    return out


def _check(a: torch.Tensor, b: torch.Tensor, order: str) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"a and b must both be float32 or both bfloat16, got "
                         f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if order not in ORDERS:
        raise ValueError(f"order {order!r}: want one of {ORDERS}")


def morton_matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                       block_n: int = 256, block_k: int = 256, order: str = "morton",
                       trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as `morton_matmul`."""
    _check(a, b, order)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("a and b must be on the same CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    (M, K), N = a.shape, b.shape[1]
    bm, bn, bk, nm, nn = grid(M, N, K, block_m, block_n, block_k)
    if (trace is not None and (trace.device != a.device or trace.dtype != torch.int32
                               or tuple(trace.shape) != (3 * nm * nn + 1,))):
        raise ValueError(f"trace: want {3 * nm * nn + 1} int32 zeros on {a.device}")
    tiles = tile_order(nm, nn, order, a.device)
    if a.dtype == torch.bfloat16:
        a = a if tma_ready(a) else tma_copy(a)
        b = b if tma_ready(b) else tma_copy(b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = _entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), tiles.data_ptr(),
                 None if trace is None else trace.data_ptr(), M, N, K, bm, bn, bk,
                 nm * nn, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"morton_matmul launch failed (cudaError {err})")
    _count_launch()
    return out


def morton_matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                  block_n: int = 256, block_k: int = 256, order: str = "morton",
                  trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype, fp32 or bf16 (both the
    same), summed in fp32; output tiles (block_m, block_n) launched in
    ``order``: morton | hilbert | rowmajor.  The kernel on the card (it
    takes any shape and alignment, bf16 ones through `tma_copy`; `trace`,
    from `new_trace`, records what each block did); the plain version for
    CPU tensors."""
    if a.is_cuda:
        return morton_matmul_cuda(a, b, block_m=block_m, block_n=block_n,
                                  block_k=block_k, order=order, trace=trace)
    if a.device.type != "cpu" or b.device.type != "cpu":
        raise ValueError(f"no morton_matmul for devices {a.device} and {b.device}")
    _check(a, b, order)
    if trace is not None:
        raise ValueError("trace records the kernel's blocks; the CPU runs none")
    grid(a.shape[0], b.shape[1], a.shape[1], block_m, block_n, block_k)
    return morton_matmul_ref(a, b)


def blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of the kernel one SM of the current card holds at once."""
    fn = _build.library(NAME).morton_matmul_blocks_per_sm
    fn.argtypes = [_I64, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(_DTYPES[dtype], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"morton_matmul occupancy query failed (cudaError {err})")
    return out.value
