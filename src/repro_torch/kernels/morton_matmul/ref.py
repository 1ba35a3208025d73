"""Plain PyTorch matrix product, on any device.

The port's twin of `repro.kernels.morton_matmul.ref.matmul_ref`: the
product of the operands taken to fp32.  The whole function
(`morton_matmul`) is that product rounded to a's dtype, which is what the
JAX `morton_matmul` returns and what ``kernel.cu`` computes.  On the card
the fp32 product must not run in TF32, which keeps about three decimal
digits: `matmul_ref` refuses a CUDA tensor while PyTorch's
``torch.backends.cuda.matmul.allow_tf32`` is on (it is off by default, and
`repro_torch.device.resolve_device` turns it off).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) in fp32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matmul_ref on the card needs TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32 = False)")
    return a.to(F32) @ b.to(F32)


def morton_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of `morton_matmul`: ``matmul_ref`` in a's dtype."""
    return matmul_ref(a, b).to(a.dtype)
