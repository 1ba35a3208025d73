"""What the kernels' wrappers (`<kernel>/ops.py`) share on the host beside
the binding (`_build`): their counts, and the backward of their autograd
Functions.

Each ``ops`` module keeps its counts in one `Counts` (``launches`` and, where
it has them, ``aligned_copies``, ``padded_copies``, ``backward_launches``,
``backward_plain``) and serves them as module attributes: ``ops.launches``,
read by the benchmark's harness and the smoke, and ``ops.reset_launches()``,
which zeroes all of a module's counts.  A Function's backward
(`function_grads`) is its backward kernel where the forward chose one, and
otherwise the plain recompute (`plain_grad`): autograd's gradient of the
plain version, recomputed from the saved inputs.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import torch

from ..obs.trace import span


class Counts:
    """Named counts of one ``ops`` module under one lock: the front door
    and the cluster launch kernels from threads.  The module binds
    ``reset_launches = counts.reset`` and ``__getattr__ = counts.get``
    (PEP 562), so ``ops.launches`` reads the count."""

    def __init__(self, module: str, *names: str):
        self._module = module
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        """Zero every count."""
        with self._lock:
            self._counts = dict.fromkeys(self._counts, 0)

    def get(self, name: str) -> int:
        try:
            return self._counts[name]
        except KeyError:
            raise AttributeError(f"module {self._module!r} has no attribute {name!r}") from None


def plain_grad(ref: Callable, saved: Sequence[torch.Tensor], needs: Sequence[bool],
               cotangents: Sequence[Optional[torch.Tensor]], **kw) -> List[Optional[torch.Tensor]]:
    """Autograd's gradient of ``ref(*saved, **kw)`` at the saved inputs, for
    the inputs whose ``needs`` is true (None for the others), over the
    outputs whose cotangent is not None (a caller may drop an output, as
    training drops the scan's final state)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(saved, needs)]
        outs = ref(*ins, **kw)
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        outs, cots = zip(*[(o, g) for o, g in zip(outs, cotangents) if g is not None])
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, cots))
    return [next(got) if t.requires_grad else None for t in ins]


def function_grads(ctx, name: str, ref: Callable, cotangents, **kw) -> tuple:
    """A kernel Function's backward inside the span ``name``: ``ctx.grad``,
    the backward its forward chose (a kernel, or a twin with its contract),
    on the saved tensors, the cotangents and ``kw``, or where it chose none
    (``ctx.grad`` None or unset) `plain_grad` through ``ref``.  None for each
    input that needs no gradient, and for the arguments past the saved
    tensors."""
    needs = ctx.needs_input_grad
    grad = getattr(ctx, "grad", None)
    with span(name):
        if grad is None:
            got = plain_grad(ref, ctx.saved_tensors, needs, cotangents, **kw)
        else:
            got = [g if n else None
                   for g, n in zip(grad(*ctx.saved_tensors, *cotangents, **kw), needs)]
    return (*got, *(None,) * (len(needs) - len(got)))
