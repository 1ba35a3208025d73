"""Roofline terms of a dry-run cell (`repro.launch.roofline`), as a cost
model of an H100 SXM.

  compute    = FLOPs / peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

every quantity per device (rank 0 of the production mesh, whose step is
the program every device runs).  The JAX package reads them from XLA's
``cost_analysis`` and the partitioned HLO; here they are counted while the
step runs on fake tensors (`CostMode`, a `TorchDispatchMode` under which
DTensor's ops reach the counter as the local ops on this rank's shards):

- FLOPs: `torch.utils.flop_counter.FlopCounterMode`'s formulas for the
  ops it knows, on the local shapes: the matrix products (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, the einsums they lower to) and
  attention and convolutions.  Elementwise ops, reductions, softmax and
  the scans' adds count nothing, where XLA's ``cost_analysis`` counts a
  FLOP an element: the attention's plain version computes every
  score of the causal square, where the JAX dry run's unrolled blocks
  skip the masked ones.
- bytes: the sum over every op of its tensor inputs' and outputs' bytes
  on this rank (no fusion: each op reads its inputs and writes its
  outputs once), where XLA counts a fusion's operands and results.  Views
  move nothing and count nothing.
- collective bytes: the bytes of each collective's result on this rank,
  by the JAX opcode names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``).  DTensor
  turns a shard-to-shard redistribute into an all-to-all, which a process
  group without one (the fake group on a CPU) issues as an all-gather and
  a local chunk: the counter files those bytes under ``all-to-all``, the
  collective of a real group, at its result's size.
- peak memory per device: `torch.distributed._tools.mem_tracker.MemTracker`
  over the step on fake tensors, the step's inputs included (XLA's
  ``memory_analysis``: arguments + temporaries + outputs - aliases).

Hardware: NVIDIA's H100 SXM data sheet: its dense bf16 rate and HBM3's
bytes a second (`repro_torch.device.h100_peaks`), and NVLink 4 at 900 GB/s
a GPU, both directions together.
``LINK_BW`` takes one direction, 450e9 B/s: a collective's result bytes
arrive at the device over its links in one direction while it sends as
many out the other.  The production meshes (256 and 512 devices) are
wider than one NVLink domain (8 GPUs an HGX board); the model prices
every collective at the NVLink rate, as the JAX one prices every hop at
its ICI rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..device import h100_peaks
from ..models import spmd

# hardware constants (per device), NVIDIA H100 SXM data sheet
PEAK_FLOPS = h100_peaks().bf16_flops      # dense bf16 tensor FLOP/s
HBM_BW = h100_peaks().hbm_bytes_per_s     # bytes/s
NVLINK_BW = 900e9            # bytes/s a GPU, NVLink 4, both directions
LINK_BW = NVLINK_BW / 2      # bytes/s a direction

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collectives (c10d_functional / _c10d_functional) -> opcode
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# ops that read or write no tensor data (metadata, aliases)
_NO_DATA = frozenset({"detach", "alias", "lift_fresh", "size", "sym_size", "stride",
                      "sym_stride", "numel", "sym_numel", "dim", "is_contiguous",
                      "storage_offset", "sym_storage_offset", "empty", "empty_like",
                      "empty_strided", "_to_copy_meta"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def quiet_propagation():
    """DTensor works out a new op's layouts by running it, or its
    decomposition, on fake tensors of the global shapes, under the active
    fake mode (and so under every dispatch mode above it); its caches then
    skip that work for an op it has seen, so a first trace would count
    more than a second.  Within this block the propagation runs with the
    dispatch modes set aside: the counters (`CostMode`, `MemTracker`) see
    only the local ops, the same on every trace."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    names = [n for n in ("propagate_op_sharding_non_cached",
                         "_propagate_tensor_meta_non_cached")
             if hasattr(ShardingPropagator, n)]
    origs = {n: getattr(ShardingPropagator, n) for n in names}

    def quiet(orig):
        def run(self, *args, **kwargs):
            with _disable_current_modes():
                return orig(self, *args, **kwargs)
        return run

    for n in names:
        setattr(ShardingPropagator, n, quiet(origs[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(ShardingPropagator, n, origs[n])


def peak_tracker(breakdown: bool = False):
    """A `MemTracker` for the peak alone: its per-module statistics are
    off (a module called once a microbatch would raise), and the step's
    inputs are handed to it with ``track_external``.  With ``breakdown``
    it also keeps, at the peak, the live bytes by the op, shape and dtype
    that made them (`PeakTracker.peak_breakdown`)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class PeakTracker(MemTracker):
        _op = "input"
        _breakdown: Dict[str, int] = {}

        def _pre_fw_hook(self, *args, **kwargs):
            pass

        def _post_fw_hook(self, *args, **kwargs):
            pass

        def _pre_bw_hook(self, *args, **kwargs):
            pass

        def _post_bw_hook(self, *args, **kwargs):
            pass

        def peak_bytes(self) -> float:
            return float(sum(snap["Total"] for snap in
                             self.get_tracker_snapshot("peak").values()))

        def peak_breakdown(self):
            """[(op shape dtype, bytes)] of the storages live at the peak,
            largest first."""
            return sorted(self._breakdown.items(), key=lambda kv: -kv[1])

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._op = func._overloadpacket.__name__
            try:
                return super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self._op = "input"

        def _track(self, reftype, t):
            super()._track(reftype, t)
            if breakdown:
                from torch.distributed._tools.mem_tracker import get_untyped_storages

                for st in get_untyped_storages(t):
                    winfo = self._WINFO.get(st, (None, None))[0]
                    if winfo is not None and not hasattr(winfo, "origin"):
                        winfo.origin = f"{self._op} {tuple(t.shape)} {str(t.dtype)[6:]}"

        def track_external(self, *external):
            super().track_external(*external)
            if breakdown:
                for winfo, _ in list(self._WINFO.values()):
                    if not hasattr(winfo, "origin"):
                        winfo.origin = "input"

        def _update_peak_stats(self, peak_state):
            before = dict(self._peak_mem)
            super()._update_peak_stats(peak_state)
            if breakdown and self._peak_mem != before:
                out: Dict[str, int] = {}
                for winfo, _ in list(self._WINFO.values()):
                    key = getattr(winfo, "origin", "input")
                    out[key] = out.get(key, 0) + winfo.mem_consumed
                self._breakdown = out

    return PeakTracker()


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of the local ops on this
    rank while active (see the module's docstring).  Ops on DTensors are
    handed back to DTensor (NotImplemented), so the counter sees the
    local ops and the collectives they become; the ops DTensor runs on
    fake tensors of its own to propagate shapes are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.flop_counter = FlopCounterMode(display=False)
        self.bytes = 0
        self.kernel_flops = 0.0
        self.coll: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
        self._in_all_to_all = 0
        self._in_kernel = 0
        self._patched = []

    @property
    def flops(self) -> float:
        return self.flop_counter.get_total_flops() + self.kernel_flops

    def kernel(self, inputs, outputs, flops: float):
        """A kernel's call (`models.spmd.kernel_call`): results of the
        shapes ``outputs``, costed at ``flops`` and its operands' bytes;
        differentiable, its backward costed as 3x the FLOPs."""
        return _KernelNode.apply(self, flops, tuple(outputs), *inputs)

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake = active_fake_mode()
        self._hook_all_to_all()
        spmd.COUNTER[0] = self
        return super().__enter__()

    def __exit__(self, *exc):
        spmd.COUNTER[0] = None
        for module, orig in self._patched:
            module.shard_dim_alltoall = orig
        self._patched = []
        return super().__exit__(*exc)

    def _hook_all_to_all(self):
        """Wrap DTensor's ``shard_dim_alltoall`` where its callers bind it:
        the wrapper counts its result under ``all-to-all`` and the counter
        skips what it runs (the CPU fallback's all-gather and chunk)."""
        import importlib

        for name in ("torch.distributed.tensor.placement_types",
                     "torch.distributed.tensor._redistribute"):
            module = importlib.import_module(name)
            orig = getattr(module, "shard_dim_alltoall", None)
            if orig is None:
                continue

            def wrapped(*args, _orig=orig, **kwargs):
                self._in_all_to_all += 1
                try:
                    out = _orig(*args, **kwargs)
                finally:
                    self._in_all_to_all -= 1
                self.coll["all-to-all"] += _nbytes(out)
                return out

            module.shard_dim_alltoall = wrapped
            self._patched.append((module, orig))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake or self._in_all_to_all or self._in_kernel:
            return out      # DTensor's shape propagation; an all-to-all's or a kernel's body
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("c10d_functional", "_c10d_functional", "c10d"):
            if name == "wait_tensor":
                return out
            op = _FUNCOL.get(name)
            if op is not None:
                self.coll[op] += sum(_nbytes(t) for t in _tensors(out))
            return out
        if ns == "prim" or func.is_view or name in _NO_DATA:
            return out
        self.flop_counter._count_flops(func._overloadpacket, out, args, kwargs)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


class _KernelNode(torch.autograd.Function):
    """A kernel call in the cost count: empty results, counted FLOPs and
    bytes, and a backward of empty gradients counted at 3x the FLOPs (the
    plain version's recompute and the two gradient products)."""

    @staticmethod
    def forward(ctx, counter, flops, outputs, *inputs):
        counter._in_kernel += 1
        try:
            outs = tuple(torch.empty(shape, dtype=dtype) for shape, dtype in outputs)
        finally:
            counter._in_kernel -= 1
        counter.kernel_flops += flops
        counter.bytes += sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in outs)
        ctx.counter, ctx.flops = counter, flops
        ctx.inputs = [(t.shape, t.dtype, t.is_floating_point()) if isinstance(t, torch.Tensor)
                      else None for t in inputs]
        ctx.in_bytes = sum(_nbytes(t) for t in inputs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        counter = ctx.counter
        counter._in_kernel += 1
        try:
            out = [torch.empty(m[0], dtype=m[1]) if m is not None and m[2] else None
                   for m in ctx.inputs]
        finally:
            counter._in_kernel -= 1
        counter.kernel_flops += 3 * ctx.flops
        counter.bytes += (ctx.in_bytes + sum(_nbytes(g) for g in grads)
                          + sum(_nbytes(g) for g in out))
        return (None, None, None, *out)


@dataclasses.dataclass
class Roofline:
    """All raw quantities are PER-DEVICE: rank 0's program of the
    partitioned step, which every device runs on its own shards.  The
    whole job's FLOPs over (devices x peak) equal the per-device FLOPs over
    the peak."""
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: Dict[str, int]   # per-opcode collective bytes (per device)
    n_chips: int
    model_flops: float = 0.0     # 6*N*D analytical (whole job)
    per_device_peak_memory: float = 0.0

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.total_coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful work time / achievable step time (max of terms)."""
        denom = max(self.t_compute, self.t_memory, self.t_collective)
        ideal = self.model_flops / (self.n_chips * PEAK_FLOPS)
        return ideal / denom if denom else 0.0

    def row(self) -> Dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "collective_bytes": self.total_coll_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_per_device": self.per_device_peak_memory,
        }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode: per new
    token D = global_batch."""
    from ..models import count_params, model_specs
    from ..models.params import tree_leaves

    specs = model_specs(cfg)
    n_total = count_params(specs)
    if cfg.family == "moe":
        # active = total - (inactive expert fraction)
        expert_params = sum(
            int(np.prod(s.shape)) for s in tree_leaves(specs)
            if "experts" in (s.axes or ()))
        n_active = (n_total - expert_params
                    + expert_params * cfg.top_k / cfg.n_experts)
    else:
        n_active = n_total
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
