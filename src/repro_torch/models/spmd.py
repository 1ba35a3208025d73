"""The model's kernel calls on DTensors: each device runs the call on its
own shard.

Under a sharding plan (`train.sharding.use_plan`) the dry run hands the
model DTensors (`launch.specs`).  DTensor propagates the layouts of the
matrix products and elementwise ops itself, but the kernels' plain
versions (five-dimensional einsums over grouped heads, chunked scans) are
not ops it knows how to shard.  Each function here has the signature of
the kernel wrapper it stands for and calls that wrapper unchanged on
plain tensors.  On DTensors it brings the inputs to a layout in which the
call splits into independent per-device calls (the batch over the
data-parallel mesh dims the input already shards it on, the heads over
``model`` where they divide), runs the wrapper on each device's local
shards (`run_local`: the plain version on the CPU, the kernel on the
card), and wraps the local results again.  Only the redistributes move
data, so the collectives the dry run counts are those of the layout.

`flash_decode` and `cache_insert` also take a cache sharded on its
sequence (the ``kv_len`` fallback where the kv heads do not divide the
``model`` axis): each device attends over its slice of the positions and
the slices are merged by their log-sum-exp (split-KV decoding), a
gather of (B, H) scalars and a sum of the (B, 1, H, D) partial outputs
across the mesh dims that shard the sequence.  A slice's attention is the
plain version's (`_decode_partial`): the kernel returns no log-sum-exp,
so a sequence-sharded cache on the card raises where it would run.

`embedding` is the lookup into a vocab-sharded table as GSPMD partitions
it: a masked local lookup a device and a sum across the vocab's shards;
`label_logprob` and `logsumexp` keep the loss's logits sharded on their
vocab the same way.
`run_local` declares the gradient of an input that is replicated along a
mesh dim splitting the work a partial sum there, so that the backward
adds the devices' shares.

While the dry run counts costs (`launch.roofline.CostMode` registers
itself in ``COUNTER``), a kernel's local call is costed as the kernel on
the card: its FLOPs (`*_flops`, the work the kernel does: a causal mask's
visible half of the scores), its operands' and results' bytes, and
results of the right shapes with nothing computed behind them, so that no
plain version's intermediate (an attention's (Sq, Skv) scores) enters the
counts or the peak memory.  Its backward is costed as the port's: the
plain version's recompute and its two gradient products, 3x the
forward's FLOPs.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from ..kernels.flash_attention.ops import flash_attention as _flash_attention
from ..kernels.flash_decode.ops import flash_decode as _flash_decode
from ..kernels.ssd_scan.ops import ssd_scan as _ssd_scan
from .layers import cache_insert as _cache_insert

F32 = torch.float32

COUNTER: list = [None]  # the dry run's cost counter, while it counts


def kernel_call(fn: Callable, inputs: Sequence, outputs: Sequence, flops: float):
    """``fn(*inputs)``, a kernel's call on local tensors.  While a cost
    counter is registered, its stand-in instead: results shaped as
    ``outputs`` ((shape, dtype) each) counted at ``flops`` (see the
    module's docstring).  Returns what ``fn`` returns (a tensor, or a
    tuple for several ``outputs``)."""
    counter = COUNTER[0]
    if counter is None:
        return fn(*inputs)
    out = counter.kernel(inputs, outputs, flops)
    return out if len(outputs) > 1 else out[0]


def attention_flops(q, k, causal: bool, window) -> float:
    """The kernel's FLOPs for q (b, Sq, H, D) over k (b, Skv, K, D): 4 D a
    visible (query, key) pair a head; query i sits at position Skv - Sq + i."""
    b, Sq, H, D = q.shape
    Skv = k.shape[1]
    if not causal:
        return 4.0 * b * H * Sq * Skv * D
    lo, hi = Skv - Sq + 1, Skv             # keys seen by the first and last query
    w = hi if window is None else window

    def total(a, z):                       # a + (a + 1) + ... + z
        return (a + z) * (z - a + 1) / 2 if z >= a else 0.0

    pairs = total(lo, min(hi, w)) + w * max(hi - max(lo, w + 1) + 1, 0)
    return 4.0 * b * H * pairs * D


@functools.cache
def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


def shard_dims(x, dim: int) -> list:
    """The mesh dims on which the DTensor ``x`` is sharded along ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]


def layout(ndim: int, shards: dict) -> tuple:
    """Placements over ``ndim`` mesh dims: ``Shard(shards[i])`` on mesh dim i
    where given, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(shards[i]) if i in shards else Replicate() for i in range(ndim))


def run_local(fn: Callable, args: Sequence, in_layouts: Sequence, out_layouts, mesh):
    """``fn`` on each device's shards: every DTensor in ``args`` is brought
    to its entry of ``in_layouts`` and passed as its local tensor (other
    arguments as they are); each local result is wrapped as a DTensor laid
    out as its entry of ``out_layouts`` (one layout for a single result).
    Differentiable: gradients flow back through the local tensors.  An
    input replicated on a mesh dim that splits the work (one that shards
    another input or a result) takes a different share of the work on each
    device of that dim, so its gradient there is a partial sum: it is
    reduced straight to the input's own layout (a reduce-scatter where the
    input is sharded there), the layout of the gradients it meets from its
    other uses."""
    from torch.distributed.tensor import Partial, Replicate

    from ..train.sharding import redistribute

    outs = out_layouts if isinstance(out_layouts[0], tuple) else (out_layouts,)
    split = {i for pl in [*(pl for a, pl in zip(args, in_layouts) if is_dtensor(a)), *outs]
             for i, p in enumerate(pl) if not isinstance(p, Replicate)}

    def to_local(a, pl):
        own = tuple(a.placements)
        r = redistribute(a, mesh, pl)
        partial = tuple(Partial() if isinstance(p, Replicate) and i in split else p
                        for i, p in enumerate(pl))
        if partial != tuple(pl) and a.requires_grad:
            r = _ReduceGrad.apply(r, partial, own)
        return r.to_local(grad_placements=pl)

    local = [to_local(a, pl) if is_dtensor(a) else a for a, pl in zip(args, in_layouts)]
    out = fn(*local)
    from torch.distributed.tensor import DTensor

    if isinstance(out_layouts[0], tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_layouts))
    return DTensor.from_local(out, mesh, out_layouts, run_check=False)


class _ReduceGrad(torch.autograd.Function):
    """Identity on a DTensor; its gradient, which holds each device's
    partial sum where ``partial`` says so, is reduced to the layout
    ``own``."""

    @staticmethod
    def forward(ctx, x, partial, own):
        ctx.partial, ctx.own = partial, own
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        g = DTensor.from_local(g.to_local(), g.device_mesh, ctx.partial, run_check=False)
        return g.redistribute(g.device_mesh, ctx.own), None, None


def _per_device(fn, t, dims):
    """``fn(t)`` for an ``fn`` that acts along the dims ``dims`` of t
    only: per device on a DTensor, those dims whole on each."""
    from torch.distributed.tensor import Shard

    keep = {i: p.dim for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim not in dims}
    pl = layout(t.device_mesh.ndim, keep)
    return run_local(fn, (t,), (pl,), pl, t.device_mesh)


def pad(t, widths):
    """``F.pad(t, widths)`` (zeros); on a DTensor per device, its padded
    dims whole on each (DTensor's own rule for pad fails on some layouts
    in the torch of the card's host)."""
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, widths)
    return _per_device(lambda tl: torch.nn.functional.pad(tl, widths), t,
                       {t.ndim - 1 - k // 2 for k in range(len(widths))})


def roll(t, shift: int, dim: int):
    """``torch.roll(t, shift, dims=dim)``; on a DTensor per device, ``dim``
    whole on each (the card host's torch has no DTensor rule for it)."""
    if not is_dtensor(t):
        return torch.roll(t, shift, dims=dim)
    return _per_device(lambda tl: torch.roll(tl, shift, dims=dim), t, {dim % t.ndim})


def own_grad(w):
    """``w``; on a DTensor its gradient brought to w's own layout, so that
    the gradients of a weight used twice (a tied embedding's lookup and
    logits) add in one layout (the card host's torch cannot add a
    sharded gradient to a partial one)."""
    if not is_dtensor(w):
        return w
    from ..train.sharding import relayout

    return relayout(w, w.device_mesh, tuple(w.placements))


def copy_into(dst, src):
    """``dst.copy_(src)``, a DTensor ``src`` first brought to ``dst``'s
    layout."""
    if is_dtensor(dst) and is_dtensor(src):
        from ..train.sharding import redistribute

        src = redistribute(src, dst.device_mesh, tuple(dst.placements))
    return dst.copy_(src)


def split_heads(t, n: int, hd: int):
    """t (..., n * hd) -> (..., n, hd).  A DTensor sharded on its last dim
    over more devices than divide ``n`` gathers that dim first (DTensor
    splits a sharded dim only into evenly sharded ones)."""
    if is_dtensor(t):
        dims = shard_dims(t, t.ndim - 1)
        size = 1
        for i in dims:
            size *= t.device_mesh.size(i)
        if n % size:
            from ..train.sharding import redistribute

            keep = {i: p.dim for i, p in enumerate(t.placements)
                    if i not in dims and hasattr(p, "dim")}
            t = redistribute(t, t.device_mesh, layout(t.device_mesh.ndim, keep))
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t):
    """t (..., n, hd) -> (..., n * hd).  On a DTensor the result's gradient
    is brought back to the result's layout before the reshape's backward
    splits it again (which a dim sharded over more devices than divide n
    cannot be)."""
    out = t.reshape(*t.shape[:-2], -1)
    if not is_dtensor(out):
        return out
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out.to_local(grad_placements=out.placements), out.device_mesh,
                              out.placements, run_check=False)


def head_dim_of(mesh, taken: Sequence[int], n_heads: int):
    """The ``model`` mesh dim, where it can shard ``n_heads`` heads and
    shards nothing else of the tensor (``taken``); else None."""
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    i = names.index("model")
    m = mesh.size(i)
    if i in taken or m == 1 or n_heads % m:
        return None
    return i


def _coordinate(mesh, dims: Sequence[int]) -> int:
    """This device's index among the shards of the mesh dims ``dims``
    (the first one major, as DTensor nests them)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def embedding(tokens, table):
    """``F.embedding(tokens, table)``; on DTensors the lookup GSPMD makes
    into a table sharded on its vocab: each device looks its tokens (the
    batch as they shard it) up in its slice of the vocab (the model dim
    whole, gathered where FSDP shards it), zeros for a token outside the
    slice, and the slices' partial sums are added across the mesh dims
    that shard the vocab (by the layout the caller asks for next)."""
    if not is_dtensor(table):
        return torch.nn.functional.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, layout(mesh.ndim, {}), run_check=False)
    bd = shard_dims(tokens, 0)
    vd = [i for i in shard_dims(table, 0) if i not in bd]

    def local(tl, wl):
        n = wl.shape[0]
        lo = _coordinate(mesh, vd) * n
        inside = (tl >= lo) & (tl < lo + n)
        out = torch.nn.functional.embedding((tl - lo).clamp(0, n - 1), wl)
        return out * inside[..., None].to(out.dtype)

    out_pl = tuple(Partial() if i in vd else p
                   for i, p in enumerate(layout(mesh.ndim, {i: 0 for i in bd})))
    return run_local(local, (tokens, table), (layout(mesh.ndim, {i: 0 for i in bd}),
                                              layout(mesh.ndim, {i: 0 for i in vd})),
                     out_pl, mesh)


def flash_attention(q, k, v, *, causal: bool = True, scale=None, window=None):
    """`kernels.flash_attention.ops.flash_attention`, per device on
    DTensors: the batch as q shards it, the query heads over ``model``
    where they divide it (each device then takes the kv heads of its query
    heads, repeated to one a query head, where the kv heads do not)."""
    if not is_dtensor(q):
        return _flash_attention(q, k, v, causal=causal, scale=scale, window=window)
    mesh = q.device_mesh
    bd = shard_dims(q, 0)
    H, K = q.shape[2], k.shape[2]
    hd = head_dim_of(mesh, bd, H)
    split_kv = hd is not None and K % mesh.size(hd) == 0
    shards = {i: 0 for i in bd}
    qpl = layout(mesh.ndim, {**shards, **({hd: 2} if hd is not None else {})})
    kvpl = qpl if hd is None or split_kv else layout(mesh.ndim, shards)

    def local(ql, kl, vl):
        if hd is not None and not split_kv:  # this shard's query heads' kv heads
            h0 = _coordinate(mesh, [hd]) * ql.shape[2]
            heads = torch.arange(h0, h0 + ql.shape[2], device=kl.device) // (H // K)
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        return kernel_call(
            lambda *a: _flash_attention(*a, causal=causal, scale=scale, window=window),
            (ql, kl, vl), [(ql.shape, ql.dtype)], attention_flops(ql, kl, causal, window))

    return run_local(local, (q, k, v), (qpl, kvpl, kvpl), qpl, mesh)


def _cache_layout(cache):
    """(batch dims, sequence dims, kv-head dims) of a DTensor cache."""
    return shard_dims(cache, 0), shard_dims(cache, 1), shard_dims(cache, 2)


def cache_insert(cache, new, index):
    """`layers.cache_insert` (an int ``index``) on a DTensor cache: the
    device whose slice of the sequence holds ``index`` writes the token, in
    place in its local shard."""
    if not is_dtensor(cache):
        return _cache_insert(cache, new, index)
    if not isinstance(index, int):
        raise NotImplementedError("a sharded cache takes one int position")
    from ..train.sharding import redistribute

    mesh = cache.device_mesh
    bd, sd, kd = _cache_layout(cache)
    new_l = redistribute(new, mesh, layout(mesh.ndim, {**{i: 0 for i in bd}, **{i: 2 for i in kd}})).to_local()
    c = cache.to_local()
    off = _coordinate(mesh, sd) * c.shape[1]
    if off <= index < off + c.shape[1]:
        _cache_insert(c, new_l, index - off)
    return cache


def _decode_partial(q, k, v, lens: int, off: int, scale: float):
    """Attention of q (b, 1, H, D) over cache positions [off, off + S) of
    k, v (b, S, K, D), masked at ``lens``: the fp32 output normalised
    within the slice and its log-sum-exp (b, 1, H) (-inf for a slice with
    no valid position)."""
    b, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, 1, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    valid = torch.arange(off, off + S, device=q.device) < lens
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / den.clamp_min(1e-30), v.float())
    lse = (m + torch.log(den))[..., 0]                  # (b, K, G, 1)
    return o.reshape(b, 1, H, D), lse.permute(0, 3, 1, 2).reshape(b, 1, H)


def flash_decode(q, k_cache, v_cache, cache_len, *, scale: float):
    """`kernels.flash_decode.ops.flash_decode` on DTensors: per device over
    the batch and kv heads as the cache shards them; a cache sharded on
    its sequence is attended slice by slice and merged (split-KV)."""
    if not is_dtensor(k_cache):
        return _flash_decode(q, k_cache, v_cache, cache_len, scale=scale)
    mesh = k_cache.device_mesh
    bd, sd, kd = _cache_layout(k_cache)
    qpl = layout(mesh.ndim, {**{i: 0 for i in bd}, **{i: 2 for i in kd}})
    cpl = layout(mesh.ndim, {**{i: 0 for i in bd}, **{i: 1 for i in sd}, **{i: 2 for i in kd}})
    def flops(ql, kl):
        return 4.0 * ql.shape[0] * ql.shape[2] * min(kl.shape[1], cache_len) * ql.shape[3] \
            if isinstance(cache_len, int) else 4.0 * ql.numel() * kl.shape[1]

    if not sd:
        return run_local(
            lambda ql, kl, vl: kernel_call(
                lambda *a: _flash_decode(*a, cache_len, scale=scale), (ql, kl, vl),
                [(ql.shape, ql.dtype)], flops(ql, kl)),
            (q, k_cache, v_cache), (qpl, cpl, cpl), qpl, mesh)
    if not isinstance(cache_len, int):
        raise NotImplementedError("a sequence-sharded cache takes one int length")
    from torch.distributed.tensor import DTensor, Partial

    def partial(ql, kl, vl):
        if kl.is_cuda and COUNTER[0] is None:
            raise NotImplementedError(
                "flash_decode has no log-sum-exp output for a sequence-sharded "
                "cache's slices; on the card the cache shards its batch or heads")
        off = _coordinate(mesh, sd) * kl.shape[1]
        b, _, h, D = ql.shape
        o, lse = kernel_call(
            lambda *a: _decode_partial(*a, cache_len, off, scale), (ql, kl, vl),
            [(ql.shape, F32), ((b, 1, h), F32)], flops(ql, kl))
        return o, lse[..., None]

    lse_pl = layout(mesh.ndim, {**{i: 0 for i in bd}, **{i: 2 for i in kd}, **{i: 3 for i in sd}})
    o, lse = run_local(partial, (q, k_cache, v_cache), (qpl, cpl, cpl),
                       (qpl, lse_pl), mesh)
    # every slice's log-sum-exp on every device of the sequence dims
    lse_all = lse.redistribute(mesh, qpl).to_local()           # (b, 1, h, n)
    own = lse.to_local()[..., 0]
    w = torch.exp(own - torch.logsumexp(lse_all, -1))          # (b, 1, h)
    part = o.to_local() * torch.nan_to_num(w)[..., None]
    summed = tuple(Partial() if i in sd else p for i, p in enumerate(qpl))
    out = DTensor.from_local(part, mesh, summed, run_check=False)
    return out.redistribute(mesh, qpl).to(q.dtype)


def ssd_scan(x, dt, A, B, C, *, chunk: int):
    """`kernels.ssd_scan.ops.ssd_scan` per device on DTensors: the batch as
    x shards it, the heads over ``model`` where they divide it (B and C,
    shared by the heads, on every device of that dim)."""
    if not is_dtensor(x):
        return _ssd_scan(x, dt, A, B, C, chunk=chunk)
    mesh = x.device_mesh
    bd = shard_dims(x, 0)
    hd = head_dim_of(mesh, bd, x.shape[2])
    heads = {hd: 2} if hd is not None else {}
    batch = {i: 0 for i in bd}
    xpl = layout(mesh.ndim, {**batch, **heads})
    apl = layout(mesh.ndim, {hd: 0} if hd is not None else {})
    bpl = layout(mesh.ndim, batch)
    spl = layout(mesh.ndim, {**batch, **({hd: 1} if hd is not None else {})})
    def local(xl, *rest):
        b, S, H, P = xl.shape
        N, Q = rest[2].shape[-1], min(chunk, S)
        # within chunks C B^T (Q x Q) and its product with x; across them
        # the states' update and readout
        flops = 2.0 * b * S * H * (Q * (N + P) + 2 * P * N)
        return kernel_call(lambda *a: _ssd_scan(*a, chunk=chunk), (xl,) + rest,
                           [(xl.shape, F32), ((b, H, P, N), F32)], flops)

    return run_local(local, (x, dt, A, B, C), (xpl, xpl, apl, bpl, bpl), (xpl, spl), mesh)


def state_readout(state, c):
    """The ssm decode's ``(state @ c[:, None, :, None])[..., 0]``, state
    (B, H, P, N), c (B, N): per device on DTensors, over the batch and
    heads as the state shards them."""
    if not is_dtensor(state):
        return (state @ c[:, None, :, None])[..., 0]
    mesh = state.device_mesh
    spl = layout(mesh.ndim, {**{i: 0 for i in shard_dims(state, 0)},
                             **{i: 1 for i in shard_dims(state, 1)}})
    cpl = layout(mesh.ndim, {i: 0 for i in shard_dims(state, 0)})
    return run_local(lambda s, cl: (s @ cl[:, None, :, None])[..., 0], (state, c),
                     (spl, cpl), spl, mesh)


def _vocab_layouts(x):
    """(the mesh dims sharding the vocab, x's layout, its rows' layout) of
    x (B, S, V): the batch and sequence dims as x shards them."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    rows = {i: p.dim for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim < 2}
    vd = shard_dims(x, 2)
    return vd, layout(mesh.ndim, {**rows, **{i: 2 for i in vd}}), layout(mesh.ndim, rows)


def _reduced(t, vd, op: str):
    """The layout ``t`` (rows) over the vocab's mesh dims ``vd``: a partial
    ``op`` there, as each device holds its slice's share."""
    from torch.distributed.tensor import Partial

    return tuple(Partial(op) if i in vd else p for i, p in enumerate(t))


def logsumexp(x):
    """``torch.logsumexp(x, -1)`` of x (B, S, V); on DTensors over a vocab
    sharded across devices as Megatron's vocab-parallel loss takes it:
    each device's slice's max, their max (an all-reduce of (B, S)
    scalars), each slice's sum of exponentials, their sum.  DTensor would
    gather the whole vocab on every device instead."""
    if not is_dtensor(x):
        return torch.logsumexp(x, -1)
    from ..train.sharding import redistribute

    mesh = x.device_mesh
    vd, xpl, rows = _vocab_layouts(x)
    if not vd:                          # the vocab whole on each device
        return run_local(lambda xl: torch.logsumexp(xl, -1), (x,), (xpl,), rows, mesh)
    m = run_local(lambda xl: xl.detach().amax(-1), (x,), (xpl,), _reduced(rows, vd, "max"),
                  mesh)
    m = redistribute(m, mesh, rows)
    s = run_local(lambda xl, ml: torch.exp(xl - ml[..., None]).sum(-1), (x, m),
                  (xpl, rows), _reduced(rows, vd, "sum"), mesh)
    return m + torch.log(redistribute(s, mesh, rows))


def label_logprob(logits, labels):
    """The log-probability of each label (B, S) under ``softmax(logits)``,
    logits (B, S, V) fp32 (a label below 0 reads label 0's):
    ``log_softmax`` and a gather, per device on DTensors.  Where the
    vocab is sharded, vocab-parallel: each device gathers the labels in
    its slice of the vocab (zeros for the others), the slices' sum less
    `logsumexp` (DTensor's own log-softmax and the gather's backward would
    hold the whole (B, S, V) on each device)."""
    def plain(x, lab):
        logp = torch.nn.functional.log_softmax(x, dim=-1)
        return torch.gather(logp, -1, lab.clamp_min(0).long()[..., None])[..., 0]

    if not is_dtensor(logits):
        return plain(logits, labels)
    from ..train.sharding import redistribute

    mesh = logits.device_mesh
    vd, xpl, rows = _vocab_layouts(logits)
    if not vd:                          # the vocab whole on each device
        return run_local(plain, (logits, labels), (xpl, rows), rows, mesh)

    def picked(xl, lab):
        n = xl.shape[-1]
        lo = _coordinate(mesh, vd) * n
        lab = lab.clamp_min(0).long()
        inside = (lab >= lo) & (lab < lo + n)
        z = torch.gather(xl, -1, (lab - lo).clamp(0, n - 1)[..., None])[..., 0]
        return z * inside.to(z.dtype)

    z = run_local(picked, (logits, labels), (xpl, rows), _reduced(rows, vd, "sum"), mesh)
    return redistribute(z, mesh, rows) - logsumexp(logits)


def along_sequence(fn: Callable, *xs):
    """``fn(*xs)`` for tensors (B, S, C) of one layout that ``fn`` combines
    along S only (a scan): per device on DTensors, the batch and the
    channels as the first one shards them, the sequence whole."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    mesh = xs[0].device_mesh
    pl = layout(mesh.ndim, {**{i: 0 for i in shard_dims(xs[0], 0)},
                            **{i: 2 for i in shard_dims(xs[0], 2)}})
    return run_local(fn, xs, (pl,) * len(xs), pl, mesh)
