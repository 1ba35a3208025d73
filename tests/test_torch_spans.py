"""Where the port's hot path opens its spans (`repro_torch.obs.trace.span`).

Profiled CPU runs at the smoke widths, read through the benchmark's own
reduction of the profiler's events (`ocpbench.trace.from_kineto`): each
MoE call enters ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` once, on the plain path and on the sharded one
(`models.moe._moe_sharded`, DTensors over the fake 2 x 2 mesh); each decode
step enters ``serve.decode_step`` once and each `DataPipeline.get_batch`
``data.get_batch`` once; each Mamba-2 mixer call enters ``ssm.inputs``,
``ssm.scan`` and ``ssm.output`` once, and each of its decode steps
``ssm.decode``; a train step still enters ``train_step.forward``,
``.backward`` and ``.optimizer``, and the kernels' backwards
``moe_gemm.recompute`` and ``flash_attention.recompute``, under the names
the benchmark's readers look for.
"""
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, PipelineConfig, TokenStore
from repro_torch.kernels.flash_attention.ops import FlashAttention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gemm.ops import MoeGemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.ssd_scan.ops import SsdScan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.train_step import make_train_step
from torch_fake_world import mesh2x2  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from ocpbench import trace as bench_trace  # noqa: E402

MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def profiled(fn):
    """(fn's result, the names of the ranges entered, each with its count)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    entered = {}
    for name, _, _ in bench_trace.from_kineto(prof).ranges:
        entered[name] = entered.get(name, 0) + 1
    return out, entered


def granite(**overrides):
    cfg = get_smoke_config("granite-moe-1b-a400m").scaled(dtype="float32", **overrides)
    return cfg, build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def count_dispatches():
    seen = []
    return seen, moe_mod.observe(lambda p, xt, disp: seen.append(xt.shape[0]))


def tokens(cfg, B=2, S=8, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)


def test_each_moe_call_enters_the_four_spans_once():
    cfg, model = granite()
    seen, hook = count_dispatches()
    with torch.no_grad(), hook:
        _, entered = profiled(lambda: model(tokens(cfg)))
    assert len(seen) == cfg.n_layers
    for name in MOE_SPANS:
        assert entered.get(name) == cfg.n_layers, name


def test_the_sharded_moe_enters_the_four_spans_once(mesh2x2):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.sharding import (batch_pspec, make_plan, placements,
                                            resolve_leaf, use_plan)

    cfg = get_smoke_config("granite-moe-1b-a400m").scaled(dtype="float32")
    plan = make_plan(mesh2x2)
    specs = moe_mod.moe_specs(cfg)
    g = torch.Generator().manual_seed(1)
    p = {k: 0.1 * torch.randn(s.shape, generator=g) for k, s in specs.items()}
    x = torch.randn(4, 8, cfg.d_model, generator=g)

    def shard(t, spec):
        pspec = (resolve_leaf(spec, plan) if spec is not None
                 else batch_pspec(plan, t.ndim, t.shape[0]))
        return distribute_tensor(t, mesh2x2, placements(pspec, mesh2x2))

    seen, hook = count_dispatches()
    with implicit_replication(), use_plan(plan), torch.no_grad(), hook:
        w = SimpleNamespace(**{k: shard(v, specs[k]) for k, v in p.items()})
        xs = shard(x, None)
        (out, _), entered = profiled(lambda: moe_mod.moe(w, cfg, xs))
    assert out.shape == x.shape and hasattr(out, "placements") and len(seen) == 1
    for name in MOE_SPANS:
        assert entered.get(name) == 1, name


def test_each_decode_step_enters_its_span_once():
    cfg, model = granite()
    prefill, step = make_prefill_step(model, cfg), make_serve_step(model, cfg)
    prompts = tokens(cfg, S=6)

    def serve():
        logits, cache = prefill(prompts, cache_len=10)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        for j in range(3):
            tok, _, cache = step(cache, tok, 6 + j)
        return tok

    seen, hook = count_dispatches()
    with torch.inference_mode(), hook:
        _, entered = profiled(serve)
    assert entered.get("serve.decode_step") == 3
    assert len(seen) == 4 * cfg.n_layers  # the prefill and three steps
    for name in MOE_SPANS:
        assert entered.get(name) == len(seen), name


def test_each_get_batch_enters_its_span_once():
    docs, S = 8, 16
    corpus = np.random.default_rng(0).integers(0, 100, size=(docs, S + 5))
    store = TokenStore(*corpus.shape, cuboid=(4, 8), device="cpu")
    store.ingest_corpus(corpus)
    pipe = DataPipeline(store, PipelineConfig(seq_len=S, global_batch=4, seed=2))
    batches, entered = profiled(lambda: [pipe.get_batch(s) for s in range(3)])
    assert entered.get("data.get_batch") == 3
    assert batches[0]["tokens"].shape == (4, S)


@pytest.fixture
def kernel_functions(monkeypatch):
    """The MoE's expert GEMM and the attention through `MoeGemm` and
    `FlashAttention` (the card's route) with the plain versions as their
    forwards, so that a CPU step reaches their backward recomputes."""
    def attention(q, k, v, *, causal=True, scale=None, window=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return FlashAttention.apply(q, k, v, causal, scale, window, flash_attention_ref)

    monkeypatch.setattr(attn_mod, "flash_attention", attention)
    monkeypatch.setattr(moe_mod, "moe_gemm",
                        lambda *a: MoeGemm.apply(*a, moe_gemm_ref))


def test_a_train_step_enters_its_parts_and_the_recomputes(kernel_functions):
    cfg, model = granite()
    assert cfg.remat == "block"
    step = make_train_step(model, cfg, AdamWConfig(), n_microbatches=2)
    opt = adamw_init(model.param_tree())
    toks = tokens(cfg, B=4, S=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    seen, hook = count_dispatches()
    with hook:
        _, entered = profiled(lambda: step(opt, batch))
    L = cfg.n_layers
    assert entered.get("train_step.forward") == 2
    assert entered.get("train_step.backward") == 4  # each microbatch's and its sum
    assert entered.get("train_step.optimizer") == 1
    assert entered.get("moe_gemm.recompute") == 2 * L
    assert entered.get("flash_attention.recompute") == 2 * L
    # under ``block`` each layer's forward runs again in the backward
    assert len(seen) == 2 * 2 * L
    for name in MOE_SPANS:
        assert entered.get(name) == len(seen), name


def test_the_scan_backward_enters_its_recompute():
    g = torch.Generator().manual_seed(5)
    B, S, H, P, N, chunk = 1, 8, 2, 4, 4, 4
    x = torch.randn(B, S, H, P, generator=g, requires_grad=True)
    dt = torch.rand(B, S, H, generator=g) + 0.1
    A = -torch.rand(H, generator=g)
    Bm = torch.randn(B, S, N, generator=g)
    Cm = torch.randn(B, S, N, generator=g)

    def run():
        y, _ = SsdScan.apply(x, dt, A, Bm, Cm, chunk, ssd_scan_ref)
        return torch.autograd.grad(y.sum(), (x,))

    (gx,), entered = profiled(run)
    assert gx.shape == x.shape
    assert entered.get("ssd_scan.recompute") == 1


SSM_SPANS = ("ssm.inputs", "ssm.scan", "ssm.output")


def mamba(**overrides):
    cfg = get_smoke_config("mamba2-370m").scaled(dtype="float32", **overrides)
    return cfg, build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_each_ssm_block_enters_its_three_spans_once():
    cfg, model = mamba()
    with torch.no_grad():
        _, entered = profiled(lambda: model(tokens(cfg, S=2 * cfg.ssm_chunk)))
    for name in SSM_SPANS:
        assert entered.get(name) == cfg.n_layers, name
    assert "ssm.decode" not in entered


def test_each_ssm_decode_step_enters_its_span_once():
    cfg, model = mamba()
    prefill, step = make_prefill_step(model, cfg), make_serve_step(model, cfg)
    prompts = tokens(cfg, S=6)

    def serve():
        logits, cache = prefill(prompts, cache_len=10)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        for j in range(3):
            tok, _, cache = step(cache, tok, 6 + j)
        return tok

    with torch.inference_mode():
        _, entered = profiled(serve)
    assert entered.get("ssm.decode") == 3 * cfg.n_layers
    for name in SSM_SPANS:  # the prefill's pass
        assert entered.get(name) == cfg.n_layers, name


def test_an_ssm_train_step_enters_the_mixer_spans_twice_a_layer():
    """Under ``block`` each layer's mixer runs again in the backward."""
    cfg, model = mamba()
    assert cfg.remat == "block"
    step = make_train_step(model, cfg, AdamWConfig(), n_microbatches=2)
    opt = adamw_init(model.param_tree())
    toks = tokens(cfg, B=4, S=cfg.ssm_chunk + 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, entered = profiled(lambda: step(opt, batch))
    for name in SSM_SPANS:
        assert entered.get(name) == 2 * 2 * cfg.n_layers, name
