"""One rank of the port's sharded-path tests, run in a spawned process.

Imports torch and the port only (no JAX).  Joins a gloo group of 4 ranks
through the ``file://`` rendezvous it is given, builds the 2 x 2
``("data", "model")`` `DeviceMesh` over it, and runs its cases: each is
run twice on the same seeded weights and inputs, once on plain tensors
with no plan and once on DTensors laid out by the plan
(`train.sharding`), whose redistributes move real data between the
ranks.  Every result of the sharded run is saved as its ``full_tensor()``
beside the plain run's, to ``rank<r>.npz`` in the output directory, keys
``<case>/ref/<what>`` and ``<case>/shd/<what>``.

Case kinds:

- ``model``: a smoke config in fp32 through the forward pass, the
  prefill (cache of ``S + GEN`` positions), ``GEN`` greedy-fed decode
  steps and one AdamW train step (the updated weights and moments);
- ``moe``: one MoE layer (`models.moe.moe`) on tokens and weights given in
  an ``.npz``; the sharded run's dispatches report the (token, expert)
  pairs they kept, each rank its own.
"""
import datetime
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, model_specs
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params, is_spec
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve import make_prefill_step, make_serve_step
from repro_torch.train import make_train_step
from repro_torch.train.sharding import (batch_pspec, make_plan, placements, resolve_leaf,
                                        use_plan)

B, S, GEN = 4, 16, 2       # batch, prompt, decode steps
# AdamW's first step moves each weight by lr * g / (|g| + eps), about lr:
# 10x the tests' 1e-5, so a step that is missing or has the wrong sign
# shows.  A larger lr would show instead the first step's amplification of
# fp32 rounding in gradients near eps, which is Adam's, not the layout's;
# the gradients themselves are compared too, through the first moment.
OPT = AdamWConfig(lr_peak=1e-4, warmup_steps=1)


def _zip_specs(fn, specs, tree):
    if is_spec(specs):
        return fn(specs, tree)
    return {k: _zip_specs(fn, specs[k], tree[k]) for k in specs}


def _leaves(prefix, tree, out):
    """Flatten nested dicts/lists/tuples of tensors into ``out`` as numpy
    arrays (DTensors gathered whole)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(f"{prefix}.{k}", tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _leaves(f"{prefix}.{i}", t, out)
    elif isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
        out[prefix] = t.detach().float().numpy().copy()
    return out


def _seq_sharded(cache) -> bool:
    """Whether a KV cache's keys (stacked (L, B, S, K, D) DTensors) are
    sharded on their sequence."""
    if not isinstance(cache, dict):
        return False
    k = cache.get("k")
    if hasattr(k, "placements"):
        return any(getattr(p, "dim", None) == 2 for p in k.placements)
    return any(_seq_sharded(v) for v in cache.values())


def model_inputs(cfg: ModelConfig, seed: int):
    """The seeded batch: tokens, labels, and the encoder-decoder's frames;
    the decode steps' tokens."""
    rng = np.random.default_rng(seed)
    Sd = S // 2 if cfg.family == "encdec" else S
    out = {"tokens": rng.integers(0, cfg.vocab, (B, Sd)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, Sd)).astype(np.int32)}
    out["labels"][0, :3] = -1                      # masked positions
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (GEN, B, 1)).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(steps)


def run_model(cfg, params, batch, steps, shard):
    """forward, prefill, decode and one train step; ``shard`` lays the
    weights and inputs out as DTensors (a callable ``(tensor, spec or
    None) -> tensor``)."""
    out = {}
    specs = model_specs(cfg)
    model = build_model(cfg, _zip_specs(lambda s, t: shard(t.clone(), s), specs, params),
                        device="cpu")
    b = {k: shard(v, None) for k, v in batch.items()}
    with torch.no_grad():
        if cfg.family == "encdec":
            logits, aux = model(b["tokens"], b["frames"])
            mem, cache = make_prefill_step(model, cfg)(b["frames"], S + GEN)
            _leaves("prefill", {"memory": mem}, out)
            index = 0
        else:
            logits, aux = model(b["tokens"])
            last, cache = make_prefill_step(model, cfg)(b["tokens"], S + GEN)
            _leaves("prefill", {"logits": last}, out)
            index = S
        _leaves("forward", {"logits": logits, "aux": aux}, out)
        _leaves("prefill_cache", cache, out)
        out["seq_sharded"] = np.array(_seq_sharded(cache))
        step = make_serve_step(model, cfg)
        for i in range(GEN):
            nxt, logits, cache = step(cache, shard(steps[i], None), index + i)
            _leaves(f"decode{i}", {"next": nxt, "logits": logits}, out)
        _leaves("decode_cache", cache, out)
    opt = adamw_init(model.param_tree())
    opt, metrics = make_train_step(model, cfg, OPT)(opt, b)
    grads = _leaves("grad", opt["mu"], {})     # mu = (1 - b1) g after one step
    out.update({f"train.{k}": v / (1 - OPT.b1) for k, v in grads.items()})
    _leaves("train", {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                      "params": model.param_tree()}, out)
    return out


def run_moe(case, p, x, shard):
    cfg = ModelConfig(**case["cfg"])
    kept = []

    def record(_, xt, disp):
        tok = torch.arange(xt.shape[0])[:, None].expand_as(disp.expert_ids)
        kept.append(torch.stack([tok[disp.keep], disp.expert_ids[disp.keep]], 1).numpy())

    specs = moe_mod.moe_specs(cfg)
    w = SimpleNamespace(**{k: shard(v, specs[k]) for k, v in p.items()})
    with moe_mod.observe(record):
        out, aux = moe_mod.moe(w, cfg, shard(x, None))
    res = _leaves("moe", {"out": out, "aux": aux}, {})
    res["n_dispatches"] = np.array(len(kept))
    for i, k in enumerate(kept):
        res[f"kept{i}"] = k
    return res


def run_case(case, plan, shard):
    """{"ref": the plain run's results, "shd": the sharded run's} of one
    case."""
    from torch.distributed.tensor.experimental import implicit_replication

    if case["kind"] == "model":
        cfg = get_smoke_config(case["arch"]).scaled(dtype="float32",
                                                    **case.get("overrides", {}))
        params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                             device="cpu")
        batch, steps = model_inputs(cfg, seed=1)
        results = {"ref": run_model(cfg, params, batch, steps, lambda t, s: t)}
        with implicit_replication(), use_plan(plan):
            results["shd"] = run_model(cfg, params, batch, steps, shard)
        return results
    data = np.load(case["data"])
    p = {k: torch.from_numpy(data[k]) for k in ("w_router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(data["x"])
    results = {"ref": run_moe(case, p, x, lambda t, s: t)}
    with implicit_replication(), use_plan(plan):
        results["shd"] = run_moe(case, p, x, shard)
    return results


def run(rank, world, init_method, cases, out_dir):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    torch.set_num_threads(1)   # tiny shapes; the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        plan = make_plan(mesh)

        def shard(t, spec):
            pspec = (resolve_leaf(spec, plan) if spec is not None
                     else batch_pspec(plan, t.ndim, t.shape[0]))
            return distribute_tensor(t, mesh, placements(pspec, mesh))

        saved = {"coordinate": np.array(mesh.get_coordinate())}
        for case in cases:
            name = case["name"]
            try:
                results = run_case(case, plan, shard)
            except Exception as e:  # the case fails, the others run
                saved[f"{name}/error"] = np.array(f"{type(e).__name__}: {e}"[:2000])
                continue
            for side, res in results.items():
                for k, v in res.items():
                    saved[f"{name}/{side}/{k}"] = v
        np.savez(f"{out_dir}/rank{rank}.npz", **saved)
    finally:
        dist.destroy_process_group()


def spawn(cases, out_dir, world: int = 4, timeout: float = 240):
    """Run ``cases`` on ``world`` spawned ranks meeting under ``out_dir``;
    returns each rank's saved arrays.  A rank that fails or outlives
    ``timeout`` seconds fails the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = f"file://{out_dir}/rendezvous"
    procs = [ctx.Process(target=run, args=(r, world, init, cases, str(out_dir)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        assert not any(p.is_alive() for p in procs), "a rank did not finish"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(f"{out_dir}/rank{r}.npz")) for r in range(world)]
