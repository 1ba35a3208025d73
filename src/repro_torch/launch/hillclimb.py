"""Perf hill-climbing harness (`repro.launch.hillclimb`): re-cost a dry-run
cell under a named variant (config / sharding-rule / loss changes),
re-derive the roofline terms, and append the comparison to a JSON log.

Each variant is a hypothesis; this file is only the measurement mechanism
(`launch.dryrun`'s traced step and `launch.roofline`'s H100 cost model).
A variant whose knob the port does not have (``big_blocks``: attention
tile sizes) is reported as ``"status": "not_applicable"`` with the reason.
Run it in a process of its own (the fake process group of `launch.mesh`).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama3-405b \
      --shape train_4k --variant baseline --variant loss_onehot ...
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

from ..configs import get_config, get_smoke_config
from ..models.config import SHAPES
from ..optim import AdamWConfig
from ..train.sharding import default_rules, make_plan
from .dryrun import _local_bytes, extrapolated_cost, mesh_for
from .roofline import Roofline, model_flops_estimate
from .specs import input_specs


@dataclasses.dataclass
class Variant:
    name: str
    cfg_overrides: Dict = dataclasses.field(default_factory=dict)
    rules_fn: Optional[Callable] = None      # mutate rules dict in place
    loss_impl: str = "gather"
    n_microbatches: int = 1
    opt_overrides: Dict = dataclasses.field(default_factory=dict)
    hypothesis: str = ""
    not_applicable: str = ""                 # why the port cannot run it


def _rules_batch_over_model(rules):
    """Small-model variant: no TP — shard batch over BOTH mesh axes and
    replicate weights over model (pure DP; avoids replicated attention
    when head counts don't divide the TP axis)."""
    for k in ("act_batch", "batch"):
        rules[k] = [("data", "model"), ("data",), None]
    for k in ("heads", "kv_heads", "ff", "vocab", "experts", "rnn",
              "inner", "act_heads", "act_ff", "act_vocab"):
        rules[k] = [None]
    return rules


def _rules_seq_shard_cache(rules):
    """Decode variant: force sequence-sharded KV cache."""
    rules["kv_len"] = [("model",), None]
    rules["kv_heads_cache"] = [None]
    return rules


def _rules_seq_parallel(rules):
    """Megatron-SP: activations sharded over `model` on the SEQUENCE dim
    at layer boundaries (where ops are elementwise over S), all-gathered
    inside attention/mlp by GSPMD. Saved-for-backward residuals shrink
    model_par-fold; the price is per-layer all-gather/reduce-scatter pairs
    that were already implied by the TP weight layout."""
    rules["act_seq"] = [("model",), None]
    return rules


def _rules_ep_replicated(rules):
    """MoE variant: replicate the experts, keep tokens local.

    EP (experts over `model`) pays an all-to-all on every layer's dispatch
    + return. When the per-layer expert weights are small (granite: ~100MB
    bf16 for all 32 experts), replicating them and routing locally deletes
    the dispatch collective entirely — EP is the wrong parallelism for
    small-expert MoE at 256 chips."""
    rules["experts"] = [None]
    rules["act_experts"] = [None]
    return rules


def _rules_weight_stationary(rules):
    """Decode variant: weights stay put, activations move.

    The default decode layout shards the batch over `data` and FSDP-shards
    weights over `data` too — so every matmul must all-gather its weight
    shard (O(params) ICI bytes per token). Here the batch is REPLICATED,
    weights stay sharded over (`data` on embed) x (`model` on heads/ff),
    and every contraction produces an activation-sized partial reduced
    over `data` — O(batch x d) bytes instead of O(params)."""
    for k in ("batch", "act_batch"):
        rules[k] = [None]
    rules["embed"] = [("data",), None]
    rules["kv_len"] = [("data",), None]       # cache sequence-sharded
    rules["kv_heads_cache"] = [None]
    rules["heads_cache"] = [("model",), None]
    return rules


def _rules_weight_stationary2(rules):
    """weight_stationary, iteration 2: the KV cache's 8 kv-heads cannot
    shard over model=16, so v1 left the cache only 16-way sharded (137
    GB/device — doesn't fit) and its reads doubled the memory term.
    Shard kv_len over BOTH mesh axes (32768/256 = 128 rows/device): cache
    back to 8.5 GB/device, attention psums over the full mesh."""
    rules = _rules_weight_stationary(rules)
    rules["kv_len"] = [("data", "model"), None]
    rules["heads_cache"] = [None]
    return rules


VARIANTS = {
    "baseline": Variant("baseline"),
    "loss_onehot": Variant(
        "loss_onehot", loss_impl="onehot",
        hypothesis="vocab-sharded CE removes the (B,S,V) logits "
                   "all-gather: collective and HBM terms drop"),
    "no_remat": Variant(
        "no_remat", cfg_overrides={"remat": "none"},
        hypothesis="recompute-free bwd: compute term drops ~25%, memory "
                   "(activations) rises"),
    "dp_only": Variant(
        "dp_only", rules_fn=_rules_batch_over_model,
        hypothesis="for models whose heads don't divide TP=16, pure-DP "
                   "batch sharding over 256 devices removes replicated "
                   "attention compute"),
    "seq_cache": Variant(
        "seq_cache", rules_fn=_rules_seq_shard_cache,
        hypothesis="sequence-sharded KV cache parallelizes decode "
                   "attention over the model axis at psum cost"),
    "microbatch4": Variant(
        "microbatch4", n_microbatches=4,
        hypothesis="4 microbatches cut activation memory ~4x; compute "
                   "unchanged; collective unchanged (grads reduced once)"),
    "big_blocks": Variant(
        "big_blocks", cfg_overrides={"attn_block_q": 1024,
                                     "attn_block_kv": 2048},
        hypothesis="bigger attention tiles reduce online-softmax "
                   "rescaling traffic per flop",
        not_applicable="the port's attention is the flash_attention kernel, "
                       "whose tiles are fixed by its source; ModelConfig "
                       "has no attn_block_q / attn_block_kv"),
    "remat_dots": Variant(
        "remat_dots", cfg_overrides={"remat": "dots"},
        hypothesis="save matmul outputs, recompute only elementwise in "
                   "bwd: compute term drops ~25% vs block remat, "
                   "activation memory stays far below remat=none"),
    "fused_kv": Variant(
        "fused_kv", cfg_overrides={"fused_prefill_kv": True},
        hypothesis="prefill builds the decode cache from the forward "
                   "pass's K/V projections: removes one full K/V "
                   "projection pass (compute + HBM)"),
    "weight_stationary": Variant(
        "weight_stationary", rules_fn=_rules_weight_stationary,
        hypothesis="decode: replicate the (tiny) batch, keep weights "
                   "sharded; collectives become activation-sized "
                   "partial-reductions instead of O(params) weight "
                   "all-gathers"),
    "int8_grads": Variant(
        "int8_grads", opt_overrides={"grad_compression": "int8"},
        hypothesis="int8(+error feedback) gradient all-reduce quarters "
                   "the gradient-reduction collective bytes vs fp32"),
    "weight_stationary2": Variant(
        "weight_stationary2", rules_fn=_rules_weight_stationary2,
        hypothesis="v1 + kv cache sharded over the full 256 (kv_len over "
                   "both axes): cache reads /16, memory term back below "
                   "baseline while keeping the collective win"),
    "local_dispatch": Variant(
        "local_dispatch", cfg_overrides={"moe_dispatch": "local"},
        hypothesis="per-group MoE dispatch: the token->expert "
                   "scatter never crosses devices, deleting the all-to-all "
                   "AND the buffer replication; expert weights all-gather "
                   "over DP (ordinary FSDP traffic) instead"),
    "local_dispatch_cap1": Variant(
        "local_dispatch_cap1",
        cfg_overrides={"moe_dispatch": "local", "capacity_factor": 1.0},
        hypothesis="local dispatch + capacity 1.0: buffer rows and expert "
                   "GEMM flops drop 20% at slightly higher drop rate"),
    "ep_replicated": Variant(
        "ep_replicated", rules_fn=_rules_ep_replicated,
        hypothesis="replicating small expert weights deletes the per-layer "
                   "dispatch all-to-all; collective term drops to the "
                   "gradient reduction only"),
    "padded_vocab": Variant(
        "padded_vocab", cfg_overrides={"vocab": 49408},
        hypothesis="granite's vocab 49155 is indivisible by 16 so logits "
                   "replicate over `model`; padding to 49408 (=16*3088) "
                   "restores vocab sharding: (B,S,V) memory/collective "
                   "drops ~16x at +0.5% flops"),
    "seq_parallel": Variant(
        "seq_parallel", rules_fn=_rules_seq_parallel,
        hypothesis="sequence-parallel activations at layer boundaries: "
                   "saved residuals (126 x 2.15GB for llama3-405b) shard "
                   "16x over model; temp memory drops toward fitting"),
    "micro16": Variant(
        "micro16", n_microbatches=16,
        hypothesis="16 microbatches: activation temp ~ /16, compute and "
                   "collectives unchanged (grads reduced once)"),
    "bf16_states": Variant(
        "bf16_states", opt_overrides={"state_dtype": "bfloat16"},
        hypothesis="bf16 AdamW moments: optimizer args drop from 12 to 8 "
                   "bytes/param and the update's f32 temp copies halve"),
    "llama_fit": Variant(
        "llama_fit", loss_impl="onehot", n_microbatches=16,
        opt_overrides={"state_dtype": "bfloat16"},
        rules_fn=_rules_seq_parallel,
        hypothesis="fit stack: 16x microbatch + SP residuals + bf16 "
                   "moments + vocab-sharded CE"),
    "dots_micro16": Variant(
        "dots_micro16", cfg_overrides={"remat": "dots"}, n_microbatches=16,
        hypothesis="remat=dots cut the compute+memory terms 11% but grew "
                   "temp 1.8x; 16x microbatching absorbs the temp growth "
                   "(saved dots are per-microbatch)"),
    "llama_combo": Variant(
        "llama_combo", loss_impl="onehot", n_microbatches=16,
        rules_fn=_rules_seq_parallel,
        hypothesis="compose: SP residuals + 16x microbatching + vocab-"
                   "sharded CE -> per-device temp under 16GB HBM"),
    "granite_combo": Variant(
        "granite_combo", loss_impl="onehot",
        cfg_overrides={"moe_dispatch": "local", "vocab": 49408},
        hypothesis="compose the three independent fixes: local dispatch "
                   "(no replicated (Tk,d) staging), padded vocab 49408 "
                   "(logits shard over model), onehot CE (logits stay "
                   "sharded through the loss)"),
    "onehot_micro4": Variant(
        "onehot_micro4", loss_impl="onehot", n_microbatches=4,
        hypothesis="compose the two confirmed train wins: vocab-sharded "
                   "CE + 4x microbatching"),
}


def run_variant(arch: str, shape_name: str, variant: Variant,
                multi_pod: bool = False, *, smoke: bool = False,
                mesh_name: Optional[str] = None) -> Dict:
    """One variant's roofline row for (arch x shape) on the production mesh
    (``mesh_name`` and ``smoke`` as in `launch.dryrun.run_cell`)."""
    mesh_name = mesh_name or ("2x16x16" if multi_pod else "16x16")
    row = dict(variant=variant.name, arch=arch, shape=shape_name, mesh=mesh_name,
               hypothesis=variant.hypothesis)
    if variant.not_applicable:
        return dict(row, status="not_applicable", reason=variant.not_applicable)
    cfg = get_smoke_config(arch) if smoke else get_config(arch, abstract=True)
    if variant.cfg_overrides:
        cfg = cfg.scaled(**variant.cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = mesh_for(mesh_name)
    rules = default_rules("pod" in (mesh.mesh_dim_names or ()))
    if variant.rules_fn is not None:
        rules = variant.rules_fn(rules)
    plan = make_plan(mesh, rules=rules)
    opt_cfg = AdamWConfig(**variant.opt_overrides)
    t0 = time.time()
    f, b, coll, peak, _ = extrapolated_cost(
        cfg, shape, plan, opt_cfg=opt_cfg, n_microbatches=variant.n_microbatches,
        loss_impl=variant.loss_impl)
    args = input_specs(cfg, shape, plan, opt_cfg=opt_cfg)
    roof = Roofline(flops=f, hbm_bytes=b, coll_bytes=coll, n_chips=mesh.size(),
                    model_flops=model_flops_estimate(cfg, shape),
                    per_device_peak_memory=peak)
    row.update(roof.row())
    row.update(status="ok", wall_s=round(time.time() - t0, 1),
               temp_bytes=max(peak - _local_bytes([a for a in args if not isinstance(a, int)]),
                              0.0))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--variant", action="append", required=True,
                    choices=list(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="cost the arch's smoke config")
    ap.add_argument("--mesh", default=None, choices=["16x16", "2x16x16", "2x2"],
                    help="override the production mesh")
    ap.add_argument("--out", default="perf_log.json")
    args = ap.parse_args(argv)
    rows = []
    for vname in args.variant:
        row = run_variant(args.arch.replace("-", "_"), args.shape,
                          VARIANTS[vname], multi_pod=args.multi_pod,
                          smoke=args.smoke, mesh_name=args.mesh)
        rows.append(row)
        if row["status"] != "ok":
            print(f"[{row['arch']}/{row['shape']}/{vname}] {row['status']}: "
                  f"{row['reason']}", flush=True)
            continue
        print(f"[{row['arch']}/{row['shape']}/{vname}] "
              f"bottleneck={row['bottleneck']} "
              f"t=(c {row['t_compute_s']:.3e}, m {row['t_memory_s']:.3e}, "
              f"x {row['t_collective_s']:.3e}) "
              f"frac={row['roofline_fraction']:.3f}", flush=True)
    log = []
    if os.path.exists(args.out):
        with open(args.out) as fh:
            log = json.load(fh)
    log.extend(rows)
    with open(args.out, "w") as fh:
        json.dump(log, fh, indent=1)
    print(f"appended {len(rows)} rows to {args.out}")
    return rows


if __name__ == "__main__":
    main()
