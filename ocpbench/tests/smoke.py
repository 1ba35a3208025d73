"""Smoke-width cells for the CPU tests: the real mixes with small sizes,
the configurations at the port's smoke widths, and limits for them.

A mix file's ``"smoke"`` block holds its small sizes, and a configuration
file's ``"smoke"`` block its ``model`` at small widths and its CPU
``limits`` by traffic kind; where a file has none, `SMALL`, `MODELS` and
`LIMITS` hold them (the cells the benchmark started with)."""
import json
import pathlib

import torch

from ocpbench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent

GRANITE = dict(name="granite-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, head_dim=16, d_ff=64, vocab=256, act="swiglu",
               tie_embeddings=True, rope_theta=10000.0, norm_eps=1e-6, dtype="bfloat16",
               remat="block", n_experts=8, top_k=4, capacity_factor=2.0,
               moe_dense_residual=False, router_aux_coef=0.01)
ARCTIC = dict(GRANITE, name="arctic-smoke", d_ff=96, top_k=2, tie_embeddings=False,
              capacity_factor=1.25, moe_dense_residual=True)
MODELS = {"granite-moe-1b-a400m": GRANITE, "arctic-480b-2l": ARCTIC}
SMALL = {"train-2k": dict(batch=4, seq_len=32, corpus_docs=16, corpus_pad=4),
         "rag-2k": dict(batch=4, prompt=16, new_tokens=4, cache_len=24),
         "gen-512": dict(batch=4, prompt=8, new_tokens=12, cache_len=24)}
# at these widths sound runs read ~2e-5 (first loss), ~3e-3 (worst
# leaf's gradient), ~3e-4 (median leaf's), ~1e-3 (change), at most ~7e-5
# (served tokens' mean gap) and ~3e-4 (the worst request's); the fp8
# control 5e-5-3e-4, ~1e-2, 3e-3 or more, ~5e-3 and 2.4e-4 or more on 12
# tokens a request; every token of one request altered 0.28 or more on
# the worst request: limits between the two where they separate
LIMITS = {"train": {"batch_mismatch": 0, "kernels_unlaunched": 0, "first_loss_gap": 5e-5,
                    "grad_gap": 5e-3, "median_grad_gap": 1e-3, "update_gap": 2e-3},
          "batch_serve": {"kernels_unlaunched": 0, "mean_gap": 1e-4,
                          "worst_request_gap": 1e-3}}


def bench(root=ROOT):
    return harness.load_json(root / "BENCHMARK.json")


def cell(workload: str, root=ROOT) -> harness.Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json at smoke widths
    (the benchmark's files under ``root / "ocpbench"``)."""
    c = harness.cell(bench(root), workload, root, here=root / "ocpbench")
    small = c.config.get("smoke", {})
    config = dict(c.config, **{k: v for k, v in small.items() if k != "limits"})
    config.pop("smoke", None)
    if "model" in c.config and "model" not in small:
        config["model"] = MODELS[c.entry["config"]]
    mix = dict(c.mix, **(c.mix["smoke"] if "smoke" in c.mix else SMALL[c.entry["traffic"]]))
    mix.pop("smoke", None)
    limits = small.get("limits", {}).get(mix["kind"]) or LIMITS[mix["kind"]]
    return harness.Cell(c.name, c.entry, config, mix, dict(limits), c.end_to_end, c.per_layer,
                        c.here)


def run(workload: str, seed: int = 2 ** 33 + 7, seconds: float = 0.0, traced: bool = False,
        c=None):
    import time

    return harness.run_cell(c or cell(workload), seed, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), log=lambda *_: None)


def workloads(root=ROOT):
    return [w["name"] for w in bench(root)["workloads"]]


def load(path):
    with open(path) as fh:
        return json.load(fh)
