"""Training driver: Morton data pipeline -> train step -> AdamW.

  python -m repro_torch.launch.train --arch smollm-135m --smoke \\
      --device cpu                                    # plain path, CPU
  python -m repro_torch.launch.train --arch smollm-135m --seq-len 2048 \\
      --batch 16 --microbatches 2                     # on the card

(with ``src`` on ``PYTHONPATH``).  The dense family trains; the weights are
drawn from seed 0 and the corpus is the JAX driver's synthetic Zipf corpus
(the same numpy draws).  Checkpoints and failure injection are not ported
yet.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..data import DataPipeline, PipelineConfig, TokenStore
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from ..train import make_train_step

_LATER_FAMILIES = {
    "moe": "ROADMAP A8 (MoE training: moe_gemm under an autograd Function)",
    "ssm": "ROADMAP A8 (ssm training: ssd_scan under an autograd Function)",
}


def build_state(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda"):
    """(model, optimizer state): weights drawn from ``seed`` on the device,
    fp32 masters copied from them, zero moments."""
    if cfg.family in _LATER_FAMILIES:
        raise NotImplementedError(f"training the {cfg.family} family is not in the "
                                  f"port yet; see {_LATER_FAMILIES[cfg.family]}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(cfg, device=dev, generator=gen)
    return model, adamw_init(model.param_tree())


def synthetic_corpus(cfg: ModelConfig, n_docs: int = 256, doc_len: int = 1024,
                     seed: int = 0, device: DeviceLike = "cuda") -> TokenStore:
    """A Zipf-ish synthetic corpus through the Morton token store: the JAX
    driver's corpus, drawn by the same numpy calls."""
    rng = np.random.default_rng(seed)
    store = TokenStore(n_docs, doc_len, cuboid=(16, min(4096, doc_len)), device=device)
    ranks = np.arange(1, cfg.vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab, size=(n_docs, doc_len), p=probs)
    store.ingest_corpus(toks)
    return store


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.ckpt_dir or args.inject_failure_at is not None:
        raise NotImplementedError("checkpoints and failure injection are not in the "
                                  "port yet; see ROADMAP A6 and A12")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model, opt = build_state(cfg, device=dev)
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=5, total_steps=args.steps,
                          grad_compression=args.grad_compression)
    step_fn = make_train_step(model, cfg, opt_cfg, n_microbatches=args.microbatches)
    store = synthetic_corpus(cfg, doc_len=args.seq_len + 1 + 64, device=dev)
    pipe = DataPipeline(store, PipelineConfig(seq_len=args.seq_len,
                                              global_batch=args.batch))

    losses = []
    for step in range(args.steps):
        batch = pipe.get_batch(step)
        opt, metrics = step_fn(opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 5 == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    pipe.stop()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return {"losses": losses}


if __name__ == "__main__":
    main()
