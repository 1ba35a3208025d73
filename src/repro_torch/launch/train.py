"""Training driver: Morton data pipeline -> train step -> AdamW, under
checkpoint/restart supervision.

  python -m repro_torch.launch.train --arch smollm-135m --smoke \\
      --device cpu                                    # plain path, CPU
  python -m repro_torch.launch.train --arch mamba2-370m --smoke --device cpu \\
      --ckpt-dir ckpt --ckpt-every 5 --inject-failure-at 8
  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --seq-len 2048 --batch 16 --microbatches 2      # on the card

(with ``src`` on ``PYTHONPATH``).  The dense, MoE and ssm families train;
the weights are drawn from seed 0 and the corpus is the JAX driver's
synthetic Zipf corpus (the same numpy draws).  With ``--ckpt-dir`` the
steps run under `ft.TrainingSupervisor`: a checkpoint every
``--ckpt-every`` steps in the JAX package's format (`ckpt`), and a
failure injected before step ``--inject-failure-at`` is recovered by a
restore and a replay.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..carry import train_state_from_tree, train_state_to_tree
from ..configs import get_config, get_smoke_config
from ..data import DataPipeline, PipelineConfig, TokenStore
from ..device import DeviceLike, resolve_device
from ..ft import FailureInjector, StragglerMonitor, TrainingSupervisor
from ..models import build_model
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from ..train import make_train_step


def build_state(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda"):
    """(model, optimizer state): weights drawn from ``seed`` on the device,
    fp32 masters copied from them, zero moments."""
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
    """Train; returns ``losses`` (one per step run, replays included),
    ``recoveries`` (the supervisor's log) and ``state``, the final train
    state as its checkpoint tree (`carry.train_state_to_tree`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.inject_failure_at is not None and not args.ckpt_dir:
        ap.error("--inject-failure-at needs --ckpt-dir (recovery restores from it)")

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
    monitor = StragglerMonitor(n_workers=1)

    def one_step(opt, step):
        t0 = time.perf_counter()
        opt, metrics = step_fn(opt, pipe.get_batch(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.record(0, time.perf_counter() - t0)
        if step % 5 == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return opt

    recoveries = []
    try:
        if args.ckpt_dir:
            injector = (None if args.inject_failure_at is None
                        else FailureInjector({args.inject_failure_at: 0}))
            sup = TrainingSupervisor(args.ckpt_dir, ckpt_every=args.ckpt_every,
                                     injector=injector)
            opt = sup.run(opt, one_step, args.steps,
                          state_to_tree=lambda o: train_state_to_tree(model, o),
                          tree_to_state=lambda t, o: train_state_from_tree(t, model, o))
            recoveries = sup.recovery_log
            if recoveries:
                print("recoveries:", recoveries)
        else:
            for s in range(args.steps):
                opt = one_step(opt, s)
    finally:
        pipe.stop()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return {"losses": losses, "recoveries": recoveries,
            "state": train_state_to_tree(model, opt)}


if __name__ == "__main__":
    main()
