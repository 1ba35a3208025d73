"""Batched serving driver: prefill by stepping the prompt, then decode.

  python -m repro_torch.launch.serve --arch smollm-135m --batch 32 \\
      --prompt-len 128 --gen 64                       # on the card
  python -m repro_torch.launch.serve --arch smollm-135m --smoke \\
      --device cpu                                    # plain path, CPU

(with ``src`` on ``PYTHONPATH``).  Weights are drawn from seed 0; rates are
printed with the device they were measured on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import build_model, init_params
from ..serve import ContinuousBatcher, Request, make_serve_step


def zero_cache(model, cfg, B: int, cache_len: int):
    """A zero KV cache for ``B`` sequences on the model's device."""
    return init_params(model.cache_specs(B, cache_len), None, device=model.device)


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "CPU"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching engine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=dev)
    where = device_name(dev)

    B = args.batch
    cache_len = args.prompt_len + args.gen
    rng = np.random.default_rng(0)
    if args.continuous:
        eng = ContinuousBatcher(model, cfg, n_slots=B, cache_len=cache_len,
                                device=dev)
        n_req = 2 * B + 1           # backlog > slots: slots must recycle
        t0 = time.perf_counter()
        for rid in range(n_req):
            plen = int(rng.integers(4, args.prompt_len + 1))
            eng.submit(Request(rid, rng.integers(0, cfg.vocab, size=plen).tolist(),
                               args.gen))
        done = eng.run()
        dt = time.perf_counter() - t0
        total = sum(len(v) for v in done.values())
        print(f"continuous batching: {len(done)} requests over {B} slots")
        print(f"occupancy {eng.occupancy:.2f}, {total / dt:.1f} gen tok/s on {where}")
        return done
    serve_step = make_serve_step(model, cfg)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, args.prompt_len))
                               .astype(np.int32)).to(dev)
    cache = zero_cache(model, cfg, B, cache_len)
    # prefill by stepping the prompt (batched requests share steps)
    t0 = time.perf_counter()
    for i in range(args.prompt_len):
        nxt, _, cache = serve_step(cache, prompts[:, i:i + 1], i)
    generated = [nxt]
    for j in range(args.gen - 1):
        nxt, _, cache = serve_step(cache, generated[-1], args.prompt_len + j)
        generated.append(nxt)
    _sync(dev)
    dt = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)
    total_tokens = B * (args.prompt_len + args.gen - 1)
    print(f"served {B} sequences, {args.gen} new tokens each")
    print(f"throughput {total_tokens / dt:.1f} tok/s on {where}")
    print("sample:", out[0, :12].tolist())
    return out


if __name__ == "__main__":
    main()
