"""The plain fp32 reference against the port's CPU path at the smoke
widths, in fp32: the served logits through the prefill and the decode
steps (capacity drops included), a training step's loss, gradients and
AdamW update.  Only this test imports the program beside the reference."""
import numpy as np
import pytest
import torch

from ocpbench import weights
from ocpbench.reference import moe_lm as ref
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.train_step import make_train_step

from smoke import ARCTIC, GRANITE

TOL = 1e-4  # fp32 on both sides; sums in other orders
HYPER = dict(lr_peak=1e-3, warmup_steps=10, total_steps=100, b1=0.9, b2=0.95, eps=1e-8,
             weight_decay=0.1, clip_norm=1.0)


def fp32(m):
    return dict(m, dtype="float32")


@pytest.mark.parametrize("m", [GRANITE, ARCTIC], ids=["granite", "arctic"])
def test_served_logits_match_the_port(m):
    m = fp32(m)
    B, P, G, seed = 6, 8, 5, 2 ** 32 + 11
    model = build_model(ModelConfig(**m), weights.draw(m, seed, "cpu"), device="cpu")
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, m["vocab"], (B, P), generator=gen, dtype=torch.int32)
    dropped = []
    seen = lambda p, xt, d: dropped.append(int(d.keep.numel() - d.keep.sum()))
    with torch.no_grad(), moe_mod.observe(seen):
        logits, cache = make_prefill_step(model, model.cfg)(prompts, cache_len=P + G)
        got = [logits[:, -1]]
        tok = got[0].argmax(-1, keepdim=True).to(torch.int32)
        served = [tok]
        step = make_serve_step(model, model.cfg)
        for j in range(G - 1):
            tok, lg, cache = step(cache, tok, P + j)
            got.append(lg[:, -1])
            served.append(tok)
    served = torch.cat(served, 1)
    want = ref.served_logits(m, weights.draw(m, seed, "cpu"),
                             torch.cat([prompts, served[:, :-1]], 1), P)
    # the capacity dispatch drops picks where a full expert can refuse one
    # (arctic's 1.25), none where each has a slot for every token
    # (granite's n_experts / top_k), on both sides
    dropless = m["capacity_factor"] * m["top_k"] >= m["n_experts"]
    assert (sum(dropped) == 0) if dropless else (sum(dropped) > 0)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert float(ref.token_gaps(want, served).max()) < TOL


def test_training_step_matches_the_port():
    m = fp32(GRANITE)
    seed, B, S = 2 ** 31 + 5, 4, 16
    gen = torch.Generator().manual_seed(4)
    rows = torch.randint(0, m["vocab"], (B, S + 1), generator=gen)
    batch = {"tokens": rows[:, :S].to(torch.int32), "labels": rows[:, 1:].to(torch.int32)}
    model = build_model(ModelConfig(**m), weights.draw(m, seed, "cpu"), device="cpu")
    opt = adamw_init(model.param_tree())
    step = make_train_step(model, model.cfg, AdamWConfig(**HYPER), n_microbatches=2)
    opt, met = step(opt, batch)
    prog_grads = {p: float(torch.linalg.vector_norm(mu)) / (1 - HYPER["b1"])
                  for p, mu in ref.tree_paths(opt["mu"])}

    params = weights.draw(m, seed, "cpu")
    got = ref.train_steps(m, HYPER, params, [(rows[:, :S], rows[:, 1:])], 2)
    assert float(met["loss"]) == pytest.approx(got["losses"][0], rel=1e-6)
    for p, n in got["grad_norms"].items():
        assert prog_grads[p] == pytest.approx(n, rel=TOL), p
    for (p, a), (_, b) in zip(ref.tree_paths(opt["master"]), ref.tree_paths(params)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-6, err_msg=p)


def test_fp8_control_departs_from_fp32():
    m = fp32(ARCTIC)
    seed, B, P = 9, 2, 12
    params = weights.draw(m, seed, "cpu")
    tokens = torch.randint(0, m["vocab"], (B, P + 3), generator=torch.Generator().manual_seed(1))
    hi = ref.served_logits(m, params, tokens, P, "fp32")
    lo = ref.served_logits(m, params, tokens, P, "fp8")
    gap = float((hi - lo).abs().max() / hi.abs().max())
    assert 1e-3 < gap < 0.5


def test_route_keeps_picks_in_token_order():
    c = dict(n_experts=4, top_k=1, capacity_factor=1.0, router_aux_coef=0.0)
    # every token to expert 0: capacity int(1.0 * 1 * 4 / 4) = 1 -> max(k, 1) = 1
    w = torch.zeros(2, 4)
    w[0, 0] = 10.0
    x = torch.ones(4, 2)
    ids, gates, keep, _ = ref.route(c, x, w, [4])
    assert ids[:, 0].tolist() == [0, 0, 0, 0]
    assert keep[:, 0].tolist() == [True, False, False, False]
    # two dispatches of 2 tokens: each keeps its first (capacity max(1, int(0.5)) = 1)
    _, _, keep, _ = ref.route(c, x, w, [2, 2])
    assert keep[:, 0].tolist() == [True, False, True, False]
