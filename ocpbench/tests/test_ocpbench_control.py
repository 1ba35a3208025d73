"""The control and the faults at the smoke widths: the reference in fp8
in the program's place reads above the limits, and so does a run whose
timed path is broken underneath (a train step that leaves its state
unchanged, one that leaves half of the batch out, a served token altered
where it is produced, in every request or in one), each driven through
the rest of a run."""
import torch

from ocpbench import traffic
from ocpbench.reference import moe_lm as ref_lm

import smoke

TRAIN = "granite-moe-1b-a400m.train-2k"
SERVE = "arctic-480b-2l.gen-512"
SEED = 2 ** 33 + 21


def test_train_control_reads_above_the_limits():
    c = smoke.cell(TRAIN)
    tr = traffic.Train(c.config, c.mix, SEED, torch.device("cpu"))
    tr.setup()
    tr.free()
    prog = tr.check()
    low = tr.readings(tr.ref, tr.reference_run("fp8"))
    assert all(prog[k] <= c.limits[k] for k in low)
    assert any(low[k] > c.limits[k] and low[k] > 3 * prog[k] for k in low), (prog, low)


def test_serve_control_reads_above_the_limit():
    c = smoke.cell(SERVE)
    sv = traffic.BatchServe(c.config, c.mix, SEED, torch.device("cpu"))
    sv.setup()
    with torch.no_grad():
        sv.window(0.0, False)
    sv.free()
    prog = sv.check()
    served = sv.served[sv.sample()]
    low = sv.reference_logits(sv.sample(), served, sv.params, "fp8").argmax(-1)
    control = float(ref_lm.token_gaps(sv.ref, low).mean())
    assert prog["mean_gap"] <= c.limits["mean_gap"] < control


def unchanged_state(model, cfg, opt_cfg, n_microbatches=1):
    def step(opt, batch):
        return opt, {"loss": torch.zeros(())}

    return step


def half_batch(model, cfg, opt_cfg, n_microbatches=1):
    inner = traffic_make_train_step(model, cfg, opt_cfg, n_microbatches=n_microbatches)

    def step(opt, batch):
        return inner(opt, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    return step


traffic_make_train_step = traffic.make_train_step


def altered_token(model, cfg):
    inner = traffic_make_serve_step(model, cfg)

    def step(cache, token, index):
        nxt, logits, cache = inner(cache, token, index)
        nxt = nxt.clone()
        nxt[0, 0] = (nxt[0, 0] + 1) % cfg.vocab
        return nxt, logits, cache

    return step


traffic_make_serve_step = traffic.make_serve_step


def test_unchanged_state_is_not_correct(monkeypatch):
    monkeypatch.setattr(traffic, "make_train_step", unchanged_state)
    out = smoke.run(TRAIN)
    assert out["correct"] is False
    assert out["checks"]["update_gap"]["value"] == 1.0


def test_half_batch_is_not_correct(monkeypatch):
    monkeypatch.setattr(traffic, "make_train_step", half_batch)
    out = smoke.run(TRAIN)
    assert out["correct"] is False
    assert out["checks"]["grad_gap"]["value"] > out["checks"]["grad_gap"]["limit"]


def test_altered_token_is_not_correct(monkeypatch):
    monkeypatch.setattr(traffic, "make_serve_step", altered_token)
    for workload in (SERVE, "arctic-480b-2l.rag-2k"):
        out = smoke.run(workload)
        assert out["correct"] is False
        assert out["checks"]["mean_gap"]["value"] > out["checks"]["mean_gap"]["limit"]
        worst = out["checks"]["worst_request_gap"]
        assert worst["value"] > worst["limit"]


def altered_slot_once(model, cfg):
    """The last request's token altered at the second decode step of each
    batch: a fault confined to one slot."""
    inner = traffic_make_serve_step(model, cfg)
    first = []

    def step(cache, token, index):
        nxt, logits, cache = inner(cache, token, index)
        first.append(index)
        if index == first[0] + 1:
            nxt = nxt.clone()
            nxt[-1, 0] = (nxt[-1, 0] + 1) % cfg.vocab
        return nxt, logits, cache

    return step


def test_one_request_altered_is_not_correct(monkeypatch):
    monkeypatch.setattr(traffic, "make_serve_step", altered_slot_once)
    out = smoke.run(SERVE)
    assert out["correct"] is False
    worst = out["checks"]["worst_request_gap"]
    assert worst["value"] > worst["limit"]
