"""The SSM cell on the CPU at smoke widths: the port's ssm LM against the
plain reference (`reference/ssm_lm.py`) on seeded weights with Mamba-2's
published A and dt init, through the cell's own check; the reference's
quadratic form against the step-by-step recurrence; the faults and the
control that the limits have to fail; the frozen counts; and the three
new readers on a small trace built here."""
import math

import numpy as np
import pytest
import torch

from ocpbench import files, harness, trace
from ocpbench.counts import moe_lm, ssm_lm

import smoke

CELL = "mamba2-370m.train-2k"
SEED = 2 ** 33 + 7
FULL = harness.load_json(smoke.ROOT / "ocpbench/configs/mamba2-370m.json")["model"]


def kind(cell, seed, **model):
    cls = harness.kind(cell.mix["kind"], cell.here)
    config = dict(cell.config, model=dict(cell.config["model"], **model))
    return cls(config, cell.mix, seed, torch.device("cpu"), cell.here)


def fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits if k in readings)


@pytest.fixture(scope="module")
def cell():
    return smoke.cell(CELL)


@pytest.fixture(scope="module")
def sound(cell):
    """One run's set-up (the program's three checked steps) and check."""
    tr = kind(cell, SEED)
    tr.setup()
    tr.free()
    return tr, tr.check()


# ------------------------------------------------- program and reference ----

def test_the_smoke_cell_crosses_a_chunk(cell):
    m, mix = cell.config["model"], cell.mix
    assert mix["seq_len"] >= 2 * m["ssm_chunk"] and m["family"] == "ssm"
    assert cell.limits.keys() >= {"batch_mismatch", "kernels_unlaunched", "grad_gap",
                                  "median_grad_gap", "update_gap"}


def test_the_port_in_fp32_computes_what_the_reference_computes(cell):
    """In fp32 the port and the reference part by round-off alone: the
    first loss, every leaf's clipped first gradient and its change after
    the checked steps."""
    tr = kind(cell, 5, dtype="float32")
    tr.setup()
    tr.free()
    got = tr.check()
    assert got["batch_mismatch"] == 0
    assert got["first_loss_gap"] < 1e-6
    for k in ("grad_gap", "median_grad_gap", "update_gap"):
        assert got[k] < 1e-5, (k, got[k])


def test_the_cell_passes_its_own_check(cell, sound):
    """bf16, as the cell runs: every leaf's gradient and change, and the
    first loss, within the cell's smoke limits."""
    tr, got = sound
    assert got["first_loss_gap"] < 5e-5
    assert set(tr.grad_norms) == set(tr.ref["grad_norms"]) == set(tr.change_norms)
    assert len(tr.grad_norms) == 13
    for k, limit in cell.limits.items():
        if k in got:
            assert got[k] <= limit, (k, got[k], limit)
    assert smoke.run(CELL)["correct"] is True


def test_the_published_init_reaches_program_and_reference(cell, sound):
    tr, _ = sound
    kinds = files.module(cell.here, "kinds", "train_ssm")
    pub = kinds.published_init(tr.m, SEED)
    L, H = tr.m["n_layers"], 2 * tr.m["d_model"] // tr.m["ssm_head_dim"]
    A = torch.exp(pub["A_log"])
    dt = torch.nn.functional.softplus(pub["dt_bias"].double())
    assert pub["A_log"].shape == pub["dt_bias"].shape == (L, H)
    assert float(A.min()) >= 1 and float(A.max()) <= 16
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    tree = tr.draw_weights()["blocks"]["ssm"]
    for k, v in pub.items():
        assert torch.equal(tree[k], v)
    assert not torch.equal(kinds.published_init(tr.m, SEED + 1)["A_log"], pub["A_log"])
    # the reference's steps start from the same values (the draw alone
    # gives ones)
    assert ("blocks/ssm/A_log", (L, H), "float32", "ones") in tr.reference.shapes(tr.m)
    seen = {}

    def start(m, hp, params, *args, **kwargs):
        seen.update({k: v.clone() for k, v in params["blocks"]["ssm"].items()})
        return {"losses": [], "grad_norms": {}}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr.reference, "train_steps", start)
        tr.reference_run()
    for k, v in pub.items():
        assert torch.equal(seen[k], v)


# ------------------------------------------------------ the quadratic form ----

def recurrence(x, dt, A, B, C, D, chunk=None):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t + D x_t;
    h set to 0 at each chunk's start where ``chunk`` is given."""
    b, S, H, P = x.shape
    h = torch.zeros(b, H, P, B.shape[-1], dtype=x.dtype)
    ys = []
    for t in range(S):
        if chunk and t % chunk == 0:
            h = torch.zeros_like(h)
        decay = torch.exp(dt[:, t] * A)                                # (b, H)
        h = decay[..., None, None] * h + (dt[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]) + D[:, None] * x[:, t])
    return torch.stack(ys, 1)


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_quadratic_form_is_the_recurrence(chunk, dtype):
    ref = files.module(files.HERE, "reference", "ssm_lm")
    g = torch.Generator().manual_seed(3)
    b, S, H, P, N = 2, 23, 3, 4, 6
    x = torch.randn(b, S, H, P, generator=g, dtype=dtype)
    B = torch.randn(b, S, N, generator=g, dtype=dtype)
    C = torch.randn(b, S, N, generator=g, dtype=dtype)
    # published-like: A in [1, 16], dt in [1e-3, 1e-1], and slow heads
    A = -torch.tensor([1.0, 4.0, 16.0], dtype=dtype)
    dt = torch.exp(torch.empty(b, S, H, dtype=dtype).uniform_(math.log(1e-3), math.log(1e-1),
                                                              generator=g))
    D = torch.rand(H, generator=g, dtype=dtype)
    got = ref.ssd(x, dt, A, B, C, chunk=chunk) + D[:, None] * x
    want = recurrence(x, dt, A, B, C, D, chunk)
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert torch.allclose(got, want, rtol=tol, atol=tol * float(want.abs().max()))


def test_the_dropped_carry_changes_the_scan():
    """The fault's output differs from the sound one past the first chunk
    alone; its gradient through L stays finite (no NaN from the -inf)."""
    ref = files.module(files.HERE, "reference", "ssm_lm")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 12, 2, 3, generator=g)
    dt = torch.full((1, 12, 2), 0.05, requires_grad=True)
    A = -torch.tensor([1.0, 2.0])
    B, C = torch.randn(1, 12, 4, generator=g), torch.randn(1, 12, 4, generator=g)
    whole, cut = ref.ssd(x, dt, A, B, C), ref.ssd(x, dt, A, B, C, chunk=4)
    assert torch.equal(whole[:, :4], cut[:, :4])
    assert not torch.allclose(whole[:, 4:], cut[:, 4:])
    (gdt,) = torch.autograd.grad(cut.sum(), dt)
    assert torch.isfinite(gdt).all()


# ------------------------------------------------- faults and the control ----

def test_a_dropped_carry_is_not_correct(cell, sound):
    tr, _ = sound
    fault = tr.readings(tr.ref, tr.reference_run(carry=False))
    assert fails(fault, cell.limits), fault


def test_an_unchanged_state_is_not_correct(cell, sound):
    tr, got = sound
    still = dict(losses=tr.losses, grad_norms=tr.grad_norms,
                 change_norms={k: 0.0 for k in tr.change_norms})
    reading = tr.readings(tr.ref, still)
    assert reading["update_gap"] == pytest.approx(1.0)
    assert fails(reading, cell.limits) and not fails(got, cell.limits)


def test_the_fp8_control_and_half_a_batch_are_not_correct(cell, sound):
    tr, _ = sound
    low = tr.readings(tr.ref, tr.reference_run("fp8"))
    assert fails(low, cell.limits), low
    half = tr.readings(tr.ref, tr.reference_run(
        "fp32", keep_rows=torch.arange(tr.mix["batch"] // 2)))
    assert fails(half, cell.limits), half


# ------------------------------------------------------------------ counts ----

def test_the_scan_bound_at_b4():
    """32 x 2,048, H 32, P 64, N 128, Q 256: the kernel table's bound."""
    pk = moe_lm.peaks("NVIDIA H100 80GB HBM3")
    flops, nbytes = ssm_lm.ssd_scan_call(FULL, 32, 2048)
    assert moe_lm.bound_by(flops, nbytes, pk) == "bytes"
    assert moe_lm.least_s(flops, nbytes, pk) * 1e3 == pytest.approx(0.262927, abs=5e-7)
    flops, nbytes = ssm_lm.ssd_scan_call(FULL, 8, 2048)  # a train-2k microbatch
    assert flops == 43_050_336_256 and nbytes == pytest.approx(2.2e8, rel=1e-2)


def test_the_scan_count_at_smoke_widths_by_hand():
    m = dict(ssm_expand=2, d_model=8, ssm_head_dim=4, ssm_state=2, ssm_chunk=3,
             dtype="bfloat16")  # H 4, P 4, N 2; S 5 = chunks of 3 and 2
    flops, nbytes = ssm_lm.ssd_scan_call(m, 1, 5)
    per = [2 * (q * (q + 1) // 2 * 6 + 2 * q * 8) for q in (3, 2)]
    assert flops == 4 * sum(per)
    assert nbytes == 2 * (5 * 16 + 2 * 5 * 2) + 4 * 5 * 16 + 4 * 5 * 4 + 4 * 4 + 4 * 4 * 4 * 2


def test_the_step_count_at_published_widths():
    from repro_torch.models import model_specs
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import ParamSpec, tree_leaves

    specs = tree_leaves(model_specs(ModelConfig(**FULL)))
    assert ssm_lm.params(FULL) == sum(math.prod(s.shape) for s in specs
                                      if isinstance(s, ParamSpec))
    assert ssm_lm.params(FULL) == 368_338_432
    flops = ssm_lm.train_step_flops(FULL, 16, 2048)
    assert flops == pytest.approx(7.9998e13, rel=1e-4)
    assert flops - 6 * ssm_lm.params(FULL) * 16 * 2048 == 6 * 48 * 16 * (
        2048 * 257 // 2 * (128 + 2048) + 2 * 2048 * 2048 * 128)


# ----------------------------------------------------------------- readers ----

def ssm_run(model):
    """A traced train step: the mixer's inputs (300 ns of device time, one
    op), its scan (the kernel, 500 ns, and a copy), its output (400 ns),
    and an optimizer op outside every ssm span; the window's steps."""
    ev = trace.Events(
        device=[("void at::native::elementwise_kernel<128, 4>(...)", 200, 500, 1),
                ("void tc::ssd_scan_tc<64, 128>(...)", 1200, 1700, 2),
                ("Memcpy DtoD (Device -> Device)", 1800, 1850, 3),
                ("nvjet_tst_64x64_64x13_4x1_v_bz_NNT", 2200, 2600, 4),
                ("void at::native::vectorized_elementwise_kernel<4>(...)", 4000, 4100, 5)],
        launches={1: 150, 2: 1100, 3: 1500, 4: 2100, 5: 3900},
        ranges=[("ocpbench.train_step", 0, 5000), ("ssm.inputs", 100, 1000),
                ("ssm.scan", 1000, 2000), ("ssm.output", 2000, 3000),
                ("train_step.optimizer", 3500, 4500)],
        host=[])
    mix = dict(batch=4, microbatches=2, seq_len=48,
               phase_of={"ssd_scan_roofline": "train", "ssm_mfu": "train",
                         "ssm_mixer_ms": "train"})
    return harness.Run(model=model, mix=mix, peaks=moe_lm.peaks("NVIDIA H100 80GB HBM3"),
                       trace=trace.summarize(ev, 6e-6), dispatches=[],
                       host={"step_s": [0.25, 0.35]}, calls={},
                       launches={"ssd_scan": 2, "cutout_gather": 0})


def read(name, run):
    return harness.reader(name.split(".")[0]).read(name, run)


def test_the_ssm_readers_on_a_trace(cell):
    m = cell.config["model"]
    run = ssm_run(m)
    assert read("ssm_mixer_ms.x", run) == pytest.approx(1e3 * 700e-9)
    least = 2 * moe_lm.least_s(*ssm_lm.ssd_scan_call(m, 2, 48), run.peaks)
    assert read("ssd_scan_roofline.x", run) == pytest.approx(100 * least / 500e-9)
    flops = ssm_lm.train_step_flops(m, 4, 48)
    assert read("ssm_mfu.x", run) == pytest.approx(100 * flops / 989e12 / 0.3)
    assert read("optimizer_ms.x", run) == pytest.approx(1e-4)


def test_the_ssm_readers_read_nothing_where_nothing_ran(cell):
    m = cell.config["model"]
    run = ssm_run(m)
    run.trace = trace.summarize(trace.Events([], {}, [("ocpbench.train_step", 0, 10)], []), 1e-6)
    assert read("ssm_mixer_ms.x", run) is None  # no span (a program without them)
    assert read("ssd_scan_roofline.x", run) is None  # no kernel op
    run = ssm_run(m)
    run.launches = {}
    assert read("ssd_scan_roofline.x", run) is None
    run.peaks, run.host = None, {}
    for name in ("ssd_scan_roofline.x", "ssm_mfu.x"):
        assert read(name, run) is None, name
    run = ssm_run(m)
    run.mix = dict(run.mix, phase_of={})
    assert read("ssm_mfu.x", run) is None
    run.trace = None
    assert read("ssm_mixer_ms.x", run) is None


def test_the_cell_names_its_files(cell):
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s", "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        ["recompute_ms.ssm", "optimizer_ms.ssm", "idle_share.ssm", "ssm_mixer_ms.ssm",
         "ssd_scan_roofline.ssm", "ssm_mfu.ssm"])
    assert cell.mix["kernels"] == ["ssd_scan", "cutout_gather"]
    full = harness.cell(smoke.bench(), CELL, smoke.ROOT)
    assert full.config["reduced"] == [] and full.config["model"]["n_layers"] == 48
    assert np.isclose(full.mix["lr_peak"], 1e-3) and full.mix["batch"] == 16
