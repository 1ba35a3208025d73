"""The harness on the CPU: each cell's loop at the smoke widths through
`harness.run_cell` and the fields of its result, a small saved trace
through every reader, and the command's refusal without a card."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from ocpbench import harness, trace
from ocpbench.counts import moe_lm as counts

import smoke

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", smoke.workloads())
def test_untraced_run_reports_the_end_to_end_metrics(workload):
    out = smoke.run(workload)
    assert list(out) == KEYS  # the checks come last
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    c = smoke.cell(workload)
    assert sorted(out["metrics"]) == sorted(m["name"] for m in c.end_to_end)
    assert "setup_s" in out["metrics"]
    for name, m in out["metrics"].items():
        assert m["value"] > 0 and m["unit"] == next(e["unit"] for e in c.end_to_end
                                                     if e["name"] == name)
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    assert sorted(out["checks"]) == sorted(c.limits)
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(out)


@pytest.mark.parametrize("workload", smoke.workloads())
def test_traced_run_reports_per_layer_metrics(workload):
    out = smoke.run(workload, traced=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    c = smoke.cell(workload)
    names = {m["name"] for m in c.per_layer}
    assert set(out["metrics"]) <= names
    # on the CPU only the host clock's and the program's counters read
    # anything: no device time, no peak
    host = {n for n in names if n.split(".")[0] in
            ("data_ms", "prefill_ms", "decode_step_ms", "moe_drop_share", "moe_experts_touched")}
    assert set(out["metrics"]) == host
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def saved_run():
    ev = trace.from_json(smoke.load(ROOT / "ocpbench/tests/data/trace_small.json"))
    summary = trace.summarize(ev, window_s=6e-6)
    m = smoke.GRANITE
    mix = {"batch": 2, "prompt": 4, "new_tokens": 2, "seq_len": 4, "microbatches": 1,
           "phase_of": {"moe_gemm_roofline": "prefill", "flash_attention_roofline": "prefill",
                        "moe_drop_share": "prefill"}}
    recs = [dict(phase="prefill", traced=True, counts=[3, 1, 0, 0, 0, 0, 0, 4], C=3,
                 picks=32, dropped=1),
            dict(phase="prefill", traced=False, counts=[3, 1, 0, 0, 0, 0, 0, 4], C=3,
                 picks=32, dropped=2)]
    return harness.Run(model=m, mix=mix, peaks=counts.peaks("NVIDIA H100 80GB HBM3"),
                       trace=summary, dispatches=recs, host={"data_s": [0.002, 0.004]},
                       calls={"flash_attention": [(2, 4)], "flash_decode": [(2, 5)]},
                       launches={"flash_attention": 1, "flash_decode": 2, "moe_gemm": 2})


def test_saved_trace_union_and_ranges():
    run = saved_run()
    s = run.trace
    # [150, 650] and [600, 900] overlap: 750 ns, not 800
    assert s.busy_s == pytest.approx((750 + 100 + 200 + 100 + 100 + 300 + 500) * 1e-9)
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == (30e-9, [(0, 20), (30, 40)])
    assert s.ranges["ocpbench.prefill"] == pytest.approx(900e-9)
    assert s.ranges["ocpbench.decode"] == pytest.approx(400e-9)
    assert s.breakdown["device_ops"][0][0].startswith("void flash_attention_tc")
    assert s.breakdown["idle_gaps"][0] == ["aten::item", pytest.approx(1450e-9)]
    assert ["aten::argmax", pytest.approx(100e-9)] in s.breakdown["idle_gaps"]


def read(name, run):
    return harness.reader(name.split(".")[0]).read(name, run)


def test_every_reader_on_the_saved_trace():
    run = saved_run()
    pk = run.peaks
    assert read("idle_share.x", run) == pytest.approx(100 * (1 - 2050 / 6000))
    assert read("optimizer_ms.x", run) == pytest.approx(300e-6)
    assert read("recompute_ms.x", run) == pytest.approx(500e-6)
    assert read("data_ms.x", run) == pytest.approx(3.0)
    assert read("moe_drop_share.x", run) == pytest.approx(100 * 2 / 32)
    fa = counts.least_s(*counts.flash_attention_call(run.model, 2, 4), pk)
    assert read("flash_attention_roofline.x", run) == pytest.approx(100 * fa / 500e-9)
    mg = counts.least_s(*counts.moe_gemm_call(run.model, 3, [3, 1, 0, 0, 0, 0, 0, 4]), pk)
    assert read("moe_gemm_roofline.x", run) == pytest.approx(100 * mg / 400e-9)
    fd = counts.least_s(*counts.flash_decode_call(run.model, 2, [5, 5]), pk)
    assert read("flash_decode_roofline.x", run) == pytest.approx(100 * 2 * fd / 200e-9)
    # the decode range's ops span 1,150-1,700 ns on the device, busy 400
    assert read("decode_idle_ms.x", run) == pytest.approx(150e-6)
    # nothing to read: no value, never a 0 share
    run.host, run.dispatches = {}, []
    for name in ("data_ms.x", "prefill_ms.x", "decode_step_ms.x", "moe_drop_share.x",
                 "moe_gemm_roofline.x", "mfu.x"):
        assert read(name, run) is None, name
    run.calls = {}
    for name in ("decode_idle_ms.x", "flash_attention_roofline.x", "flash_decode_roofline.x"):
        assert read(name, run) is None, name


def test_mfu_reads_the_window_steps():
    run = saved_run()
    run.mix = dict(run.mix, phase_of={"mfu": "prefill"})
    run.host = {"prefill_s": [0.5, 0.3]}
    least = counts.prefill_flops(run.model, 2, 4) / run.peaks["flops"]
    assert read("mfu.x", run) == pytest.approx(100 * least / 0.4)


def test_every_per_layer_metric_has_a_reader():
    for m in smoke.bench()["per_layer"]:
        assert hasattr(harness.reader(m["name"].split(".")[0]), "read"), m["name"]


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "ocpbench/run.py", "--workload",
                          smoke.workloads()[0], "--seed", str(2 ** 33), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def spans_run(phase=None):
    """A saved trace of a train step, a prefill and two decode steps with
    the program's spans inside the benchmark's phase ranges."""
    ev = trace.from_json(smoke.load(ROOT / "ocpbench/tests/data/trace_spans.json"))
    families = ("moe_dispatch_ms", "moe_idle_ms", "moe_experts_touched")
    recs = [dict(phase="decode", traced=False, counts=[1, 0, 0, 2, 0, 0, 1, 0], C=2, picks=4,
                 dropped=0),
            dict(phase="decode", traced=False, counts=[0, 1, 0, 2, 0, 0, 0, 0], C=2, picks=4,
                 dropped=1),
            dict(phase="prefill", traced=False, counts=[3, 1, 1, 1, 1, 1, 1, 4], C=3, picks=32,
                 dropped=0)]
    return harness.Run(model=smoke.GRANITE, mix={"phase_of": {f: phase for f in families}},
                       peaks=counts.peaks("NVIDIA H100 80GB HBM3"),
                       trace=trace.summarize(ev, window_s=3e-5), dispatches=recs, host={},
                       calls={}, launches={})


def test_span_readers_on_the_saved_trace():
    # data.get_batch holds 100-1,900 ns on the host; the device ran 600-900
    assert read("data_idle_ms.x", spans_run()) == pytest.approx(1500e-6)
    # routing ops (route, dispatch, combine; not experts) by phase: the
    # step's 400 + 400 + 200 ns, the prefill's 200 + 400 + 100, the two
    # decode steps' 50 + 50 and 80 + 40 over 2 steps; everything at once
    assert read("moe_dispatch_ms.x", spans_run("train")) == pytest.approx(1000e-6)
    assert read("moe_dispatch_ms.x", spans_run("prefill")) == pytest.approx(700e-6)
    assert read("moe_dispatch_ms.x", spans_run("decode")) == pytest.approx(110e-6)
    assert read("moe_dispatch_ms.x", spans_run()) == pytest.approx(1920e-6)
    # the prefill's four MoE spans cover 11,000-13,000 ns; the device ran
    # 11,100-11,700, 11,900-12,500 and 12,700-12,800 of it; at decode
    # 800 - 200 and 800 - 220 ns over 2 steps
    assert read("moe_idle_ms.x", spans_run("prefill")) == pytest.approx(700e-6)
    assert read("moe_idle_ms.x", spans_run("decode")) == pytest.approx(590e-6)
    # 4 and 5 ops launched inside the two serve.decode_step spans (one op
    # of the decode range lies outside both)
    assert read("decode_launches.x", spans_run()) == pytest.approx(4.5)
    # 3 and 2 experts with a pick in the two decode dispatches
    assert read("moe_experts_touched.x", spans_run("decode")) == pytest.approx(2.5)
    assert read("moe_experts_touched.x", spans_run("prefill")) == pytest.approx(8.0)


def test_span_readers_read_nothing_without_the_device():
    run = spans_run("prefill")
    run.trace.ops, run.trace.busy = [], []  # a CPU run: ranges but no device op
    for name in ("data_idle_ms.x", "moe_dispatch_ms.x", "moe_idle_ms.x", "decode_launches.x"):
        assert read(name, run) is None, name
    run.trace = None
    run.dispatches = []
    for name in ("data_idle_ms.x", "moe_dispatch_ms.x", "moe_idle_ms.x", "decode_launches.x",
                 "moe_experts_touched.x"):
        assert read(name, run) is None, name


def test_the_command_keeps_python_bytecode_in_the_checkout():
    child = ("import runpy, sys; runpy.run_path('ocpbench/run.py', run_name='x'); "
             "print(sys.pycache_prefix, sys.dont_write_bytecode)")
    out = subprocess.run([sys.executable, "-c", child], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(ROOT / "build" / "pycache"), "False"]
