"""A cell joins through new files alone: a configuration with its own plain
reference and weight tree, a mix with its own small sizes, a traffic kind,
a kernel the harness had not counted, a reader of a program span and a
configuration without a model, all written under ``tmp_path`` and driven
through `harness.run_cell` and the control's lookup on the CPU.  Beside
it, the cells the benchmark had draw the same weights and read the same
values on the saved trace as before the lookups took a directory
(``data/before_open.json``, written by the harness as it stood then)."""
import hashlib
import json
import pathlib
import re

import pytest
import torch

from ocpbench import control, files, harness, rooflines, trace, traffic, weights
from ocpbench.counts import moe_lm as counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

import smoke

ROOT = pathlib.Path(__file__).resolve().parents[2]
BEFORE = smoke.load(ROOT / "ocpbench/tests/data/before_open.json")
DENSE, ROWS = "dense-test.fixed-2", "rows-test.sum-rows"

DENSE_REFERENCE = '''
"""A plain dense decoder (attention and a SwiGLU MLP in every layer), from
the MoE reference's parts."""
import torch

from ocpbench.reference import moe_lm as base
from ocpbench.reference.moe_lm import token_gaps  # noqa: F401


def shapes(m):
    L, d, V, f = m["n_layers"], m["d_model"], m["vocab"], m["d_ff"]
    H, K, hd, wdt = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["dtype"]
    out = [("embed", (V, d), wdt, "normal"), ("final_norm", (d,), "float32", "ones"),
           ("lm_head", (d, V), wdt, "normal"),
           ("blocks/ln1", (L, d), "float32", "ones"), ("blocks/ln2", (L, d), "float32", "ones"),
           ("blocks/attn/w_q", (L, d, H * hd), wdt, "normal"),
           ("blocks/attn/w_k", (L, d, K * hd), wdt, "normal"),
           ("blocks/attn/w_v", (L, d, K * hd), wdt, "normal"),
           ("blocks/attn/w_o", (L, H * hd, d), wdt, "normal"),
           ("blocks/mlp/w_gate", (L, d, f), wdt, "normal"),
           ("blocks/mlp/w_up", (L, d, f), wdt, "normal"),
           ("blocks/mlp/w_down", (L, f, d), wdt, "normal")]
    return sorted(out)


@torch.no_grad()
def served_logits(c, params, tokens, P, precision="fp32"):
    with base.no_tf32():
        x = params["embed"][tokens.long()].to(torch.float32)
        for i in range(c["n_layers"]):
            p = base.layer_params(params, i)
            x = x + base.attention(c, p["attn"], base.rms_norm(x, p["ln1"], c["norm_eps"]),
                                   precision)
            h = base.rms_norm(x, p["ln2"], c["norm_eps"])
            x = x + base.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"],
                                precision)
        return base.logits(c, params, x[:, P - 1:], precision)
'''

FIXED_BATCHES = '''
"""A closed loop of a fixed number of batches (the mix's ``batches``),
however long the window."""
import torch

from ocpbench.traffic import BatchServe, now


class Kind(BatchServe):
    def window(self, seconds, traced):
        self.served, self.ttft = [], []
        t0 = now()
        with torch.inference_mode():
            for i in range(self.mix["batches"]):
                served, ttft = self.run_batch(self.prompts(i), timed=traced)
                self.served.append(served)
                self.ttft.append(ttft)
        self.window_s = now() - t0
        self.attempted, self.failed, self.calls = len(self.served) * self.mix["batch"], 0, {}
'''

SUM_ROWS = '''
"""Row sums of a table drawn from the seed, on the device; no model."""
import numpy as np
import torch
from torch.profiler import record_function

from ocpbench import weights
from ocpbench.traffic import Dispatches, now


class Kind:
    def __init__(self, config, mix, seed, device, here):
        self.table, self.mix, self.seed, self.dev = config["table"], mix, seed, device
        self.dispatches, self.host, self.calls = Dispatches(), {}, {}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self):
        gen = torch.Generator(device=self.dev).manual_seed(weights.sub_seed(self.seed, "rows"))
        self.x = torch.randn(self.table["rows"], self.table["width"], generator=gen,
                             device=self.dev, dtype=torch.float64)

    def iteration(self, timed=False):
        t0 = now()
        with record_function("ocpbench.sum_rows"):
            self.out = self.x.sum(1)
        self.sync()
        return now() - t0

    def window(self, seconds, traced):
        t0, self.attempted, self.failed = now(), 0, 0
        while True:
            self.iteration()
            self.attempted += 1
            if now() - t0 >= seconds:
                break
        self.window_s = now() - t0

    def end_to_end(self):
        return {"rows_per_s": self.attempted * self.table["rows"] / self.window_s}

    def free(self):
        self.x = self.x.cpu()

    def check(self):
        want = np.asarray(self.x.tolist()).sum(1)
        return {"sum_gap": float(np.abs(self.out.cpu().numpy() - want).max())}

    def control_seed(self, control):
        self.setup()
        self.window(0.0, False)
        self.free()
        return {"program": self.check()}
'''

DECODE_SPAN_MS = '''
"""The host time of a ``serve.decode_step`` span, the traced iteration's mean."""


def read(name, run):
    ivs = run.trace.spans.get("serve.decode_step") if run.trace else None
    return 1e-6 * sum(b - a for a, b in ivs) / len(ivs) if ivs else None
'''

LAUNCH_KEYS = '''
"""How many kernels the readers receive launch counts of."""


def read(name, run):
    return float(len(run.launches)) if run.trace else None
'''

DENSE_MODEL = dict(name="dense-test", family="dense", n_layers=2, d_model=4096, n_heads=32,
                   n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000, act="swiglu",
                   tie_embeddings=False, rope_theta=10000.0, norm_eps=1e-5, dtype="bfloat16",
                   remat="block")
DENSE_SMALL = dict(DENSE_MODEL, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                   vocab=256)


def write(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> pathlib.Path:
    """A checkout's benchmark with two cells more, every file new."""
    root = tmp_path_factory.mktemp("bench")
    here = root / "ocpbench"
    bench = smoke.bench()
    bench["configs"] += [
        {"name": "dense-test", "source": "https://example.org/dense-test",
         "file": "ocpbench/configs/dense-test.json", "reduced": [], "why": "a dense decoder"},
        {"name": "rows-test", "source": "https://example.org/rows-test",
         "file": "ocpbench/configs/rows-test.json", "reduced": [], "why": "no model"}]
    bench["workloads"] += [
        {"name": DENSE, "config": "dense-test", "traffic": "fixed-2", "chips": 1,
         "why": "two batches of served prompts"},
        {"name": ROWS, "config": "rows-test", "traffic": "sum-rows", "chips": 1,
         "why": "row sums"}]
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p90_ms":
            m["workloads"].append(DENSE)
    bench["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher",
                                "bound": 0.01, "source": "host_clock", "workloads": [ROWS]})
    bench["per_layer"] += [
        {"name": "decode_span_ms.test", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "serve steps", "moves": "ttft_p90_ms",
         "workloads": [DENSE]},
        {"name": "launch_keys.test", "unit": "kernels", "better": "lower",
         "source": "program_counter", "layer": "kernels", "moves": "ttft_p90_ms",
         "workloads": [DENSE]}]
    write(root / "BENCHMARK.json", bench)
    limits = {"kernels_unlaunched": 0, "mean_gap": 1e-4, "worst_request_gap": 1e-3}
    write(here / "configs/dense-test.json",
          {"name": "dense-test", "reference": "dense_lm", "model": DENSE_MODEL,
           "smoke": {"model": DENSE_SMALL, "limits": {"fixed_batches": limits}}})
    write(here / "configs/rows-test.json",
          {"name": "rows-test", "table": {"rows": 1 << 20, "width": 256},
           "smoke": {"table": {"rows": 64, "width": 8},
                     "limits": {"sum_rows": {"kernels_unlaunched": 0, "sum_gap": 1e-9}}}})
    write(here / "mixes/fixed-2.json",
          {"kind": "fixed_batches", "batch": 32, "prompt": 2048, "new_tokens": 32,
           "cache_len": 2080, "batches": 2, "kernels": ["flash_attention", "flash_decode",
                                                        "ssd_scan"],
           "smoke": {"batch": 2, "prompt": 8, "new_tokens": 4, "cache_len": 12}})
    write(here / "mixes/sum-rows.json", {"kind": "sum_rows", "kernels": [], "smoke": {}})
    write(here / f"limits/{DENSE}.json", {"kernels_unlaunched": 0, "mean_gap": 0.33})
    write(here / f"limits/{ROWS}.json", {"kernels_unlaunched": 0, "sum_gap": 1e-9})
    write(here / "reference/dense_lm.py", DENSE_REFERENCE)
    write(here / "kinds/fixed_batches.py", FIXED_BATCHES)
    write(here / "kinds/sum_rows.py", SUM_ROWS)
    write(here / "layers/decode_span_ms.py", DECODE_SPAN_MS)
    write(here / "layers/launch_keys.py", LAUNCH_KEYS)
    return root


def test_the_new_files_hold_the_cells(root):
    c = smoke.cell(DENSE, root)
    assert c.here == root / "ocpbench"
    assert c.config["model"] == DENSE_SMALL and c.config["reference"] == "dense_lm"
    assert (c.mix["batch"], c.mix["prompt"], c.mix["kind"]) == (2, 8, "fixed_batches")
    assert "smoke" not in c.mix and c.limits["mean_gap"] == 1e-4
    assert [m["name"] for m in c.end_to_end] == ["ttft_p90_ms", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["decode_span_ms.test", "launch_keys.test"]
    rows = smoke.cell(ROWS, root)
    assert "model" not in rows.config and rows.config["table"] == {"rows": 64, "width": 8}
    assert rows.limits == {"kernels_unlaunched": 0, "sum_gap": 1e-9}


def test_a_dense_configuration_runs_untraced(root):
    out = smoke.run(DENSE, c=smoke.cell(DENSE, root))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] == 4
    assert sorted(out["metrics"]) == ["setup_s", "ttft_p90_ms"]
    assert sorted(out["checks"]) == ["kernels_unlaunched", "mean_gap", "worst_request_gap"]


def test_a_dense_configuration_runs_traced(root):
    out = smoke.run(DENSE, c=smoke.cell(DENSE, root), traced=True)
    assert out["correct"] is True
    # the program's span read from the trace; the four kernels and the
    # mix's ssd_scan counted
    assert out["metrics"]["decode_span_ms.test"]["value"] > 0
    assert out["metrics"]["launch_keys.test"] == {"value": 5.0, "unit": "kernels"}


def test_a_configuration_without_a_model_runs(root):
    out = smoke.run(ROWS, c=smoke.cell(ROWS, root))
    assert out["correct"] is True and out["attempted"] >= 1
    assert sorted(out["metrics"]) == ["rows_per_s", "setup_s"]
    assert out["checks"]["sum_gap"]["value"] <= 1e-9
    traced = smoke.run(ROWS, c=smoke.cell(ROWS, root), traced=True)
    assert traced["correct"] is True and traced["metrics"] == {}


def test_the_control_finds_the_new_kinds(root):
    c = smoke.cell(DENSE, root)
    cls, fn = control.lookup(c)
    assert cls.__name__ == "Kind" and issubclass(cls, traffic.BatchServe)
    assert fn is control.serve_seed
    row = fn(cls(c.config, c.mix, 2 ** 33 + 5, torch.device("cpu"), c.here), True)
    assert set(row) >= {"program", "control", "altered_token", "altered_slot"}
    assert row["look"] == {}  # a dense reference routes nothing
    assert row["program"]["mean_gap"] <= c.limits["mean_gap"]
    assert row["altered_slot"]["worst_request_gap"] > c.limits["worst_request_gap"]
    rows = smoke.cell(ROWS, root)
    cls, fn = control.lookup(rows)
    got = fn(cls(rows.config, rows.mix, 7, torch.device("cpu"), rows.here), False)
    assert got["program"]["sum_gap"] <= rows.limits["sum_gap"]
    for name in ("granite-moe-1b-a400m.train-2k", "arctic-480b-2l.rag-2k"):
        c = smoke.cell(name)
        assert control.lookup(c)[1] is (control.train_seed if "train" in name
                                         else control.serve_seed)


def test_a_reference_gives_its_own_tree(root):
    ref = files.module(root / "ocpbench", "reference", "dense_lm")
    tree = weights.draw(DENSE_SMALL, 11, "cpu", ref)
    from repro_torch.models import model_specs
    from repro_torch.models.config import ModelConfig

    traffic.check_tree(tree, model_specs(ModelConfig(**DENSE_SMALL)))
    assert "moe" not in tree["blocks"]
    with pytest.raises(RuntimeError):  # the MoE tree is not the dense model's
        traffic.check_tree(weights.draw(DENSE_SMALL | {"n_experts": 4}, 11, "cpu"),
                           model_specs(ModelConfig(**DENSE_SMALL)))


def test_lookups_of_kinds_and_counters():
    assert harness.kind("train") is traffic.Train
    assert harness.kind("batch_serve") is traffic.BatchServe
    with pytest.raises(KeyError):
        harness.kind("no_such_kind")
    assert harness.counter("flash_attention") is fa_ops
    assert harness.counter("ssd_scan") is ssd_ops
    with pytest.raises(KeyError):
        harness.reader("no_such_family")


def test_a_kernel_not_listed_takes_its_names_from_the_caller():
    ev = trace.from_json(smoke.load(ROOT / "ocpbench/tests/data/trace_small.json"))
    run = harness.Run(model=None, mix={}, peaks=counts.peaks("NVIDIA H100 80GB HBM3"),
                      trace=trace.summarize(ev, 6e-6), dispatches=[], host={}, calls={},
                      launches={})
    assert rooflines.kernel_device_s(run, "ssd_scan", None, ("elementwise",)) == \
        pytest.approx(300e-9)
    assert rooflines.kernel_device_s(run, "moe_gemm", "prefill", ("nothing",)) == \
        pytest.approx(400e-9)  # a listed kernel keeps its own names
    with pytest.raises(KeyError):
        rooflines.kernel_device_s(run, "ssd_scan", None)


def test_every_host_range_is_read():
    ev = trace.from_json(smoke.load(ROOT / "ocpbench/tests/data/trace_spans.json"))
    s = trace.summarize(ev, 3e-5)
    assert s.ranges["moe.route"] == pytest.approx((400 + 200 + 50 + 80) * 1e-9)
    assert s.ranges["serve.decode_step"] == pytest.approx((100 + 50 + 100 + 50) * 1e-9
                                                          + (100 + 80 + 100 + 40 + 100) * 1e-9)
    assert len(s.spans["moe.experts"]) == 4 and s.spans["data.get_batch"] == [(100, 1900)]
    for name in trace.RANGES:  # reported, if only as 0
        assert name in s.ranges
    assert s.busy[:2] == [(600, 900), (3200, 3600)]
    # the decode range on the small trace: 2,000 ns on the host, 450 of
    # it busy on the device
    small = trace.summarize(trace.from_json(smoke.load(
        ROOT / "ocpbench/tests/data/trace_small.json")), 6e-6)
    assert small.idle_within(["ocpbench.decode"]) == pytest.approx(1550e-9)
    assert small.idle_within(["ocpbench.decode"], inside="ocpbench.prefill") is None
    assert small.idle_within(["no.such.range"]) is None


def test_the_recomputes_are_the_three_spans():
    """`recompute_ms` sums every range whose name ends in ``.recompute``:
    the program opens three."""
    opened = set()
    for path in (ROOT / "src/repro_torch").rglob("*.py"):
        opened |= set(re.findall(r'span\("([^"]+)"', path.read_text()))
    assert {n for n in opened if n.endswith(".recompute")} == {
        "flash_attention.recompute", "moe_gemm.recompute", "ssd_scan.recompute"}


# ------------------------------------------------- the cells as before ----

def tree_hash(tree) -> str:
    h = hashlib.sha256()

    def walk(t, p=""):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v, p + "/" + k)
            else:
                h.update((p + "/" + k + str(tuple(v.shape)) + str(v.dtype)).encode())
                h.update(v.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


@pytest.mark.parametrize("config", ["granite-moe-1b-a400m", "arctic-480b-2l"])
def test_the_weights_are_byte_equal(config):
    """The draw through the configuration's reference, at smoke widths on
    two seeds, byte for byte, and the leaves, shapes, dtypes and order of
    the published tree (which fix every offset and generator call)."""
    conf = harness.load_json(ROOT / "ocpbench/configs" / f"{config}.json")
    ref = files.module(files.HERE, "reference", conf["reference"])
    short = config.split("-")[0]
    for seed in (2 ** 33 + 7, 12345):
        got = tree_hash(weights.draw(smoke.MODELS[config], seed, "cpu", ref))
        assert got == BEFORE["draw"][f"{short}/{seed}"]
    leaves = getattr(ref, "shapes", weights.shapes)(conf["model"])
    assert hashlib.sha256(json.dumps(leaves).encode()).hexdigest() == BEFORE["shapes"][config]


def test_the_saved_trace_summarizes_as_before():
    ev = trace.from_json(smoke.load(ROOT / "ocpbench/tests/data/trace_small.json"))
    s = trace.summarize(ev, window_s=6e-6)
    want = BEFORE["summary"]
    assert s.busy_s == want["busy_s"]
    assert {n: s.ranges[n] for n in want["ranges"]} == want["ranges"]
    assert json.loads(json.dumps(s.breakdown)) == want["breakdown"]
    assert [sorted(o.ranges) for o in s.ops] == want["op_ranges"]


@pytest.mark.parametrize("phase", [None, "train", "prefill", "decode"])
def test_the_readers_read_as_before(phase):
    """Every per-layer family the benchmark had, on the saved trace and a
    window's host readings and dispatches, each phase in turn."""
    ev = trace.from_json(smoke.load(ROOT / "ocpbench/tests/data/trace_small.json"))
    recs = [dict(phase="prefill", traced=True, counts=[3, 1, 0, 0, 0, 0, 0, 4], C=3, picks=32,
                 dropped=1),
            dict(phase="prefill", traced=False, counts=[3, 1, 0, 0, 0, 0, 0, 4], C=3, picks=32,
                 dropped=2),
            dict(phase="decode", traced=False, counts=[1, 0, 0, 2, 0, 0, 1, 0], C=2, picks=4,
                 dropped=0),
            dict(phase="decode", traced=False, counts=[0, 1, 0, 2, 0, 0, 0, 1], C=2, picks=4,
                 dropped=1),
            dict(phase="decode", traced=True, counts=[0, 1, 1, 1, 0, 0, 0, 1], C=2, picks=4,
                 dropped=0),
            dict(phase="decode", traced=True, counts=[2, 0, 0, 1, 0, 0, 1, 0], C=2, picks=4,
                 dropped=0)]
    host = {"data_s": [0.002, 0.004], "prefill_s": [0.5, 0.3], "decode_s": [0.02, 0.03],
            "decode_steps": [1, 1], "step_s": [0.25, 0.35]}
    before = {k.split("/")[1]: v for k, v in BEFORE["read"].items()
              if k.split("/")[0] == str(phase)}
    mix = {"batch": 2, "prompt": 4, "new_tokens": 2, "seq_len": 4, "microbatches": 1,
           "phase_of": {} if phase is None else {f: phase for f in before}}
    run = harness.Run(model=smoke.GRANITE, mix=mix, peaks=counts.peaks("NVIDIA H100 80GB HBM3"),
                      trace=trace.summarize(ev, window_s=6e-6), dispatches=recs, host=host,
                      calls={"flash_attention": [(2, 4)], "flash_decode": [(2, 5)]},
                      launches={"flash_attention": 1, "flash_decode": 2, "moe_gemm": 2})
    assert len(before) == 12
    for family, value in before.items():
        assert harness.reader(family).read(family + ".x", run) == value, family


def test_no_file_of_the_repository_is_written(root):
    """The new cells' files lie under the temporary root alone."""
    for rel in ("ocpbench/kinds", "ocpbench/reference/dense_lm.py",
                "ocpbench/layers/decode_span_ms.py", "ocpbench/mixes/fixed-2.json"):
        assert not (ROOT / rel).exists(), rel
