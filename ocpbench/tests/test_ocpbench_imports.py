"""What a run loads: no module whose top-level name (the whole part
before the first dot) is JAX's, Flax's or the JAX package's, and no file
of the JAX package's benchmark (``benchmarks/``) read."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

CHILD = r"""
import json, pathlib, sys
root = pathlib.Path(sys.argv[1])
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.argv = [str(root / "ocpbench" / "run.py")]
import runpy
runpy.run_path(str(root / "ocpbench" / "run.py"), run_name="not_main")
from ocpbench import control, harness, traffic
bench = harness.load_json(root / "BENCHMARK.json")
for w in bench["workloads"]:
    c = harness.cell(bench, w["name"], root)
    for m in c.per_layer:
        harness.reader(m["name"].split(".")[0])
print(json.dumps({"modules": sorted(sys.modules), "opened": opened}))
"""


def test_run_imports_no_jax_and_reads_no_jax_benchmark():
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in got["modules"]}
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    bench_dir = str(ROOT / "benchmarks")
    assert not [p for p in got["opened"] if p.startswith(bench_dir)]
