"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 ocpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``src`` holds the program, `repro_torch`).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit, also the last lines of standard
error.  Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; so it does where JAX, Flax or the JAX package
(`repro`) is loaded once the window has closed (exit 3).

The caches of the program's builds stay inside the checkout:
`repro_torch` builds its kernels into ``build/repro_torch_ext/``, and
Triton's, Inductor's and PyTorch's extension caches are pointed at
``build/`` here, and so is Python's bytecode (``build/pycache/``, written
even where the environment says not to): where the installed packages hold
no compiled bytecode, each run would compile them again (~8 s of the
set-up on the card's host).
"""
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from ocpbench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run_cell(harness.cell(bench, args.workload, ROOT), args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START, log)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
