"""The readings that set the SSM training cell's limits, on the card.

    python3 ocpbench/control_ssm.py --workload mamba2-370m.train-2k \\
        --seeds 1,2,3 --control-seeds 4,5,6 [--out FILE]

`control.py`'s readings (the program against the fp32 reference on each
seed; on each control seed also the fp8 control and half of each batch
left out), and on each control seed one fault more: the reference with
the state carried between chunks dropped (`reference.ssm_lm`,
``carry=False``: L kept within blocks of ``ssm_chunk`` positions).  A
state left unchanged reads 1 on ``update_gap`` and needs no run.  Benchmark
runs do not run this.  One JSON line a seed, then the least and the most
of each reading, on standard output.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from ocpbench import control, harness  # noqa: E402

FAULTS = ("program", "control", "half_batch", "dropped_carry")


def seed_readings(tr, with_faults: bool) -> dict:
    out = control.train_seed(tr, with_faults)
    grads = tr.ref["grad_norms"]
    med = sorted(grads.values())[len(grads) // 2]
    out["look"]["moved"] = [k for k in sorted(grads) if grads[k] >= 1e-3 * med]
    if with_faults:
        cut = tr.reference_run(carry=False)
        out["dropped_carry"] = tr.readings(tr.ref, cut)
        out["look"]["dropped_carry_change_gaps"] = control.leaf_gaps(cut["change_norms"],
                                                                     tr.ref["change_norms"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mamba2-370m.train-2k")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    c = harness.cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload, ROOT)
    cls = harness.kind(c.mix["kind"], c.here)
    dev = torch.device("cuda", 0)
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    rows = []
    for seed, with_faults in seeds:
        t0 = time.perf_counter()
        row = dict(seed=seed, **seed_readings(cls(c.config, c.mix, seed, dev, c.here),
                                              with_faults))
        row["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in FAULTS:
        got = [r[key] for r in rows if key in r]
        if got:
            summary[key] = {k: {"min": min(g[k] for g in got), "max": max(g[k] for g in got)}
                            for k in got[0]}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(dev),
                      "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
