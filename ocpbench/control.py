"""The readings that set a cell's limits, on the card at the cell's size.

    python3 ocpbench/control.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--out FILE]

For each seed the program's own readings against the fp32 reference, as
a run's check takes them (the set-up's first training steps, or one batch
of the serving loop).  For each control seed also the control's (the
reference in fp8 in the program's place, `reference.moe_lm`) and the
faults' (training: half of each batch left out, the mean over the rest;
serving: one served token altered, and every token of one request).  A state left unchanged reads 1 on
``update_gap`` by its definition and needs no run.  Benchmark runs do not
run this.  One JSON line a seed, then a summary, on standard output.

The cell's kind is found as the harness finds it (`harness.kind`); a kind
that derives from neither `traffic.Train` nor `traffic.BatchServe` takes
its readings with its own ``control_seed(control)``.
"""
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ocpbench import harness  # noqa: E402
from ocpbench import traffic  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402


def gap_stats(gaps: torch.Tensor) -> dict:
    g = gaps.flatten().double().cpu().numpy()
    return {"max_gap": float(g.max()), "p99_gap": float(np.percentile(g, 99)),
            "mean_gap": float(g.mean()), "flip_share": float((g > 0).mean()),
            "worst_request_gap": float(gaps.double().mean(-1).max())}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    return dict(zip(sorted(ref), traffic.leaf_gaps(prog, ref)))


def train_seed(tr, control: bool) -> dict:
    tr.setup()
    tr.free()
    out = {"program": tr.check()}
    out["look"] = {"losses": tr.losses, "ref_losses": tr.ref["losses"],
                   "grad_gaps": leaf_gaps(tr.grad_norms, tr.ref["grad_norms"]),
                   "change_gaps": leaf_gaps(tr.change_norms, tr.ref["change_norms"])}
    if control:
        B = tr.mix["batch"]
        low = tr.reference_run("fp8")
        out["control"] = tr.readings(tr.ref, low)
        out["look"]["control_losses"] = low["losses"]
        out["look"]["control_grad_gaps"] = leaf_gaps(low["grad_norms"], tr.ref["grad_norms"])
        out["half_batch"] = tr.readings(tr.ref, tr.reference_run(
            "fp32", keep_rows=torch.arange(B // 2, device=tr.dev)))
    return out


class Routing:
    """Each call's expert ids: the program's through its `observe` hook,
    the reference's around `moe_lm.route` (a look at where the two
    disagree, not part of any check).  A reference that routes nothing
    (no ``route``) gives no look."""

    def __init__(self, reference):
        self.program, self.reference = [], []
        self.module, self._route = reference, getattr(reference, "route", None)

    def observe(self, p, xt, disp):
        self.program.append(disp.expert_ids.sort(-1).values.cpu())

    def route(self, c, xt, w, sizes):
        out = self._route(c, xt, w, sizes)
        self.reference.append(out[0].sort(-1).values.cpu())
        return out

    def disagreement(self, n_layers: int, steps: int) -> list:
        """Per layer, the share of tokens routed to another set of experts."""
        out = []
        for layer in range(n_layers):
            mine = [self.program[layer]] + [self.program[n_layers * (1 + j) + layer]
                                            for j in range(steps)]
            mine = torch.cat(mine)
            theirs = self.reference[layer]
            out.append(float((mine != theirs).any(-1).float().mean()))
        return out


def serve_seed(sv, control: bool) -> dict:
    sv.setup()
    routing = Routing(sv.reference)
    with torch.inference_mode(), moe_mod.observe(routing.observe):
        sv.window(0.0, False)  # one batch
    sv.free()
    if routing._route is None:
        sv.check()
    else:
        sv.reference.route = routing.route
        try:
            sv.check()
        finally:
            sv.reference.route = routing._route
    i = sv.sample()
    served = sv.served[i].to(sv.dev)
    out = {"program": gap_stats(sv.reference.token_gaps(sv.ref, served)), "look": {}}
    if routing._route is not None:
        out["look"]["routing_disagreement"] = routing.disagreement(
            sv.m["n_layers"], sv.mix["new_tokens"] - 1)
    if control:
        low = sv.reference_logits(i, served, sv.params, "fp8")
        out["control"] = gap_stats(sv.reference.token_gaps(sv.ref, low.argmax(-1)))
        altered = served.clone()
        altered[0, -1] = (altered[0, -1] + 1) % sv.m["vocab"]
        out["altered_token"] = gap_stats(sv.reference.token_gaps(sv.ref, altered))
        altered = served.clone()
        altered[0] = (altered[0] + 1) % sv.m["vocab"]
        out["altered_slot"] = gap_stats(sv.reference.token_gaps(sv.ref, altered))
    del sv.params, sv.ref
    return out


def lookup(c: harness.Cell):
    """(the cell's traffic class, the function that takes a seed's
    readings with it)."""
    cls = harness.kind(c.mix["kind"], c.here)
    if issubclass(cls, traffic.Train):
        return cls, train_seed
    if issubclass(cls, traffic.BatchServe):
        return cls, serve_seed
    return cls, lambda t, control: t.control_seed(control)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    c = harness.cell(bench, args.workload, ROOT)
    dev = torch.device("cuda", 0)
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    cls, fn = lookup(c)
    rows = []
    for seed, control in seeds:
        t0 = time.perf_counter()
        run = cls(c.config, c.mix, seed, dev, c.here)
        row = dict(seed=seed, **fn(run, control), seconds=time.perf_counter() - t0)
        del run
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in ("program", "control", "half_batch", "altered_token", "altered_slot"):
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
