"""Run the cluster and storage-fault phases of ``chip_smoke.py`` (24 and
25) several times on the card, to tell a rare failure from a fixed one.

    PYTHONPATH=src python tools/smoke_phases.py [N] [--tiny]

``N`` (default 3) rounds of phase 24 then phase 25 at the smoke's full
sizes on the card; ``--tiny`` runs the rehearsal sizes on the CPU.  Each
run prints one ``ROW`` JSON line; the exit code is 0 only if every run
passed.
"""
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 3
tiny = "--tiny" in sys.argv
dev = torch.device("cpu" if tiny else "cuda")
if not tiny:
    _build.build(["cutout_gather"])
res = []
for i in range(n):
    for name, fn, cfg in (("24", cs.cluster_front_door, cs.CLUSTER_TINY if tiny else cs.CLUSTER_FULL),
                          ("25", cs.storage_faults, cs.FAULT_TINY if tiny else cs.FAULT_FULL)):
        t0 = time.perf_counter()
        report, counts = {}, {}
        try:
            fn(cfg, dev, report, counts)
            ok = True
        except Exception:
            traceback.print_exc()
            ok = False
        row = dict(run=i, phase=name, ok=ok, s=round(time.perf_counter() - t0, 1))
        if ok and name == "24":
            ld = report["cluster"]["load"]
            row.update(answered=ld["answered"], shed=ld["shed"], front_door=ld["front_door"])
        print("ROW", json.dumps(row), flush=True)
        res.append(row)
        if not tiny:
            torch.cuda.empty_cache()
print("PASSED", sum(r["ok"] for r in res), "of", len(res))
sys.exit(0 if all(r["ok"] for r in res) else 1)
