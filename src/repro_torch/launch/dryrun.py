"""Multi-pod dry run (`repro.launch.dryrun`): cost every (arch x shape x
mesh) cell on the host, as a model of H100 SXM devices.

Each cell's step (train: forward, backward and AdamW; prefill; decode:
one token) runs under a sharding plan (`train.sharding`) on DTensors
whose shards are fake tensors (`launch.specs`), on a production mesh of
the fake process group (`launch.mesh`): nothing is allocated and no data
moves, and every op and collective rank 0 would run is counted
(`launch.roofline.CostMode`, `MemTracker`).  The JAX package lowers and
compiles the same cells with XLA; ``lower_s`` / ``compile_s`` are here the
trace time of the step.

Every layer is traced (the JAX package scans them).  A cell is traced at
two reduced depths at full width and extrapolated linearly to the real
depth (`extrapolated_cost`): exact where the layers are one program, and
it saves tracing a 126-layer model.  The peak memory is extrapolated the
same way; the argument bytes are counted from the inputs at full depth.

The process's default group is the fake group of 512 ranks: run the dry
run in a process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell smollm-135m:train_4k:16x16 \
      --peak-breakdown 1     # what is live at the peak, one layer deep
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..models import build_model
from ..models.config import SHAPES
from ..optim import AdamWConfig
from ..serve import make_prefill_step, make_serve_step
from ..train import make_train_step
from ..train.sharding import make_plan, use_plan
from .mesh import make_mesh, make_production_mesh
from .roofline import (CostMode, Roofline, model_flops_estimate, peak_tracker,
                       quiet_propagation)
from .specs import cell_is_applicable, fake_mode, input_specs

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def build_step(cfg, shape, opt_cfg: Optional[AdamWConfig] = None,
               n_microbatches: int = 1, loss_impl: str = "gather"):
    """The cell's step as a function of `input_specs`' tuple: it builds the
    model on the given parameters and runs the train step, the prefill or
    one decode step."""
    if shape.kind == "train":
        def train(params, opt, batch):
            model = build_model(cfg, params, device="cpu")
            return make_train_step(model, cfg, opt_cfg or AdamWConfig(),
                                   n_microbatches, loss_impl)(opt, batch)
        return train
    if shape.kind == "prefill":
        def prefill(params, *inputs):
            return make_prefill_step(build_model(cfg, params, device="cpu"), cfg)(*inputs)
        return prefill

    def decode(params, cache, token, index):
        return make_serve_step(build_model(cfg, params, device="cpu"), cfg)(cache, token, index)
    return decode


def donate_for(shape) -> tuple:
    """The buffers the step updates in place: train updates (params, opt),
    decode the KV cache.  They are the JAX package's donated arguments,
    so the memory report counts them once."""
    if shape.kind == "train":
        return (0, 1)
    if shape.kind == "decode":
        return (1,)
    return ()


def depth_variant(cfg, n_layers: int):
    """Same width, reduced depth."""
    kw = {"n_layers": n_layers}
    if cfg.family == "encdec":
        kw.update(n_enc_layers=n_layers, n_dec_layers=n_layers)
    return cfg.scaled(**kw)


def _local_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(tree) if hasattr(t, "to_local"))


def _cost_tuple(cfg, shape, plan, opt_cfg=None, n_microbatches=1, loss_impl="gather",
                mem=None):
    """(flops, bytes, {opcode: collective bytes}, peak memory) per device
    from one traced step (``mem``: the `peak_tracker` to use)."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = input_specs(cfg, shape, plan, opt_cfg=opt_cfg)
    step = build_step(cfg, shape, opt_cfg, n_microbatches, loss_impl)
    mem = mem or peak_tracker()
    with fake_mode(), implicit_replication(), use_plan(plan), quiet_propagation():
        mem.track_external(*[a for a in args if not isinstance(a, int)])
        with mem, CostMode() as cost:
            step(*args)
    return float(cost.flops), float(cost.bytes), dict(cost.coll), mem.peak_bytes()


def extrapolated_cost(cfg, shape, plan, depths: Optional[Sequence[int]] = None, **kw):
    """Trace two reduced-depth variants at full width and extrapolate
    linearly to the real depth:
        cost(L) = cost(L1) + (L - L1) * (cost(L2) - cost(L1)) / (L2 - L1).
    Exact when every layer is the same program.  ``depths`` defaults to
    one and two repeats of the layer pattern.  Returns (flops, bytes,
    collective bytes by opcode, peak memory, extrapolated?)."""
    plen = len(cfg.hybrid_pattern) if cfg.family == "hybrid" else 1
    L = cfg.n_layers
    L1, L2 = depths or (plen, 2 * plen)
    if L <= L2:  # shallow smoke-scale config: just measure directly
        return _cost_tuple(cfg, shape, plan, **kw) + (False,)
    f1, b1, c1, m1 = _cost_tuple(depth_variant(cfg, L1), shape, plan, **kw)
    f2, b2, c2, m2 = _cost_tuple(depth_variant(cfg, L2), shape, plan, **kw)
    k = (L - L1) / (L2 - L1)
    coll = {key: int(c1.get(key, 0) + (c2.get(key, 0) - c1.get(key, 0)) * k)
            for key in set(c1) | set(c2)}
    return (f1 + (f2 - f1) * k, b1 + (b2 - b1) * k, coll, m1 + (m2 - m1) * k, True)


def peak_breakdown(arch: str, shape_name: str, mesh_name: str, *, smoke: bool = False,
                   n_layers: Optional[int] = None, top: int = 12):
    """What is live at the peak of one cell's traced step on a device, at
    ``n_layers`` (default: the arch's own depth): (peak bytes, [(op shape
    dtype, bytes)] largest first, ``top`` of them)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch, abstract=True)
    if n_layers:
        cfg = depth_variant(cfg, n_layers)
    mem = peak_tracker(breakdown=True)
    _cost_tuple(cfg, SHAPES[shape_name], make_plan(mesh_for(mesh_name)), mem=mem)
    return mem.peak_bytes(), mem.peak_breakdown()[:top]


def mesh_for(name: str):
    if name in ("16x16", "2x16x16"):
        return make_production_mesh(multi_pod=name == "2x16x16")
    return make_mesh(*MESHES[name])


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, *, smoke: bool = False,
             mesh_name: Optional[str] = None) -> Dict:
    """One cell's row.  ``smoke`` costs the arch's smoke config;
    ``mesh_name`` (one of `MESHES`) overrides the production mesh."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch, abstract=True)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    mesh_name = mesh_name or ("2x16x16" if multi_pod else "16x16")
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = why
        return cell
    t0 = time.time()
    mesh = mesh_for(mesh_name)
    plan = make_plan(mesh)
    f, b, coll, peak, extrap = extrapolated_cost(cfg, shape, plan)
    t_trace = time.time() - t0
    args = input_specs(cfg, shape, plan)
    arg_bytes = _local_bytes([a for a in args if not isinstance(a, int)])
    alias = _local_bytes([args[i] for i in donate_for(shape)])
    roof = Roofline(flops=f, hbm_bytes=b, coll_bytes=coll, n_chips=mesh.size(),
                    model_flops=model_flops_estimate(cfg, shape),
                    per_device_peak_memory=peak)
    cell.update({
        "status": "ok",
        "lower_s": round(t_trace, 1),
        "compile_s": 0.0,
        "cost_extrapolated": extrap,
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": None,
            "temp_bytes": max(peak - arg_bytes, 0.0),
            "alias_bytes": alias,
        },
        "roofline": roof.row(),
        "coll_breakdown": roof.coll_bytes,
    })
    if verbose:
        r = roof.row()
        print(f"[{arch} x {shape_name} x {mesh_name}] OK "
              f"trace={t_trace:.0f}s "
              f"bottleneck={r['bottleneck']} "
              f"t=(c {r['t_compute_s']:.2e}, m {r['t_memory_s']:.2e}, "
              f"x {r['t_collective_s']:.2e}) "
              f"useful={r['useful_ratio']:.2f} "
              f"roofline={r['roofline_fraction']:.2f} "
              f"peak={peak / 2**30:.1f}GiB", flush=True)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "2x2"])
    ap.add_argument("--smoke", action="store_true",
                    help="cost the archs' smoke configs")
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE:MESH",
                    help="one cell (repeatable; MESH one of " + ", ".join(MESHES) + ")")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--peak-breakdown", type=int, default=None, metavar="LAYERS",
                    help="print what is live at each cell's peak, at this depth, "
                         "in place of the rows")
    args = ap.parse_args(argv)

    cells = []
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"], "2x2": ["2x2"]}[args.mesh]
    if args.cell:
        targets = [tuple(c.split(":")) for c in args.cell]
        targets = [(a.replace("-", "_"), s, m) for a, s, m in targets]
    elif args.all:
        targets = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
    else:
        if not args.arch:
            ap.error("--arch, --cell or --all required")
        shapes = [args.shape] if args.shape else list(SHAPES)
        targets = [(args.arch.replace("-", "_"), s, m) for s in shapes for m in meshes]
    if args.peak_breakdown is not None:
        for arch, shape, mesh_name in targets:
            peak, rows = peak_breakdown(arch, shape, mesh_name, smoke=args.smoke,
                                        n_layers=args.peak_breakdown)
            print(f"[{arch} x {shape} x {mesh_name}] {args.peak_breakdown} layers: "
                  f"peak {peak / 2**30:.3f} GiB", flush=True)
            for what, nbytes in rows:
                print(f"  {nbytes / 2**30:10.3f} GiB  {what}", flush=True)
        return
    failures = 0
    for arch, shape, mesh_name in targets:
        try:
            cells.append(run_cell(arch, shape, smoke=args.smoke, mesh_name=mesh_name))
        except Exception as e:  # record, keep going
            failures += 1
            traceback.print_exc()
            cells.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                          "status": "FAILED", "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
        print(f"wrote {args.out} ({len(cells)} cells, {failures} failures)")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
