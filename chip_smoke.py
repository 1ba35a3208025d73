#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py [--out FILE]        # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse          # control flow only, tiny, CPU

Phases (any failure raises and the exit code is non-zero):

1. Print the card's name and power limit, build the CUDA kernels from the
   sources under ``src/repro_torch/kernels`` (one nvcc each, in parallel)
   and time the build.
2. The detection path, once, through the port's entry points, with every
   kernel launch count set to 0 just before it and read just after: a
   seeded synthetic EM volume (uint8, 8192 x 8192 x 256 at level 0 —
   65,536 cuboids of 128 x 128 x 16, 16 GiB packed) made on the device
   slab by slab and ingested, the hierarchy built to level 5, and the
   paper's parallel synapse detection at level 2 (64 tiles of 512 x 512 x
   64, 20 workers, batches of 40, large-structure mask from level 5).
   `cutout_gather` must have launched.
3. Its results checked: 4 tiles re-run with cutouts through the plain
   gather give the stored annotations, one stored id per detected label
   and voxel for voxel; a stored level-1 box equals the downsampled level-0
   box; a small pipeline agrees between the card and the CPU reference
   path.  A torch.profiler window over 2 tiles gives the device's idle
   share.
4. `cutout_gather` against its plain version on the card (bit-exact) over
   dtypes, aligned, unaligned and volume-edge boxes, a 1024 x 1024 x 64 box
   of level 0 and a box whose cells lie past byte offset 2^31; timed with
   CUDA events (median of >= 20) beside the bound set by the memory rate.
5. The serving path, once, at smollm-135m's full width in bf16 (seeded
   weights), with the launch counts set to 0 just before it and read just
   after: 32 prompts of 2,048 tokens through `make_prefill_step` (cache of
   2,176), 128 greedy steps through `make_serve_step`, then a
   `ContinuousBatcher` of 16 slots draining 24 requests (prompts of 64-512
   tokens from a seed, 64 new tokens each).  `flash_attention` and
   `flash_decode` must have launched.  Prints time to first token, prefill
   and decode tokens/s, the batcher's tokens/s and occupancy, and peak
   memory (one run each); a torch.profiler window over decode steps gives
   the device's idle share.
6. Its results checked: a 2-layer fp32 smollm at the smoke widths serves
   the same greedy tokens on the card and on the CPU, through
   `make_serve_step` and through `ContinuousBatcher`; at full width, layer
   0's attention through the kernels agrees with the plain versions on the
   same card tensors, at the prefill of the whole batch and at a decode
   step over the whole cache with mixed lengths (split kv axes): in bf16
   within rtol 2e-2 and an atol of 5% of the outputs' mean magnitude, and
   with the tensors taken to fp32 within 2e-5; `flash_decode` at the
   batcher's shape (16 slots, lengths from 1 to the cache) within the
   small cases' tolerances.
7. `flash_attention` and `flash_decode` against their plain versions on
   the card over the shapes of tests/test_kernels.py (fp32 at 2e-5, bf16
   at 2e-2; causal, non-causal, window 48; per-sequence lengths), smollm's
   heads over 1,024-2,176 cached positions (split kv axes) and 10 and 16
   query heads per kv head (`flash_decode` takes any group), then
   timed at the serving path's shapes (CUDA events, median of >= 20)
   beside the bound, the plain version and one PyTorch call computing the
   same function (scaled_dot_product_attention, timed here only).
8. The ssm serving path, once, at mamba2-370m's full width in bf16
   (seeded weights), with the launch counts set to 0 just before it and
   read just after: 32 prompts of 2,048 tokens through `make_prefill_step`
   (the chunked forward builds the state cache), 128 greedy steps, then a
   `ContinuousBatcher` of 16 slots draining 32 requests (prompts of 64-256
   tokens, 32 new tokens each).  `ssd_scan` must have launched.  The same
   rates and profiles as the dense path.
9. Its results checked: a 2-layer fp32 mamba2 at the smoke widths (A and
   dt by Mamba-2's published init) serves the same greedy tokens on the
   card and on the CPU, batched and through the batcher; at full width,
   layer 0's mixer with the published A and dt, scan through the kernel
   and through the plain version on the same card tensors, in bf16 and in
   fp32 (the scan's outputs within rtol 1e-4 and 1e-4 of their max |out|,
   see SSD_REL), with the per-chunk decay and the carried state's share of
   |y| printed.
10. `ssd_scan` against its plain version over the shapes of
   tests/test_kernels.py, a chunk that is not a power of two, a ragged last
   chunk, mamba2-370m's heads and every instance of the bf16 body, fp32
   and bf16 (bf16 also against `ssd_scan_split_ref`, the tensor-core
   body's roundings emulated), the JAX tests' draws and the published
   ranges, all within SSD_REL; then timed at the prefill's shape beside the
   bound and the plain version (no single PyTorch call computes it), with
   the count of `HMMA` instructions in the built library's SASS (it fails
   if there are none) and the launch plan the built kernel reports.
11. The MoE serving path, once, at granite-moe-1b-a400m's full width in
   bf16 (seeded weights), with the launch counts set to 0 just before it
   and read just after: 32 prompts of 2,048 tokens (one global dispatch of
   65,536 tokens, capacity 20,480), 128 greedy steps, then a
   `ContinuousBatcher` of 16 slots draining 24 requests (prompts of 64-256
   tokens, 32 new tokens each).  `moe_gemm` must have launched once per
   layer of the prefill and of every decode step, and `flash_attention`
   and `flash_decode` (16 query heads over 8 kv heads) must have launched.
   The same rates and profiles as the other paths, and the share of
   dispatched picks dropped at the prefill and at one decode step.
12. Its results checked: a 2-layer fp32 granite at the smoke widths serves
   the same greedy tokens on the card and on the CPU, batched and through
   the batcher, with any top-k pick that differs between the two reported
   beside its router-probability gap; at full width, layer 0's MoE on the
   prefill's tokens, dispatched twice (the routing must be equal), through
   the kernel and through the plain version: fp32 within rtol 1e-4 and
   1e-4 of max |y|, bf16 within rtol 2e-2 and 5% of mean |y|; layer 0's
   attention (16 query heads over 8 kv heads) and the batcher's decode
   attention at this path's shapes, as in phase 6.
13. `moe_gemm` against its plain version over the shapes of
   tests/test_kernels.py, a ragged (3, 130, 24, 40) and granite's experts
   (C 640, and the decode step's C 10 and the batcher's C 8), fp32 and
   bf16, counts in [0, C] with 0, C and one past C, the buffer zero or
   random past the counts; then timed at the prefill's shape with layer
   0's own counts and at a decode step (C 10) beside the bound, the plain
   version and a yardstick of three bf16 `torch.bmm` over the whole
   buffer (no single PyTorch call computes this function), with the
   host's time to enqueue a decode-step call.
14. The tile-order path of `morton_matmul`, once, with the launch counts set
   to 0 just before it and read just after: the port's public
   `morton_matmul` in bf16 at its default blocks (256 x 256 x 256) on the
   study's shapes, M = N = K = 8192 and 6,000 x 10,000 x 4,000, in each
   order; the orders' outputs must be bit-identical and finite.  Then the
   kernel against its plain version (the fp32 product rounded to the dtype)
   over the shapes of tests/test_kernels.py at 128 x 128 x 64 (the clamped
   384 x 256 grid and the padding shape among them) and the study's shapes
   at 128 x 128 x 64 and 256 x 256 x 256, fp32 and bf16, each order, within
   the JAX test's |got - want| / (|want| + 1) < 1e-4 (fp32) and 3e-2 (bf16),
   the fp32 one grown as K / 512 past the test's K 512 (`mm_bench.rel_tol`);
   the orders bit-identical; a traced call per order showing that block b
   computed tile ``tile_order[b]`` and every tile exactly once.  Then the
   8192^3 bf16 product timed per order at both block sizes, in turns, beside
   the bound, the plain version and `torch.matmul` in bf16 (a yardstick).

15. The rest of the dense family, once each at full width in bf16 (seeded
   weights, drawn on the card and timed), with the launch counts set to 0
   just before and read just after: gemma-2b (8 query heads over 1 kv
   head, D 256, GeGLU) and minitron-8b (32 over 8, D 128, an untied
   256,000-word head), 32 prompts of 2,048 through `make_prefill_step`
   (cache 2,176) and 32 greedy steps.  `flash_attention` must have launched
   once a layer and `flash_decode` once a layer and step.  TTFT, decode
   tokens/s and peak memory, and profiles of decode steps and the prefill
   as in phase 5; layer 0's attention through the kernels
   against the plain versions (sliced over the batch) at the prefill and a
   decode step, bf16 and fp32, as in phase 6.  Then 2-layer fp32 models of
   gemma-2b, minitron-8b and llama3-405b (rope_theta 500,000) at the smoke
   widths serve the same greedy tokens on the card and on the CPU.
16. Dense training at smollm-135m's full width in bf16, through
   `launch.train`'s calls (`build_state`, `synthetic_corpus`, the Morton
   `DataPipeline`, `make_train_step`): first the gradient check (phase 17),
   then, with the launch counts set to 0, 20 steps of 16 x 2,048 tokens in
   2 microbatches at lr 3e-3 (warm-up 5, cosine).  The loss must fall from
   the first step to the last; `flash_attention` must have launched exactly
   30 layers x 2 microbatches x 20 steps times (the forward; the backward
   recomputes through the plain version) and `cutout_gather` at least once
   a step (the pipeline's rows).  Median step time after 2 warm steps,
   tokens/s, peak memory, the device's idle share over 2 profiled steps
   and a step's split into forward, backward (and its attention recompute)
   and optimizer (the device time launched inside `make_train_step`'s
   profiler ranges), and model FLOP/s as a share of the bf16 peak
   (`train_flops`); then one step each with bf16 and int8 gradient
   compression.
17. Training checks: the pipeline's batches of the first and last
   counted steps, read through `cutout_gather` at the path's shapes,
   equal to a CPU token store's (the plain gather) bit for bit.  On the
   first batch's first 2 sequences every
   parameter's gradient through the kernel route against the same weights
   with attention through the plain version (`plain_kernels`), in bf16
   and with the weights taken to fp32, at the tolerances of
   `training_grad_check`; w_q, w_k and w_v nonzero.  A 2-layer fp32 smollm
   at the smoke widths trains 5 steps on the card and on the CPU from the
   same weights and batches: losses and grad norms within rtol 1e-4, the
   parameters within 2 x the sum of the steps' lr.
18. MoE training at granite-moe-1b-a400m's full width in bf16, as phases
   16-17 (the same calls and batch, 12 steps, no compressed steps): first
   the gradient check on one sequence, every leaf through the kernel route
   (`moe_gemm` inside `MoeGemm`, `flash_attention` inside
   `FlashAttention`) against the plain route, bf16 (phase 17's criteria)
   and fp32 (within rtol 1e-4 and 1e-4 of the leaf's max |g|), the plain
   route taking the kernel route's top-k picks and the flips it would have
   made counted; then the counted run: the
   loss must fall, every step's gradient norm be finite, `moe_gemm` and
   `flash_attention` launch exactly 24 layers x microbatches x steps times
   and `cutout_gather` at least once a step.  The split reads
   ``moe_gemm.recompute`` and ``flash_attention.recompute``.  Then a
   2-layer fp32 granite trains alike on card and CPU, with its routing
   flips reported.
19. ssm training at mamba2-370m's full width in bf16, at its published
   chunk of 256 and with `build_state`'s init, as phase 18: `ssd_scan`
   (inside `SsdScan`) launches exactly 48 x microbatches x steps times;
   the bf16 gradients are held to the plain route's by their distance
   from the fp32 ones (`bf16_holds`);
   the split reads ``ssd_scan.recompute``; the 2-layer fp32 model trains
   alike on card and CPU at chunk 256 over 256 steps, where the plain
   scan's decay overflowed exp before its repair.
20. Checkpoint and restart on the card: each family's smoke model through
   `launch.train.main`, 10 steps with ``--ckpt-every 5
   --inject-failure-at 8`` against the same run without a failure: the
   recovery log shows the restore to step 5 and the replay, the replayed
   losses are equal, the final parameters and optimizer state are equal
   bit for bit, and the step-10 checkpoint restores on the CPU bit for bit.

`flash_attention`, `morton_matmul` and `moe_gemm` have two bodies, a
tensor-core one for bf16 and an FMA one for fp32; `flash_decode` has one,
whose splits of the kv axis merge inside its launch; each phase prints
which body ran.

The last three lines are the card's name and power limit, the JSON kernel
report, and ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

from repro_torch.carry import (lm_params_from_numpy, lm_params_to_numpy,  # noqa: E402
                               train_state_from_tree, train_state_to_tree)
from repro_torch.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import cutout as cut  # noqa: E402
from repro_torch.core.annotations import AnnotationProject  # noqa: E402
from repro_torch.core.cuboid import (CuboidGrid, DatasetSpec,  # noqa: E402
                                     downsample_block)
from repro_torch.core.store import DeviceCuboidStore  # noqa: E402
from repro_torch.kernels import _bench, _build  # noqa: E402
from repro_torch.kernels.cutout_gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.cutout_gather.ref import cutout_gather_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import bench as mg_bench  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as mg_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.kernels.morton_matmul import bench as mm_bench  # noqa: E402
from repro_torch.kernels.morton_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.morton_matmul.ref import morton_matmul_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_split_ref  # noqa: E402,E501
from repro_torch.data import DataPipeline, PipelineConfig  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.lm import lm_specs  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models.attention import attention, qkv  # noqa: E402
from repro_torch.models.layers import rms_norm, rotary  # noqa: E402
from repro_torch.models.ssm import ssm_inputs, ssm_output  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, Request,  # noqa: E402
                               make_prefill_step, make_serve_step)
from repro_torch.vision import synapse_detector as sd  # noqa: E402

KERNELS = {
    "cutout_gather": dict(
        route="cuda",
        source="src/repro_torch/kernels/cutout_gather/kernel.cu",
        replaces="src/repro/kernels/cutout_gather/kernel.py:30",
        ops=gather_ops, paths=("detection", "training", "moe_training", "ssm_training")),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/kernel.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:90",
        ops=fa_ops, paths=("serving", "moe_serving", "gemma_serving", "minitron_serving",
                           "training", "moe_training")),
    "flash_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_decode/kernel.cu",
        replaces="src/repro/kernels/flash_decode/kernel.py:66",
        ops=fd_ops, paths=("serving", "moe_serving", "gemma_serving", "minitron_serving")),
    "ssd_scan": dict(
        route="cuda",
        source="src/repro_torch/kernels/ssd_scan/kernel.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        ops=ssd_ops, paths=("ssm_serving", "ssm_training")),
    "moe_gemm": dict(
        route="cuda",
        source="src/repro_torch/kernels/moe_gemm/kernel.cu",
        replaces="src/repro/kernels/moe_gemm/kernel.py:55",
        ops=mg_ops, paths=("moe_serving", "moe_training")),
    "morton_matmul": dict(
        route="cuda",
        source="src/repro_torch/kernels/morton_matmul/kernel.cu",
        replaces="src/repro/kernels/morton_matmul/kernel.py:49",
        ops=mm_ops, paths=("morton_matmul",)),
}

FULL = dict(volume=(8192, 8192, 256), n_resolutions=6, r=2,
            tile=(512, 512, 64), lowres=5, workers=20, n_blobs=49152,
            slab=128)
TINY = dict(volume=(256, 256, 32), n_resolutions=3, r=1,
            tile=(64, 64, 32), lowres=2, workers=3, n_blobs=48, slab=64)

# the serving paths: smollm-135m and mamba2-370m at full width (bf16), and
# tiny rehearsals; ``key`` names the path's entry in the report
SERVE_FULL = dict(arch="smollm-135m", key="serving", smoke=False, batch=32,
                  prompt=2048, steps=128, slots=16, requests=24, plen=(64, 512),
                  max_new=64)
SERVE_TINY = dict(arch="smollm-135m", key="serving", smoke=True, batch=2,
                  prompt=16, steps=4, slots=2, requests=5, plen=(4, 12),
                  max_new=4)
SSM_FULL = dict(arch="mamba2-370m", key="ssm_serving", smoke=False, batch=32,
                prompt=2048, steps=128, slots=16, requests=32, plen=(64, 256),
                max_new=32)
SSM_TINY = SERVE_TINY | dict(arch="mamba2-370m", key="ssm_serving", prompt=40)
MOE_FULL = dict(arch="granite-moe-1b-a400m", key="moe_serving", smoke=False, batch=32,
                prompt=2048, steps=128, slots=16, requests=24, plen=(64, 256),
                max_new=32)
MOE_TINY = SERVE_TINY | dict(arch="granite-moe-1b-a400m", key="moe_serving")
# the rest of the dense family at full width (bf16): prefill and greedy
# decode, no batcher
DENSE_FULL = [dict(arch=a, key=k, smoke=False, batch=32, prompt=2048, steps=32)
              for a, k in (("gemma-2b", "gemma_serving"), ("minitron-8b", "minitron_serving"))]
DENSE_TINY = [d | dict(smoke=True, batch=2, prompt=16, steps=4) for d in DENSE_FULL]
# dense training at smollm-135m's full width (bf16): sequences of 2,048, a
# global batch of 16 in 2 microbatches, the JAX driver's learning rate
# (3e-3, warm-up 5, cosine to 0 at the last step) on its synthetic corpus;
# the gradient check takes the first batch's first ``check_seqs`` sequences
# (the plain route keeps every layer's fp32 scores for its backward)
TRAIN_FULL = dict(arch="smollm-135m", key="training", smoke=False, seq_len=2048, batch=16,
                  microbatches=2, steps=20, warm=2, lr=3e-3, check_seqs=2, compressed=True)
# the MoE and ssm families' training, the same batch and schedule over 12
# steps, so that the smoke stays near half its time limit (the ssm at its
# published chunk of 256 and with `build_state`'s init); the MoE's
# gradient check takes one sequence: its plain route keeps 24 layers' (16,
# 2,048, 2,048) fp32 attention scores, and two sequences ran out of memory
# on the H100
MOE_TRAIN_FULL = TRAIN_FULL | dict(arch="granite-moe-1b-a400m", key="moe_training",
                                   steps=12, compressed=False, check_seqs=1)
SSM_TRAIN_FULL = TRAIN_FULL | dict(arch="mamba2-370m", key="ssm_training", steps=12,
                                   compressed=False)
TRAINS_FULL = (TRAIN_FULL, MOE_TRAIN_FULL, SSM_TRAIN_FULL)
TRAINS_TINY = tuple(tc | dict(smoke=True, seq_len=32, batch=4, steps=8, warm=1)
                    for tc in TRAINS_FULL)
# the tile-order study's products (M, N, K), and a tiny rehearsal of them
MM_FULL = mm_bench.SHAPES
MM_TINY = [(96, 80, 64), (60, 100, 40)]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hbm_peak_bytes_per_s(name: str) -> float:
    """Published memory rate of the H100 (NVIDIA data sheet)."""
    return 2.0e12 if "PCIe" in name else 3.35e12  # PCIe, else SXM


def bf16_peak_flops(name: str) -> float:
    """Published dense bf16 tensor rate of the H100 (NVIDIA data sheet)."""
    return 756e12 if "PCIe" in name else 989e12  # PCIe, else SXM


# which body of a kernel a dtype runs: flash_attention, morton_matmul,
# moe_gemm and ssd_scan have a tensor-core body for bf16 and an FMA body
# for fp32;
# flash_decode has one body for both, a shared-memory pipeline whose
# splits merge inside the launch
TC_BODIES = {"flash_attention": "tensor-core bf16 (mma.sync m16n8k16)",
             "morton_matmul": "tensor-core bf16 (wgmma m64nNk16 + TMA)",
             "moe_gemm": "tensor-core bf16 (wgmma m64nNk16 + 3-D TMA)",
             "ssd_scan": "tensor-core bf16 (mma.sync m16n8k16, split hi + lo operands)",
             "flash_decode": "FMA {dtype} from a 3-stage cp.async ring, splits merged "
                             "in one cluster"}


def body(kernel: str, dtype: torch.dtype) -> str:
    name = str(dtype)[6:]
    if kernel == "flash_decode":
        return TC_BODIES[kernel].format(dtype=name)
    if dtype == torch.bfloat16 and kernel in TC_BODIES:
        return TC_BODIES[kernel]
    return f"FMA {name} (CUDA cores)"


# --------------------------------------------------------------- volume ----

def make_blobs(cfg, gen, dev):
    """Synapse-sized blob centres, spread like examples/synapse_pipeline.py
    at the detection level: ~4.6e-5 blobs per level-r voxel."""
    X, Y, Z = cfg["volume"]
    f = 1 << cfg["r"]
    margin = 8 * f
    u = torch.rand((cfg["n_blobs"], 3), generator=gen, device=dev)
    lo = torch.tensor([margin, margin, 8], device=dev)
    hi = torch.tensor([X - margin, Y - margin, Z - 8], device=dev)
    return (lo + u * (hi - lo)).long()


def make_slab(cfg, x0, centres, gen, dev):
    """Level-0 EM slab [x0, x0 + slab): noise + blobs + a vessel, uint8.

    The level-r picture reads like the example volume: noise sd 4, blobs of
    amplitude 90 with exp(-d2 / 9) profiles (Z twice as steep), a bright
    vessel of +60.  Level 0 is 2^r finer in X and Y, so blobs are 2^r wider
    there and the noise is 2^r stronger (averaging 4^r voxels divides it).
    """
    X, Y, Z = cfg["volume"]
    f = 1 << cfg["r"]
    n = cfg["slab"]
    vol = torch.randn((n, Y, Z), generator=gen, device=dev).mul_(4.0 * f).add_(100.0)
    w_xy, w_z = 7 * f, 4
    near = centres[(centres[:, 0] >= x0 - w_xy) & (centres[:, 0] < x0 + n + w_xy)]
    if near.shape[0]:
        ax = torch.arange(-w_xy, w_xy, device=dev)
        az = torch.arange(-w_z, w_z, device=dev)
        dx, dy, dz = torch.meshgrid(ax, ax, az, indexing="ij")
        prof = 90.0 * torch.exp(-(((dx / f) ** 2 + (dy / f) ** 2
                                   + (2.0 * dz) ** 2) / 9.0))
        xs = near[:, 0, None] + dx.reshape(1, -1)
        keep = (xs >= x0) & (xs < x0 + n)
        ys = near[:, 1, None] + dy.reshape(1, -1)
        zs = near[:, 2, None] + dz.reshape(1, -1)
        flat = ((xs - x0) * Y + ys) * Z + zs
        vals = prof.reshape(1, -1).expand_as(flat)
        vol.view(-1).index_add_(0, flat[keep], vals[keep])
    vx0, vx1 = X * 40 // 128, X * 90 // 128
    a, b = max(vx0, x0), min(vx1, x0 + n)
    if a < b:
        vol[a - x0:b - x0, Y * 40 // 128:Y * 50 // 128, :] += 60.0
    return vol.clamp_(0, 255).to(torch.uint8)


def timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


# ------------------------------------------------------------ main path ----

def main_path(cfg, dev, report):
    spec = DatasetSpec("bock11-share", cfg["volume"],
                       n_resolutions=cfg["n_resolutions"], dtype="uint8")
    gen = torch.Generator(device=dev).manual_seed(11)
    store = DeviceCuboidStore(spec, device=dev)
    centres = make_blobs(cfg, gen, dev)

    def ingest_all():
        for x0 in range(0, cfg["volume"][0], cfg["slab"]):
            cut.ingest(store, 0, make_slab(cfg, x0, centres, gen, dev),
                       offset=(x0, 0, 0))

    _, t_ingest = timed(dev, ingest_all)
    _, t_hier = timed(dev, lambda: cut.build_hierarchy(store))
    proj = AnnotationProject("synapses", spec, device=dev)
    n_written, t_detect = timed(dev, lambda: sd.run_parallel_detection(
        store, proj, r=cfg["r"], tile=cfg["tile"], n_workers=cfg["workers"],
        threshold=2.0, min_voxels=4, batch_size=40,
        lowres_level=cfg["lowres"]))
    det_voxels = int(np.prod(spec.grid(cfg["r"]).volume_shape))
    report["phases"] = dict(ingest_s=t_ingest, hierarchy_s=t_hier,
                            detect_s=t_detect)
    report["detections"] = n_written
    report["detect_voxels_per_s"] = det_voxels / t_detect
    report["packed_bytes"] = store.nbytes
    log(f"main path: ingest {t_ingest:.3f} s, hierarchy {t_hier:.3f} s, "
        f"detection {t_detect:.3f} s -> {n_written} synapses, "
        f"{det_voxels / t_detect:.4g} voxels/s through cutout->detect->annotate")
    return spec, store, proj


def check_results(cfg, dev, spec, store, proj, report):
    r = cfg["r"]
    if report["detections"] <= 0:
        raise RuntimeError("the main path wrote no detections")
    for lev in range(spec.n_resolutions):
        packed = store.peek(lev)
        if packed is None or not bool(packed.any()):
            raise RuntimeError(f"level {lev} is empty after build_hierarchy")
    # level 1 holds the downsampled level 0 (a box away from the edges)
    v1 = spec.grid(1).volume_shape
    lo1 = (v1[0] // 4, v1[1] // 3, 1)
    hi1 = (v1[0] // 2 + 3, v1[1] // 2 + 5, v1[2] - 1)
    want = downsample_block(cut.cutout(store, 0, (2 * lo1[0], 2 * lo1[1], lo1[2]),
                                       (2 * hi1[0], 2 * hi1[1], hi1[2])), (0, 1))
    if not torch.equal(cut.cutout(store, 1, lo1, hi1), want):
        raise RuntimeError("level 1 is not the downsampled level 0")

    # 4 tiles again, with cutouts through the plain gather: the detections
    # must be the stored ones, label for label
    grid = spec.grid(r)
    low = cut.cutout(store, cfg["lowres"], (0, 0, 0),
                     spec.grid(cfg["lowres"]).volume_shape)
    excl_full = sd.large_structure_mask(low.to(torch.float32))
    tiles = sd.tiling(grid.volume_shape, cfg["tile"])
    boxes = [tiles[i] for i in sorted({0, len(tiles) // 3,
                                       2 * len(tiles) // 3, len(tiles) - 1})]
    packed = store.peek(r)
    n_dets = 0
    for lo, hi in boxes:
        gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
        plan = torch.from_numpy(cells).to(dev)
        via_ref = cutout_gather_ref(packed, plan, gshape,
                                    [l - a for l, a in zip(lo, alo)],
                                    [h - l for l, h in zip(lo, hi)])
        via_kernel = cut.cutout(store, r, lo, hi)
        if not torch.equal(via_kernel, via_ref):
            raise RuntimeError(f"tile {lo}: kernel cutout != plain cutout")
        excl = sd.scale_mask(excl_full, cfg["lowres"] - r, lo, hi)
        dets, lab = sd.detect_synapses(via_ref, threshold=2.0, min_voxels=4,
                                       exclusion_mask=excl)
        stored = proj.read(r, lo, hi)
        fg = lab != 0
        if not torch.equal(stored != 0, fg):
            raise RuntimeError(f"tile {lo}: stored annotations != detections")
        # one stored id per detection label and one label per stored id
        pairs = torch.unique(torch.stack([stored[fg], lab[fg]]), dim=1)
        if not (pairs.shape[1] == len(dets)
                == int(torch.unique(pairs[0]).numel())
                == int(torch.unique(pairs[1]).numel())):
            raise RuntimeError(f"tile {lo}: stored ids != detections")
        n_dets += len(dets)
    report["recheck_tiles"] = dict(tiles=len(boxes), detections=n_dets)
    log(f"re-checked {len(boxes)} tiles through the plain gather: "
        f"{n_dets} detections, identical to the stored labels")


def profile_window(dev, fn, ranges=()):
    """torch.profiler over one call of ``fn`` (after a warm-up call): the
    ops that take the host's and the device's time, the device's busy
    time over the window's wall time, and the device time launched inside
    each profiler range named in ``ranges`` (`range_device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm the allocator and the kernels
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ops, kernels, busy = [], [], 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if str(e.device_type).endswith("CPU"):
            ops.append((e.key, e.count, e.self_cpu_time_total, dev_us))
        elif not getattr(e, "is_user_annotation", False):
            # kernels, copies and fills as the device ran them (not the
            # device-side spans of profiler ranges)
            busy += dev_us / 1e6
            kernels.append((e.key, e.count, 0, dev_us))
    top_dev = sorted(ops, key=lambda x: -x[3])[:8]
    top_cpu = sorted(ops, key=lambda x: -x[2])[:8]
    top_kernels = sorted(kernels, key=lambda x: -x[3])[:8]
    prof_report = dict(wall_s=wall, device_busy_s=busy,
                       device_idle_share=1 - busy / wall,
                       device_ops=sum(k[1] for k in kernels),
                       top_device=top_dev, top_host=top_cpu,
                       top_kernels=top_kernels)
    if ranges:
        prof_report["ranges"] = range_device_ms(prof, ranges)
    return out, prof_report


def range_device_ms(prof, names):
    """The device time of the work launched inside each named profiler
    range, summed over the range's occurrences: each op's own kernels go
    to the ranges whose host interval holds the op's start, so the work
    that autograd's thread launches while the caller waits in a range
    counts in it."""
    cpu = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    launched = [(e.time_range.start, sum(k.duration for k in e.kernels)) for e in cpu
                if e.kernels]
    out = {}
    for n in names:
        spans = [(e.time_range.start, e.time_range.end) for e in cpu if e.name == n]
        out[n] = dict(calls=len(spans), ms=sum(us for t, us in launched
                                                for a, b in spans if a <= t <= b) / 1e3)
    return out


def log_profile(label, p):
    log(f"profile of {label}: wall {p['wall_s']:.4f} s, device busy "
        f"{p['device_busy_s']:.4f} s (idle share {p['device_idle_share']:.3f}), "
        f"{p['device_ops']} kernels, copies and fills on the device")
    for kind, top, col in (("device", p["top_device"], 3), ("host", p["top_host"], 2),
                           ("kernels'", p["top_kernels"], 3)):
        log(f"  top {kind} ops: " + "; ".join(
            f"{t[0][:48]} x{t[1]} {t[col] / 1e3:.1f} ms" for t in top))


def where_time_goes(cfg, dev, spec, store, report, n_tiles=2):
    """`detect_tile` on a few tiles, one worker, under the profiler."""
    r = cfg["r"]
    low = cut.cutout(store, cfg["lowres"], (0, 0, 0),
                     spec.grid(cfg["lowres"]).volume_shape)
    excl_full = sd.large_structure_mask(low.to(torch.float32))
    proj = AnnotationProject("profile", spec, device=dev)
    tiles = sd.tiling(spec.grid(r).volume_shape, cfg["tile"])[-n_tiles:]

    def run():
        return sum(sd.detect_tile(store, proj, r, lo, hi,
                                  sd.scale_mask(excl_full, cfg["lowres"] - r,
                                                lo, hi), min_voxels=4)
                   for lo, hi in tiles)

    n, prof = profile_window(dev, run)
    report["profile"] = dict(tiles=len(tiles), detections=n, **prof)
    log_profile(f"{len(tiles)} tiles ({n} detections), one worker", prof)


def small_pipeline_vs_cpu(dev, report):
    """The example's 128 x 128 x 32 pipeline on the card and on the CPU."""
    rng = np.random.default_rng(7)
    shape = (128, 128, 32)
    vol = rng.normal(100, 4, size=shape).astype(np.float32)
    xx, yy, zz = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for _ in range(24):
        c = [int(rng.integers(8, s - 8)) for s in shape]
        d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + ((zz - c[2]) * 2) ** 2
        vol += 90.0 * np.exp(-d2 / 9.0)
    vol[40:90, 40:50, :] += 60.0
    spec = DatasetSpec("cortex", shape, dtype="float32", n_resolutions=2,
                       base_cuboid=(32, 32, 16))
    out = {}
    for d in (dev, torch.device("cpu")):
        store = DeviceCuboidStore(spec, device=d)
        cut.ingest(store, 0, vol)
        cut.build_hierarchy(store)
        proj = AnnotationProject("det", spec, device=d)
        n = sd.run_parallel_detection(store, proj, r=0, tile=(64, 64, 32),
                                      n_workers=1, threshold=2.0,
                                      min_voxels=4, lowres_level=1)
        out[d.type] = (n, proj.read(0, (0, 0, 0), shape).cpu())
    if out[dev.type][0] != out["cpu"][0] or not torch.equal(
            out[dev.type][1], out["cpu"][1]):
        raise RuntimeError("small pipeline: card and CPU results differ")
    report["small_pipeline_detections"] = out["cpu"][0]
    log(f"small pipeline: {out['cpu'][0]} detections, card == CPU")


# -------------------------------------------------------------- kernels ----

def event_times(dev, fn, reps=25):
    """Per-call device time (ms) by CUDA events, median of ``reps``.  The
    calls queue behind a device-side sleep so host launch gaps do not
    count."""
    fn()
    torch.cuda.synchronize(dev)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for i in range(reps):
        starts[i].record()
        fn(i)
        ends[i].record()
    torch.cuda.synchronize(dev)
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def gather_case(packed, grid, lo, hi, dev):
    gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
    plan = torch.from_numpy(cells).to(dev)
    args = (packed, plan, gshape, [l - a for l, a in zip(lo, alo)],
            [h - l for l, h in zip(lo, hi)])
    return args


def compare_gather(packed, grid, lo, hi, dev, label, errs):
    """Kernel vs plain on one box: bit-exact, and the largest value error."""
    args = gather_case(packed, grid, lo, hi, dev)
    got = gather_ops.cutout_gather_cuda(*args)
    want = cutout_gather_ref(*args)
    torch.cuda.synchronize(dev)
    same = (got.shape == want.shape
            and torch.equal(got.view(torch.uint8), want.view(torch.uint8)))
    if not same:
        raise RuntimeError(f"cutout_gather {label}: kernel != plain")
    errs.append(float((got.double() - want.double()).abs().max()))
    return args


def kernel_checks(dev, store, spec, cfg, report, peak):
    errs = []
    # dtypes x box kinds on a small level-shaped array
    gen = torch.Generator(device=dev).manual_seed(5)
    for cs in [(128, 128, 16), (64, 64, 64)]:
        grid = CuboidGrid((3 * cs[0] - 37, 2 * cs[1] + 11, 5 * cs[2] - 3), cs)
        for dt in (torch.uint8, torch.uint16, torch.int32, torch.float32):
            shape = (grid.n_cells,) + cs
            packed = (torch.randn(shape, generator=gen, device=dev)
                      if dt.is_floating_point else
                      torch.randint(0, 256, shape[:-1] + (cs[2] * dt.itemsize,),
                                    generator=gen, device=dev,
                                    dtype=torch.uint8).view(dt))
            v = grid.volume_shape
            for label, lo, hi in [
                    ("aligned", (0, 0, 0), (cs[0], cs[1], 2 * cs[2])),
                    ("unaligned", (5, 3, 2), (v[0] - 9, v[1] - 4, v[2] - 7)),
                    ("edge", (v[0] - 40, v[1] - 33, v[2] - 5), v),
                    ("voxel", (v[0] - 1, 17, 3), (v[0], 18, 4))]:
                compare_gather(packed, grid, lo, hi, dev,
                               f"{dt} {cs} {label}", errs)
    log(f"cutout_gather: {len(errs)} small cases bit-exact vs plain")

    # at the main path's shapes
    cases = {}
    r = cfg["r"]
    g_r = spec.grid(r)
    tiles = sd.tiling(g_r.volume_shape, cfg["tile"])[:16]
    cases["tile"] = [compare_gather(store.peek(r), g_r, lo, hi, dev,
                                    f"tile {lo}", errs) for lo, hi in tiles]
    g0 = spec.grid(0)
    big = [((1024 * i, 1024 * j, 64 * k), (1024 * (i + 1), 1024 * (j + 1), 64 * (k + 1)))
           for i, j, k in [(0, 0, 0), (7, 7, 3), (3, 5, 1), (6, 2, 2)]]
    cases["l0_1024x1024x64"] = [compare_gather(store.peek(0), g0, lo, hi, dev,
                                               f"level0 {lo}", errs)
                                for lo, hi in big]
    # cells past byte offset 2^31 (Morton cells >= 8192 at level 0)
    lo, hi = (8192 - 300, 8192 - 277, 200), (8192 - 3, 8192 - 1, 255)
    args = compare_gather(store.peek(0), g0, lo, hi, dev, "past 2^31", errs)
    first = int(args[1].min()) * g0.cuboid_voxels
    if first < 2 ** 31:
        raise RuntimeError("the far box does not reach past byte 2^31")
    cases["past_2^31"] = [args]
    log(f"cutout_gather: {len(errs)} cases bit-exact incl. cells from byte "
        f"{first} on")

    timings = {}
    for name, arglist in cases.items():
        out_bytes = sum(int(np.prod(a[4])) * a[0].element_size() for a in arglist)
        plan_bytes = sum(a[1].numel() * 4 for a in arglist)
        k = len(arglist)
        ms = event_times(dev, lambda i=0: gather_ops.cutout_gather_cuda(*arglist[i % k]))
        plain = event_times(dev, lambda i=0: cutout_gather_ref(*arglist[i % k]))
        per_bytes = (2 * out_bytes + plan_bytes) / k
        bound = per_bytes / peak * 1e3
        timings[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                             bytes=per_bytes, gbps=per_bytes / ms / 1e6,
                             hbm_share=bound / ms, boxes=k)
        log(f"cutout_gather {name}: {ms:.4f} ms/box (plain {plain:.4f} ms), "
            f"{per_bytes / ms / 1e6:.1f} GB/s = {100 * bound / ms:.1f}% of the "
            f"{peak / 1e12:.2f} TB/s HBM peak (bound {bound:.4f} ms)")
    report["cutout_gather"] = timings
    return max(errs), timings["tile"]


# -------------------------------------------------------- serving path ----

def serving_model(sc, dev):
    """The path's arch (full width, or the smoke widths) with seeded weights."""
    cfg = get_smoke_config(sc["arch"]) if sc["smoke"] else get_config(sc["arch"])
    gen = torch.Generator(device=dev).manual_seed(12)
    return cfg, build_model(cfg, device=dev, generator=gen)


def make_requests(sc, vocab):
    rng = np.random.default_rng(48)
    lo, hi = sc["plen"]
    return [Request(rid, rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist(),
                    sc["max_new"]) for rid in range(sc["requests"])]


def serving_path(sc, dev, cfg, model, report):
    """Batched prefill + greedy decode, then continuous batching (where the
    path has slots), through the serving entry points.  One run each."""
    B, P, steps = sc["batch"], sc["prompt"], sc["steps"]
    gen = torch.Generator(device=dev).manual_seed(13)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
    prefill, step = make_prefill_step(model, cfg), make_serve_step(model, cfg)

    def first_token():
        lg, cache = prefill(prompts, cache_len=P + steps)
        return torch.argmax(lg[:, -1:], dim=-1).to(torch.int32), cache

    (nxt, cache), t_prefill = timed(dev, first_token)

    def decode():
        tok, c, out = nxt, cache, []
        for i in range(steps):
            tok, _, c = step(c, tok, P + i)
            out.append(tok)
        return torch.cat(out, 1)

    generated, t_decode = timed(dev, decode)
    if generated.shape != (B, steps):
        raise RuntimeError("the serving path returned the wrong number of tokens")
    if not (0 <= int(generated.min()) and int(generated.max()) < cfg.vocab):
        raise RuntimeError("the serving path generated ids outside the vocabulary")
    report[sc["key"]] = out = dict(
        arch=cfg.name, batch=B, prompt=P, decode_steps=steps, time_to_first_token_s=t_prefill,
        prefill_tokens_per_s=B * P / t_prefill, decode_s=t_decode,
        decode_tokens_per_s=B * steps / t_decode)
    line = (f"{cfg.name} serving (one run each): prefill {B} x {P} tokens {t_prefill:.4f} s "
            f"(time to first token; {B * P / t_prefill:.6g} tokens/s), {steps} decode "
            f"steps {t_decode:.4f} s ({B * steps / t_decode:.6g} tokens/s)")
    if "slots" in sc:
        eng = ContinuousBatcher(model, cfg, n_slots=sc["slots"],
                                cache_len=sc["plen"][1] + sc["max_new"], device=dev)
        for req in make_requests(sc, cfg.vocab):
            eng.submit(req)
        done, t_cb = timed(dev, eng.run)
        n_gen = sum(len(v) for v in done.values())
        if len(done) != sc["requests"] or any(len(v) != sc["max_new"]
                                              for v in done.values()):
            raise RuntimeError("the batcher returned the wrong number of tokens")
        out.update(batcher_s=t_cb, batcher_generated_tokens=n_gen,
                   batcher_tokens_per_s=n_gen / t_cb, batcher_occupancy=eng.occupancy,
                   batcher_ticks=eng.ticks)
        line += (f"; batcher {sc['requests']} requests over {sc['slots']} slots "
                 f"{t_cb:.4f} s, {n_gen / t_cb:.6g} generated tokens/s, occupancy "
                 f"{eng.occupancy:.4f}")
    log(line)
    return prompts, generated, cache


def serving_profile(sc, dev, cfg, model, prompts, cache, generated, report,
                    n_steps=8):
    """The batched prefill and decode steps under the profiler."""
    step = make_serve_step(model, cfg)
    P = sc["prompt"]

    def decode():
        tok, c = generated[:, -1:], cache
        for i in range(n_steps):  # rewrites the last positions, in range
            tok, _, c = step(c, tok, P + sc["steps"] - n_steps + i)
        return tok

    _, prof = profile_window(dev, decode)
    prof["device_ops_per_step"] = prof["device_ops"] / n_steps
    report[sc["key"] + "_profile"] = dict(decode_steps=n_steps, decode=prof)
    log_profile(f"{cfg.name}: {n_steps} decode steps at batch {sc['batch']} "
                f"({prof['device_ops_per_step']:.0f} device ops per step)", prof)
    _, prof = profile_window(dev, lambda: make_prefill_step(model, cfg)(prompts)[0])
    report[sc["key"] + "_profile"]["prefill"] = prof
    log_profile(f"{cfg.name}: a prefill of {tuple(prompts.shape)} tokens", prof)


def published_ssm_init(tree, seed):
    """A_log and dt_bias of an ssm parameter tree by Mamba-2's published
    init: A in -[1, 16], dt log-uniform in [1e-3, 1e-1] through dt_bias =
    softplus^-1(dt).  (The repo's init, zeros, gives A = -1 and dt ~ 0.7,
    under which no state outlives a chunk.)"""
    rng = np.random.default_rng(seed)
    shape = np.shape(tree["A_log"])
    tree["A_log"] = np.log(rng.uniform(1, 16, size=shape)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
    tree["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    return tree


def serving_small_vs_cpu(dev, report, arch="smollm-135m"):
    """A 2-layer fp32 model at the smoke widths: the same greedy tokens on
    the card and on the CPU, batched and through the batcher."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    tree = lm_params_to_numpy(cpu)
    if cfg.family == "ssm":
        published_ssm_init(tree["blocks"]["ssm"], seed=17)
        cpu = lm_params_from_numpy(cfg, tree, "cpu")
    card = lm_params_from_numpy(cfg, tree, dev)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(4, 24)).astype(np.int32))
    served, routes = {}, {}
    for model in (card, cpu):
        routes[model.device.type] = calls = []
        with (moe_mod.observe(routing_of(calls)) if cfg.family == "moe"
              else contextlib.nullcontext()):
            lg, cache = make_prefill_step(model, cfg)(tok.to(model.device), cache_len=40)
            nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            step, out = make_serve_step(model, cfg), [nxt.cpu()]
            for i in range(15):
                nxt, _, cache = step(cache, nxt, 24 + i)
                out.append(nxt.cpu())
            eng = ContinuousBatcher(model, cfg, n_slots=2, cache_len=40, device=model.device)
            for rid, n in enumerate((5, 17, 3, 24)):
                eng.submit(Request(rid, tok[rid % 4, :n].tolist(), 12))
            served[model.device.type] = (torch.cat(out, 1), eng.run())
    if cfg.family == "moe":
        report[f"{arch}_routing"] = router_flips(f"{arch} smoke model", routes[dev.type],
                                                 routes["cpu"], cfg.top_k)
    if not torch.equal(served[dev.type][0], served["cpu"][0]):
        raise RuntimeError(f"{arch} smoke model: batched tokens differ between card and CPU")
    if served[dev.type][1] != served["cpu"][1]:
        raise RuntimeError(f"{arch} smoke model: batcher tokens differ between card and CPU")
    report[f"{arch}_small_vs_cpu"] = dict(batched_tokens=int(served["cpu"][0].numel()),
                                          batcher_requests=len(served["cpu"][1]))
    log(f"{arch} smoke model: {served['cpu'][0].numel()} batched tokens and "
        f"{len(served['cpu'][1])} batcher requests, card == CPU")


BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FP32_TOL = dict(atol=2e-5, rtol=2e-5)
# At full width the attention outputs are small (the seeded weights give v
# of std ~0.5 and a near-uniform softmax, so |out| ~ 0.5 / sqrt(keys), about
# 0.01 at 2,048 keys): the bf16 check's absolute term is a share of the
# outputs' mean magnitude, not the 2e-2 of the randn cases.  Rounding p
# against a running max, as the kernels do, moves the outputs by a few
# percent of that mean at most (rows of few keys); dropping one of six
# decode splits moves most of them by far more.
FULL_WIDTH_BF16_ATOL_SHARE = 5e-2


def sliced(plain, n):
    """``plain`` over the batch in slices of ``n`` sequences (the plain
    attention's scores take O(Sq * Skv) memory per sequence), concatenated."""
    return lambda *args: torch.cat([plain(*(a[i:i + n] for a in args))
                                    for i in range(0, args[0].shape[0], n)])


def layer0_attention_vs_plain(sc, dev, cfg, model, prompts, cache, report, errs):
    """Layer 0's attention at full width and at the path's own shapes:
    kernel vs plain version on the same card tensors, at the prefill of
    the whole batch and at one decode step over the whole cache with mixed
    lengths, at the plan's split count and at 8 splits (the in-launch merge
    of flash_decode, whether or not the plan splits this shape): in bf16
    with an absolute tolerance scaled to the outputs, and again with the
    same tensors taken to fp32 at the fp32 tolerance."""
    p = model.blocks[0]
    n = prompts.shape[0]
    x = rms_norm(model.embed_tokens(prompts), p.ln1, cfg.norm_eps)
    positions = torch.arange(prompts.shape[1], device=dev).expand(n, -1)
    q, k, v = qkv(p.attn, cfg, x, positions)
    del x
    scale = cfg.head_dim ** -0.5

    B, S = cache["blocks"]["k"].shape[1:3]
    gen = torch.Generator(device=dev).manual_seed(14)
    lens = torch.randint(S - sc["steps"], S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev)
    xd = rms_norm(model.embed_tokens(tok), p.ln1, cfg.norm_eps)
    qd = rotary((xd @ p.attn.w_q).reshape(B, 1, cfg.n_heads, cfg.head_dim),
                (lens - 1).long()[:, None], cfg.rope_theta)
    ck, cv = cache["blocks"]["k"][0], cache["blocks"]["v"][0]
    splits = fd_ops.plan_for(qd, ck).nsplit
    most = fd_ops.MAX_SPLITS

    checks = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        cases = (
            ("prefill", "flash_attention",
             lambda a, b, c: fa_ops.flash_attention(a, b, c, causal=True, scale=scale),
             sliced(lambda a, b, c: flash_attention_ref(a, b, c, causal=True, scale=scale), 8),
             (q, k, v)),
            ("decode", "flash_decode",
             lambda a, b, c: fd_ops.flash_decode(a, b, c, lens, scale=scale),
             lambda a, b, c: flash_decode_ref(a, b, c, lens, scale=scale),
             (qd, ck, cv)),
            (f"decode_{most}_splits", "flash_decode",
             lambda a, b, c: fd_ops.flash_decode_cuda(a, b, c, lens, scale=scale, nsplit=most),
             lambda a, b, c: flash_decode_ref(a, b, c, lens, scale=scale),
             (qd, ck, cv)))
        for phase, kname, kernel, plain, args in cases:
            args = [t.to(dt) for t in args]
            got, want = kernel(*args), plain(*args)
            mean_abs = float(want.float().abs().mean())
            tol = (dict(atol=FULL_WIDTH_BF16_ATOL_SHARE * mean_abs, rtol=BF16_TOL["rtol"])
                   if dt == torch.bfloat16 else FP32_TOL)
            err = check_close(f"layer-0 {phase} attention {tag}", got, want, tol,
                              errs[kname])
            checks[f"{phase}_{tag}"] = dict(max_abs_err=err, mean_abs_out=mean_abs, **tol)
            log(f"layer-0 {phase} attention, {tag} [{kname}: {body(kname, dt)}], full width: "
                f"max |kernel - plain| "
                f"{err:.3g}, mean |out| {mean_abs:.3g}, within atol {tol['atol']:.3g} "
                f"rtol {tol['rtol']:.3g}")
            del got, want, args
    report[sc["key"]]["layer0_attention"] = dict(
        prefill_shape=list(q.shape), decode_cache=list(ck.shape),
        decode_lens=[int(lens.min()), int(lens.max())], decode_splits=splits, checks=checks)
    log(f"{cfg.name} layer-0 attention at full width: prefill {n} x {prompts.shape[1]} "
        f"({cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads), decode over "
        f"{B} x {S} cached positions, lens {int(lens.min())}-{int(lens.max())}, "
        f"{splits} splits (the plan) and {most}")


def batcher_decode_checks(sc, dev, cfg, report, errs):
    """`flash_decode` at the batcher's shape of the path (its slots over its
    cache, the model's heads) against its plain version, with per-slot
    lengths from 1 (an idle slot) to the whole cache, fp32 and bf16 (the
    tolerances of the small cases)."""
    B, S = sc["slots"], sc["plen"][1] + sc["max_new"]
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(23)
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[:2] = torch.tensor([1, S], dtype=torch.int32, device=dev)
    splits, err = {}, {}
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, kc, vc = (torch.randn(s, generator=gen, device=dev).to(dt)
                     for s in ((B, 1, H, D), (B, S, K, D), (B, S, K, D)))
        splits[str(dt)[6:]] = fd_ops.plan_for(q, kc).nsplit
        got = fd_ops.flash_decode(q, kc, vc, lens, scale=D ** -0.5)
        want = flash_decode_ref(q, kc, vc, lens, scale=D ** -0.5)
        err[str(dt)[6:]] = check_close(f"{cfg.name} batcher flash_decode {dt} "
                                       f"{(B, S, H, K, D)}", got, want, tol, errs)
    report[sc["key"]]["batcher_decode_check"] = dict(shape=[B, S, H, K, D], splits=splits,
                                                     max_abs_err=err)
    log(f"{cfg.name} batcher decode attention ({B} slots x {S} cached positions, {H} "
        f"query heads over {K} kv heads, splits {splits}) [flash_decode: "
        f"{body('flash_decode', torch.bfloat16)}]: max |kernel - plain| {err}")


def check_close(label, got, want, tol, errs):
    torch.cuda.synchronize(got.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{label}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{label}: non-finite kernel output")
    try:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    except AssertionError as e:
        raise RuntimeError(f"{label}: kernel != plain\n{e}") from None
    err = float((got.float() - want.float()).abs().max())
    errs.append(err)
    return err


# ------------------------------------------------------ attention kernels ----

ATTN_SHAPES = [  # (B, Sq, Skv, H, K, D): tests/test_kernels.py:37-44
    (1, 64, 64, 4, 4, 64), (2, 128, 128, 8, 2, 64), (1, 96, 96, 4, 1, 128),
    (1, 32, 128, 4, 2, 64), (2, 64, 64, 4, 4, 256)]
FD_SHAPES = [  # (B, S, H, K, D, cache_len): tests/test_kernels.py:262-267
    (2, 128, 8, 2, 64, 128), (1, 256, 4, 4, 64, 100), (2, 96, 4, 1, 128, 50),
    (1, 64, 8, 8, 64, 1),
    (4, 2176, 9, 3, 64, 2100),  # smollm's heads: the kv axis split, then merged
    (2, 256, 10, 1, 64, 200), (1, 256, 16, 1, 128, 256),  # G 10 and 16
    (2, 2176, 16, 1, 64, 2100)]  # G 16 over a split kv axis


def attention_kernel_checks(dev, errs):
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    n = split_cases = 0
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for B, Sq, Skv, H, K, D in ATTN_SHAPES:
            q, k, v = randn((B, Sq, H, D), dt), randn((B, Skv, K, D), dt), randn((B, Skv, K, D), dt)
            for causal, window in ((True, None), (False, None), (True, 48)):
                got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
                want = flash_attention_ref(q, k, v, causal=causal, scale=D ** -0.5,
                                           window=window)
                check_close(f"flash_attention {dt} {(B, Sq, Skv, H, K, D)} causal={causal} "
                            f"window={window}", got, want, tol, errs["flash_attention"])
                n += 1
        # tests/test_kernels.py:283: per-sequence lengths, then the same over splits
        for B, S, H, K, D, clen in FD_SHAPES + [(3, 64, 4, 2, 64, (5, 33, 64)),
                                                (3, 1024, 9, 3, 64, (300, 777, 1024))]:
            q, kc, vc = randn((B, 1, H, D), dt), randn((B, S, K, D), dt), randn((B, S, K, D), dt)
            lens = (torch.tensor(clen, dtype=torch.int32, device=dev)
                    if isinstance(clen, tuple) else clen)
            got = fd_ops.flash_decode(q, kc, vc, lens, scale=D ** -0.5)
            want = flash_decode_ref(q, kc, vc, lens, scale=D ** -0.5)
            check_close(f"flash_decode {dt} {(B, S, H, K, D)} lens={clen}", got, want, tol,
                        errs["flash_decode"])
            n += 1
            split_cases += fd_ops.plan_for(q, kc).nsplit > 1
    if split_cases < 4:
        raise RuntimeError("the flash_decode checks do not reach the split path in "
                           "both dtypes")
    log(f"flash_attention ({body('flash_attention', torch.bfloat16)} and "
        f"{body('flash_attention', torch.float32)}) / flash_decode "
        f"({body('flash_decode', torch.bfloat16)}): {n} small cases within tolerance of plain "
        f"({split_cases} of them over split kv axes)")


def attention_timings(sc, dev, cfg, name, report):
    """Each attention kernel at the serving path's shapes: kernel, plain
    version and one PyTorch call for the same function, CUDA events."""
    import torch.nn.functional as F

    B, S = sc["batch"], sc["prompt"]
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    flops, hbm = bf16_peak_flops(name), hbm_peak_bytes_per_s(name)
    scale = D ** -0.5
    out = {}

    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, K, D), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, K, D), generator=gen, device=dev).to(bf)
    pairs = S * (S + 1) // 2  # live (query, key) pairs of a causal square
    ops_ = 4 * B * H * D * pairs
    bytes_ = 2 * (2 * q.numel() + k.numel() + v.numel())
    ms = event_times(dev, lambda i=0: fa_ops.flash_attention(q, k, v, causal=True, scale=scale))
    plain = event_times(dev, lambda i=0: flash_attention_ref(q, k, v, causal=True, scale=scale))
    lib = event_times(dev, lambda i=0: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        scale=scale, enable_gqa=True))
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    out["flash_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                  body=body("flash_attention", bf),
                                  bound_by="operations" if ops_ / flops > bytes_ / hbm
                                  else "bytes", operations=ops_, bytes=bytes_,
                                  shape=[B, S, S, H, K, D], tflops=ops_ / ms / 1e9)
    del q, k, v
    torch.cuda.empty_cache()

    Sc = S + sc["steps"]
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(bf)
    kc = torch.randn((B, Sc, K, D), generator=gen, device=dev).to(bf)
    vc = torch.randn((B, Sc, K, D), generator=gen, device=dev).to(bf)
    lens = torch.randint(S, Sc, (B,), generator=gen, device=dev, dtype=torch.int32)
    live = int(lens.sum())
    bytes_ = 2 * (2 * live * K * D + 2 * q.numel()) + 4 * B
    ops_ = 4 * H * D * live
    mask = (torch.arange(Sc, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    ms = event_times(dev, lambda i=0: fd_ops.flash_decode(q, kc, vc, lens, scale=scale))
    plain = event_times(dev, lambda i=0: flash_decode_ref(q, kc, vc, lens, scale=scale))
    lib = event_times(dev, lambda i=0: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
        scale=scale, enable_gqa=True))
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    out["flash_decode"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                               bound_by="bytes" if bytes_ / hbm >= ops_ / flops
                               else "operations", operations=ops_, bytes=bytes_,
                               shape=[B, Sc, H, K, D], lens=[int(lens.min()), int(lens.max())],
                               gbps=bytes_ / ms / 1e6,
                               splits=fd_ops.plan_for(q, kc).nsplit,
                               body=body("flash_decode", bf))
    for kname, t in out.items():
        log(f"{kname} {t['shape']} [{body(kname, bf)}]: {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {t['library_ms']:.4f} ms), bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} = {100 * t['bound_ms'] / t['ms']:.2f}% "
            f"of the card's peak")
    report["attention_timings"] = out
    return out


# ------------------------------------------------------------ ssd scan ----

SSD_REL = 1e-4
# The scan's outputs are fp32 on both sides, from the same inputs (bf16
# ones too), so they are held at an fp32-level tolerance: rtol 1e-4 and an
# atol of 1e-4 of the largest |output|.  The two cumsums round differently;
# with the published ranges |cum| reaches ~400 within a chunk, where an
# fp32 ulp is 3.05e-5, and a few such ulps in exp(cum_i - cum_j) are ~1e-4
# of a term.  (A bf16 ulp is 3.9e-3.)
SSD_SHAPES = [  # (B, S, H, P, N, chunk): tests/test_kernels.py:171-177, then
    (1, 64, 2, 32, 32, 32), (2, 128, 4, 64, 64, 32), (1, 96, 2, 32, 64, 32),
    (1, 80, 3, 16, 32, 32), (2, 64, 2, 64, 128, 64),
    (2, 100, 3, 8, 16, 256),     # Q = S = 100, not a power of two; P = 8
    (2, 300, 3, 16, 16, 48),     # Q = 48, a ragged last chunk of 12
    (2, 77, 3, 24, 40, 24),      # P, N multiples of 8 only
    (2, 1000, 4, 64, 128, 256),  # mamba2-370m's heads: Q 256, N 128, P 64
    # one case for each instance of the bf16 body (P, N each up to 64 or
    # 128, exactly so or not) that the shapes above leave out
    (1, 300, 2, 128, 64, 256), (1, 300, 2, 96, 48, 256),
    (1, 300, 2, 96, 128, 256), (1, 300, 2, 48, 96, 256)]


def ssd_tol(want):
    return dict(rtol=SSD_REL, atol=SSD_REL * float(want.abs().max()))


def ssd_draw(gen, shape, dtype, dev, published):
    """x, dt, A, B, C: the JAX tests' draws, or the published ranges."""
    B, S, H, P, N = shape[:5]
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    if published:
        A = -(1 + 15 * torch.rand((H,), generator=gen, device=dev))
        dt = torch.exp(np.log(1e-3) + np.log(100.0) * torch.rand((B, S, H), generator=gen,
                                                                 device=dev))
    else:
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
        A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=dev))
    return x, dt, A, Bm, Cm


def ssd_kernel_checks(dev, errs):
    """The kernel against its plain version over the test shapes, odd and
    ragged chunks, fp32 and bf16, the JAX tests' draws and the published
    ranges."""
    gen = torch.Generator(device=dev).manual_seed(19)
    n = 0
    for shape in SSD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for published in (False, True):
                args = ssd_draw(gen, shape, dt, dev, published)
                got = ssd_ops.ssd_scan(*args, chunk=shape[-1])
                wants = [("plain", ssd_scan_ref(*args, chunk=shape[-1]))]
                if dt == torch.bfloat16:  # and the bf16 body's roundings, emulated
                    wants.append(("split emulation",
                                  ssd_scan_split_ref(*args, chunk=shape[-1])))
                for label, want in wants:
                    for name, g, w in zip(("y", "state"), got, want):
                        check_close(f"ssd_scan {name} {dt} {shape} "
                                    f"{'published' if published else 'jax'} draws vs "
                                    f"{label}", g, w, ssd_tol(w),
                                    errs if label == "plain" else [])
                n += 1
    log(f"ssd_scan ({body('ssd_scan', torch.bfloat16)} and "
        f"{body('ssd_scan', torch.float32)}): {n} small cases within rtol {SSD_REL} and "
        f"{SSD_REL} of max |out| of plain (bf16 also of the split emulation)")


def layer0_ssm_vs_plain(sc, dev, cfg, model, prompts, report, errs):
    """Layer 0's mixer at full width with A and dt by Mamba-2's published
    init: the scan through the kernel and through the plain version on the
    same card tensors, then the mixer's output from each; in bf16, and with
    the tensors taken to fp32.  Prints how much weight the carried state
    has: the median per-chunk decay exp(sum a), and the share of |y| that
    comes across chunk boundaries."""
    blk = model.blocks[0]
    seeded_dt = F.softplus(blk.ssm.dt_bias)  # dt at x . w_dt = 0
    tree = dict(blk.ssm)
    pub = published_ssm_init({k: tree[k].cpu().numpy() for k in ("A_log", "dt_bias")}, 18)
    tree.update({k: torch.from_numpy(v).to(dev) for k, v in pub.items()})
    n = min(8, prompts.shape[0])  # a slice of the batch bounds the plain version's memory
    x = rms_norm(model.embed_tokens(prompts[:n]), blk.ln, cfg.norm_eps)
    S = x.shape[1]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise RuntimeError("the layer-0 check wants whole chunks")
    checks = {}
    for dt in (torch.bfloat16, torch.float32):  # fp32 last: its tensors are reused below
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        p = SimpleNamespace(**{k: v.to(dt) if v.dtype == torch.bfloat16 else v
                               for k, v in tree.items()})
        z, _, xs, dtv, A, Bm, Cm = ssm_inputs(p, cfg, x.to(dt))
        got = ssd_ops.ssd_scan(xs, dtv, A, Bm, Cm, chunk=Q)
        want = ssd_scan_ref(xs, dtv, A, Bm, Cm, chunk=Q)
        for name, g, w in zip(("y", "state"), got, want):
            tol = ssd_tol(w)
            err = check_close(f"layer-0 scan {name} {tag}", g, w, tol, errs)
            checks[f"scan_{name}_{tag}"] = dict(max_abs_err=err, max_abs_out=float(w.abs().max()),
                                                **tol)
        out_k, out_p = ssm_output(p, cfg, z, xs, got[0]), ssm_output(p, cfg, z, xs, want[0])
        mean_abs = float(out_p.float().abs().mean())
        # bf16: as layer 0's attention (an atol of 5% of the mean |out|, the
        # rtol of 2e-2); the scan's y agrees to ~1e-5, so at most a bf16
        # rounding of the mixer's inputs flips.  fp32: the scan's tolerance.
        tol = (dict(atol=FULL_WIDTH_BF16_ATOL_SHARE * mean_abs, rtol=BF16_TOL["rtol"])
               if dt == torch.bfloat16 else ssd_tol(out_p))
        err = check_close(f"layer-0 mixer output {tag}", out_k, out_p, tol, [])
        checks[f"mixer_{tag}"] = dict(max_abs_err=err, mean_abs_out=mean_abs, **tol)
        log(f"layer-0 ssm {tag}, full width: max |kernel - plain| y "
            f"{checks[f'scan_y_{tag}']['max_abs_err']:.3g} (max |y| "
            f"{checks[f'scan_y_{tag}']['max_abs_out']:.3g}), state "
            f"{checks[f'scan_state_{tag}']['max_abs_err']:.3g}, mixer output {err:.3g} "
            f"(mean |out| {mean_abs:.3g})")
    # the carried state's weight, on the fp32 pass's tensors: y against the
    # same chunks scanned each from a zero state
    nc = S // Q
    decay = torch.exp((dtv * A).reshape(n, nc, Q, -1).sum(dim=2))
    seeded = torch.exp(-Q * seeded_dt.float().mean())
    alone = ssd_scan_ref(*(t.reshape((n * nc, Q) + t.shape[2:]) for t in (xs, dtv)), A,
                         *(t.reshape(n * nc, Q, -1) for t in (Bm, Cm)), chunk=Q)[0]
    carried = float((want[0] - alone.reshape(want[0].shape)).norm() / want[0].norm())
    report["layer0_ssm"] = dict(
        batch=n, prompt=S, chunk=Q, checks=checks,
        median_chunk_decay=float(decay.median()),
        chunk_decay_share_above_1pct=float((decay > 1e-2).float().mean()),
        carried_share_of_y=carried, seeded_init_chunk_decay=float(seeded))
    log(f"layer-0 ssm with the published A and dt: median per-chunk decay exp(sum a) "
        f"{float(decay.median()):.4g} ({100 * float((decay > 1e-2).float().mean()):.1f}% of "
        f"(sequence, chunk, head) above 1e-2); the carried state is "
        f"{100 * carried:.2f}% of |y| (seeded init: per-chunk decay ~{float(seeded):.3g})")


def ssd_timing(sc, dev, cfg, name, report):
    """`ssd_scan` at the prefill's shape (x, B and C sliced out of one bf16
    projection, published A and dt): kernel and plain version by CUDA
    events, beside the bound.  No single PyTorch call computes this."""
    B, S = sc["batch"], sc["prompt"]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    gen = torch.Generator(device=dev).manual_seed(20)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    _, dt, A, _, _ = ssd_draw(gen, (B, S, H, 8, 8), torch.bfloat16, dev, True)
    ms = event_times(dev, lambda i=0: ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q))
    plain = event_times(dev, lambda i=0: ssd_scan_ref(x, dt, A, Bm, Cm, chunk=Q))
    qs = [min(Q, S - c) for c in range(0, S, Q)]
    ops_ = B * H * sum(2 * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P) for q in qs)
    bytes_ = (2 * x.numel() + 4 * B * S * H * P + 2 * 2 * B * S * N + 4 * dt.numel()
              + 4 * H + 4 * B * H * P * N)
    flops, hbm = bf16_peak_flops(name), hbm_peak_bytes_per_s(name)
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    sass = _bench.sass_counts(_build._target("ssd_scan"), ("HMMA", "FFMA"))
    t = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
             bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
             operations=ops_, bytes=bytes_, shape=[B, S, H, P, N, Q],
             tflops=ops_ / ms / 1e9, body=body("ssd_scan", x.dtype), sass=sass,
             plan=dict(zip(("smem", "blocks_per_sm", "occupancy", "warps"),
                           ssd_ops.kernel_tc_plan(P, N))))
    report["ssd_timing"] = t
    log(f"ssd_scan {t['shape']} [{t['body']}]: {ms:.4f} ms (plain {plain:.4f} ms, no "
        f"library call), {t['tflops']:.2f} TFLOP/s; bound {bound:.4f} ms by "
        f"{t['bound_by']} = {100 * bound / ms:.2f}% of the card's peak; SASS {sass}; "
        f"plan {t['plan']}")
    if sass["HMMA"] == 0:
        raise RuntimeError("ssd_scan's library holds no HMMA: the bf16 body is not on "
                           "the tensor cores")
    return t


# -------------------------------------------------------------- the MoE ----

def routing_of(calls):
    """A `moe.observe` callback that appends each dispatch's router probabilities (fp32,
    on the CPU) and expert ids to ``calls``."""
    def record(p, xt, disp):
        probs = torch.softmax(xt.float() @ p.w_router.float(), dim=-1)
        calls.append((probs.cpu(), disp.expert_ids.cpu()))
    return record


def router_flips(arch, card_calls, cpu_calls, k, between="card and CPU"):
    """Top-k picks that differ between card and CPU (or the two runs named
    by ``between``), call by call, with the
    gap between the k-th and (k+1)-th router probability of each token
    (on the CPU): a near-tie that rounding can flip shows as a small gap."""
    flipped, gaps, min_gap = 0, [], float("inf")
    for (pc, ic, *_), (_, ih, *_) in zip(card_calls, cpu_calls):
        top = torch.topk(pc, k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        min_gap = min(min_gap, float(gap.min()))
        if ic.shape != ih.shape:
            break  # the two runs no longer serve the same tokens
        diff = (ic != ih).any(dim=-1)
        flipped += int(diff.sum())
        gaps += [float(g) for g in gap[diff]]
    out = dict(calls=len(cpu_calls), flipped_tokens=flipped, gaps_at_flips=gaps,
               min_gap=min_gap)
    log(f"{arch} routing: {len(cpu_calls)} dispatches, {flipped} tokens whose "
        f"top-{k} picks differ between {between} (gaps {gaps[:20]}); the smallest gap between "
        f"the {k}-th and {k + 1}-th router probability is {min_gap:.3g}")
    return out


def check_moe_launches(sc, cfg, report, counts):
    """One `moe_gemm` launch per layer of the prefill and of every decode
    step, the batcher's ticks included."""
    want = cfg.n_layers * (1 + sc["steps"] + report[sc["key"]]["batcher_ticks"])
    if counts["moe_gemm"] != want:
        raise RuntimeError(f"moe_gemm launched {counts['moe_gemm']} times on the "
                           f"{sc['key']} path, want {want} (one per layer and step)")


def moe_drop_shares(sc, dev, cfg, model, prompts, cache, generated, report):
    """The share of dispatched picks that found their expert full, over all
    layers of one prefill and of one decode step."""
    out, runs = {}, [("prefill", []), ("decode_step", [])]

    def drops_into(entries):
        return lambda p, xt, disp: entries.append((disp.keep.numel() - disp.keep.sum(),
                                                   disp.keep.numel()))

    with moe_mod.observe(drops_into(runs[0][1])):
        make_prefill_step(model, cfg)(prompts)
    with moe_mod.observe(drops_into(runs[1][1])):
        make_serve_step(model, cfg)(cache, generated[:, -1:], sc["prompt"] + sc["steps"] - 1)
    for label, entries in runs:
        dropped = [int(d) for d, _ in entries]
        picks = sum(n for _, n in entries)
        out[label] = dict(dropped=sum(dropped), picks=picks, share=sum(dropped) / picks,
                          max_layer_share=max(dropped) / entries[0][1])
        log(f"{cfg.name} {label}: {sum(dropped)} of {picks} dispatched picks dropped "
            f"({100 * sum(dropped) / picks:.4f}%; at most {100 * max(dropped) / entries[0][1]:.4f}% "
            f"in one layer)")
    report[sc["key"]]["drops"] = out


MOE_FP32_REL = 1e-4


def moe_tol(want):
    """fp32: rtol 1e-4 and 1e-4 of the largest |y| (sums in another order).
    bf16: as the attention checks (rtol 2e-2, an atol of 5% of the mean
    |y|): both sides round h and y to bf16 from fp32 sums, and a sum on
    the other side of a rounding boundary moves a value by one bf16 ulp."""
    if want.dtype == torch.float32:
        return dict(rtol=MOE_FP32_REL, atol=MOE_FP32_REL * float(want.abs().max()))
    return dict(rtol=BF16_TOL["rtol"],
                atol=FULL_WIDTH_BF16_ATOL_SHARE * float(want.float().abs().mean()))


def layer0_moe_vs_plain(sc, dev, cfg, model, prompts, report, errs):
    """Layer 0's MoE at full width on the prefill's tokens: one dispatch
    for the kernel and one for the plain version on the same card tensors
    (the routing must be equal), the expert GEMM through each, and the
    combined outputs; in fp32 and in bf16.  Returns the bf16 arguments of
    the GEMM, for timing at the path's own counts."""
    blk = model.blocks[0]
    x = model.embed_tokens(prompts)
    B, S, d = x.shape
    x = x + attention(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                      torch.arange(S, device=dev).expand(B, S))
    xt = rms_norm(x, blk.ln2, cfg.norm_eps).reshape(B * S, d)
    del x
    checks, timing_args = {}, None
    for dt in (torch.float32, torch.bfloat16):  # bf16 last: its dispatch is timed
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        p = SimpleNamespace(**{k: v.to(dt) if v.dtype == torch.bfloat16 else v
                               for k, v in blk.moe.items()})
        dk = moe_mod.dispatch(p, cfg, xt.to(dt))
        dp = moe_mod.dispatch(p, cfg, xt.to(dt))
        for field in ("expert_ids", "keep", "slot", "counts", "grouped"):
            if not torch.equal(getattr(dk, field), getattr(dp, field)):
                raise RuntimeError(f"layer-0 MoE {tag}: two dispatches of the same tokens "
                                   f"differ in {field}")
        yk = mg_ops.moe_gemm(dk.grouped, p.w_gate, p.w_up, p.w_down, dk.counts)
        yp = moe_gemm_ref(dp.grouped, p.w_gate, p.w_up, p.w_down, dp.counts)
        tol = moe_tol(yp)
        err = check_close(f"layer-0 moe_gemm {tag}", yk, yp, tol, errs)
        ok, op = moe_mod.combine(yk, dk), moe_mod.combine(yp, dp)
        tol_out = moe_tol(op)
        err_out = check_close(f"layer-0 MoE output {tag}", ok, op, tol_out, [])
        C = dk.grouped.shape[1]
        checks[tag] = dict(max_abs_err=err, max_abs_y=float(yp.float().abs().max()),
                           mean_abs_y=float(yp.float().abs().mean()), **tol,
                           out_max_abs_err=err_out, out_tol=tol_out)
        log(f"layer-0 MoE {tag} [moe_gemm: {body('moe_gemm', dt)}], full width ({B * S} "
            f"tokens, C {C}): max |kernel - plain| "
            f"y {err:.3g} (max |y| {checks[tag]['max_abs_y']:.3g}, within atol "
            f"{tol['atol']:.3g} rtol {tol['rtol']:.3g}), combined output {err_out:.3g}")
        if dt == torch.bfloat16:
            timing_args = (dk.grouped, p.w_gate, p.w_up, p.w_down, dk.counts)
        del dk, dp, yk, yp, ok, op
        torch.cuda.empty_cache()
    counts = timing_args[-1]
    report["layer0_moe"] = dict(tokens=B * S, capacity=C, checks=checks,
                                live_rows=int(counts.clamp(0, C).sum()),
                                counts_min=int(counts.min()), counts_max=int(counts.max()))
    return timing_args


MG_SHAPES = [  # (E, C, d, f): tests/test_kernels.py:301-307, then granite's experts
    (4, 64, 32, 16), (8, 96, 64, 32), (2, 50, 32, 64), (32, 40, 64, 32),
    (3, 130, 24, 40),      # C over two 128-row tiles; d and f ragged against 64-wide boxes
    (32, 640, 1024, 512),
    (32, 10, 1024, 512),   # a decode step at batch 32
    (32, 8, 1024, 512)]    # a batcher tick over 16 slots


def moe_draw(gen, shape, dtype, dev, junk):
    """x (rows past the counts zero, or random: ``junk``), weights scaled by
    1/sqrt(fan-in) so that g, u and y are O(1), and counts in [0, C] with
    0, C and C + 7 among them."""
    E, C, d, f = shape
    x = torch.randn((E, C, d), generator=gen, device=dev)
    w = [torch.randn(s, generator=gen, device=dev) * s[1] ** -0.5
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    counts = torch.randint(0, C + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    n = min(3, E)
    counts[:n] = torch.tensor([0, C, C + 7][:n], dtype=torch.int32, device=dev)
    if not junk:
        x = x * (torch.arange(C, device=dev)[None, :] < counts[:, None])[..., None]
    return [t.to(dtype) for t in [x] + w] + [counts]


def moe_kernel_checks(dev, report, errs):
    """The kernel against its plain version over the test shapes and
    granite's width, fp32 and bf16, with the buffer zero past the counts
    and with random rows there (the kernel must mask them).  Cases where
    the two differ at all are listed in the report."""
    gen = torch.Generator(device=dev).manual_seed(22)
    n, differ = 0, []
    for shape in MG_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for junk in (False, True):
                args = moe_draw(gen, shape, dt, dev, junk)
                want = moe_gemm_ref(*args)
                got = mg_ops.moe_gemm(*args)
                label = f"moe_gemm {dt} {shape} {'junk' if junk else 'zeroed'} past the counts"
                err = check_close(label, got, want, moe_tol(want), errs)
                if err:
                    differ.append(dict(case=label, max_abs_err=err,
                                       max_abs_y=float(want.float().abs().max())))
                dead = torch.arange(shape[1], device=dev)[None, :] >= args[-1][:, None]
                if bool(got[dead].any()):
                    raise RuntimeError(f"{label}: rows past the counts are not 0")
                n += 1
    report["moe_kernel_checks"] = dict(cases=n, differ=differ)
    log(f"moe_gemm: differs from plain in {differ}")
    log(f"moe_gemm ({body('moe_gemm', torch.bfloat16)} and "
        f"{body('moe_gemm', torch.float32)}): {n} small and granite-width cases "
        f"(prefill-like, decode and batcher capacities) within tolerance of plain "
        f"(fp32 rtol {MOE_FP32_REL} and {MOE_FP32_REL} of max |y|; bf16 rtol "
        f"{BF16_TOL['rtol']} and {FULL_WIDTH_BF16_ATOL_SHARE} of mean |y|)")


def moe_timing(dev, name, report, x, wg, wu, wd, counts):
    """`moe_gemm` at the prefill's shape with layer 0's own counts, and at a
    decode step's (32 tokens routed top-8 uniformly: C 10, the bench's
    inputs): kernel and plain version by CUDA events, beside the bound and
    a library yardstick (three bf16 bmm over the whole buffer and the silu
    product: no single PyTorch call computes this function); and the
    host's time to enqueue one decode-step call (the decode path is
    host-bound)."""
    flops, hbm = bf16_peak_flops(name), hbm_peak_bytes_per_s(name)
    out = {}
    for label, args in (("prefill", (x, wg, wu, wd, counts)),
                        ("decode_step", mg_bench.inputs(32, dev))):
        xa, ga, ua, da, ca = args
        E, C, d = xa.shape
        f = ga.shape[-1]
        rows = int(ca.clamp(0, C).sum())
        ms = event_times(dev, lambda i=0: mg_ops.moe_gemm(*args))
        plain = event_times(dev, lambda i=0: moe_gemm_ref(*args))
        lib = event_times(dev, lambda i=0: torch.bmm(
            F.silu(torch.bmm(xa, ga)) * torch.bmm(xa, ua), da))
        ops_ = 2 * 3 * d * f * rows
        bytes_ = xa.element_size() * (rows * d + E * C * d + 3 * E * d * f)
        bound = max(ops_ / flops, bytes_ / hbm) * 1e3
        t = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                 bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
                 library="3 x torch.bmm (bf16, whole buffer, no skipping) + silu product",
                 operations=ops_, bytes=bytes_, shape=[E, C, d, f], live_rows=rows,
                 tflops=ops_ / ms / 1e9, body=body("moe_gemm", xa.dtype))
        if label == "decode_step":
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(200):
                mg_ops.moe_gemm(*args)
            t["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
            sync(dev)
        out[label] = t
        log(f"moe_gemm {label} {t['shape']} ({rows} live rows) [{t['body']}]: {ms:.4f} ms "
            f"(plain {plain:.4f} ms; yardstick 3 x bmm {lib:.4f} ms), {t['tflops']:.2f} "
            f"TFLOP/s; bound {bound:.4f} ms by {t['bound_by']} = {100 * bound / ms:.2f}% of "
            f"the card's peak" + (f"; host {t['host_us_per_call']:.1f} us a call"
                                  if "host_us_per_call" in t else ""))
        del args, xa, ga, ua, da, ca
    report["moe_timing"] = out
    return out["prefill"]


MM_SHAPES = [  # (M, N, K): tests/test_kernels.py:78-80
    (256, 128, 256), (512, 256, 512), (128, 128, 128),
    (384, 256, 128),  # a 3 x 2 grid: clamped curve cells
    (256, 96, 200)]   # the padding path
MM_TEST_BLOCKS = (128, 128, 64)  # tests/test_kernels.py:90


def morton_path(shapes, dev, report):
    """The public `morton_matmul` in bf16 at its default blocks, in each
    order, on each shape: the orders' outputs must be bit-identical and
    finite.  Returns the launches it made."""
    runs = []
    for M, N, K in shapes:
        a, b = mm_bench.inputs(M, N, K, torch.bfloat16, dev)
        t0 = time.perf_counter()
        outs = [mm_ops.morton_matmul(a, b, order=o) for o in mm_ops.ORDERS]
        sync(dev)
        wall = time.perf_counter() - t0
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"morton_matmul {(M, N, K)}: the orders' outputs differ")
        if tuple(outs[0].shape) != (M, N) or not bool(torch.isfinite(outs[0]).all()):
            raise RuntimeError(f"morton_matmul {(M, N, K)}: output not finite or misshapen")
        runs.append(dict(shape=[M, N, K], orders=list(mm_ops.ORDERS), wall_s=wall))
        log(f"morton_matmul path {M} x {N} x {K} bf16 [{body('morton_matmul', torch.bfloat16)}], "
            f"default blocks, "
            f"{len(mm_ops.ORDERS)} orders: bit-identical, finite, {wall:.3f} s")
        del a, b, outs
    report["morton_matmul"] = dict(path=runs)


def morton_kernel_checks(dev, report, errs):
    """The kernel against its plain version over the JAX test's shapes and
    the study's, fp32 and bf16, each order, with a traced call per order
    (`mm_bench.check_orders`: bit-identical orders, every tile once)."""
    cases = []
    for shapes, blocks_list in ((MM_SHAPES, [MM_TEST_BLOCKS]),
                                (MM_FULL, mm_bench.BLOCKS)):
        for M, N, K in shapes:
            for dt in (torch.float32, torch.bfloat16):
                a, b = mm_bench.inputs(M, N, K, dt, dev)
                want = morton_matmul_ref(a, b)
                for blocks in blocks_list:
                    c = mm_bench.check_orders(a, b, blocks, want)
                    errs.append(c["max_abs_err"])
                    cases.append(dict(shape=[M, N, K], dtype=str(dt), blocks=list(blocks),
                                      body=body("morton_matmul", dt),
                                      max_abs_err=c["max_abs_err"],
                                      max_rel_err=c["max_rel_err"], tol=c["tol"],
                                      tiles=c["traces"]["morton"]["tiles"],
                                      max_start_lag={o: t["max_start_lag"]
                                                     for o, t in c["traces"].items()}))
                del a, b, want
    report["morton_matmul"]["checks"] = cases
    worst = max(cases, key=lambda c: c["max_rel_err"] / c["tol"])
    log(f"morton_matmul ({body('morton_matmul', torch.bfloat16)} and "
        f"{body('morton_matmul', torch.float32)}): {len(cases)} cases x "
        f"{len(mm_ops.ORDERS)} orders within tolerance "
        f"of plain (|got - want| / (|want| + 1): 3e-2 bf16, 1e-4 fp32 at K <= 512 and "
        f"1e-4 K / 512 past it; worst {worst}), the orders bit-identical, every tile "
        f"computed once by the block tile_order gives it")


def morton_timing(dev, name, report):
    """The 8192^3 bf16 product per order at both block sizes, in turns, by
    CUDA events (median of 25), beside the bound, the plain version and
    `torch.matmul` in bf16 (a yardstick, never called by the port)."""
    M, N, K = MM_FULL[0]
    a, b = mm_bench.inputs(M, N, K, torch.bfloat16, dev)
    times = {}
    for blocks in reversed(mm_bench.BLOCKS):  # the default blocks first
        bm, bn, bk = blocks
        per = {o: [] for o in mm_ops.ORDERS}
        for order in mm_bench.TURNS:
            per[order].append(event_times(dev, lambda i=0: mm_ops.morton_matmul(
                a, b, block_m=bm, block_n=bn, block_k=bk, order=order)))
        times["x".join(map(str, blocks))] = per
    plain = event_times(dev, lambda i=0: morton_matmul_ref(a, b))
    lib = event_times(dev, lambda i=0: torch.matmul(a, b))
    ops_ = 2 * M * N * K
    bytes_ = a.element_size() * (M * K + K * N + M * N)
    flops, hbm = bf16_peak_flops(name), hbm_peak_bytes_per_s(name)
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    ms = times["256x256x256"]["morton"][0]
    t = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
             bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
             library="torch.matmul (bf16)", body=body("morton_matmul", torch.bfloat16),
             operations=ops_, bytes=bytes_,
             shape=[M, N, K], orders_ms=times, tflops=ops_ / ms / 1e9)
    report["morton_matmul"]["timing"] = t
    for blk, per in times.items():
        log(f"morton_matmul {M}^3 bf16 blocks {blk}: " + "; ".join(
            f"{o} {' / '.join(f'{x:.4f}' for x in v)} ms" for o, v in per.items()))
    log(f"morton_matmul {M}^3 bf16 [{body('morton_matmul', torch.bfloat16)}] (morton, "
        f"default blocks): {ms:.4f} ms, "
        f"{t['tflops']:.2f} TFLOP/s (plain {plain:.4f} ms; torch.matmul {lib:.4f} ms); "
        f"bound {bound:.4f} ms by {t['bound_by']} = {100 * bound / ms:.2f}% of the card's peak")
    return t


# --------------------------------------------------- the dense family ----

def dense_family_path(sc, dev, report):
    """gemma-2b or minitron-8b at full width: weights drawn on the card
    (timed), a warm-up, then the counted run: 32 prompts of 2,048 through
    `make_prefill_step` (cache 2,176) and 32 greedy steps.  Returns what
    the checks need; the caller reads the launch counts."""
    t0 = time.perf_counter()
    cfg, model = serving_model(sc, dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    serving_path(sc | dict(batch=2, prompt=64, steps=2), dev, cfg, model, {})  # warm-up
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(sc, dev, cfg, model, report)
    report[sc["key"]].update(init_s=t_init, params=count_params(model.specs()))
    log(f"{cfg.name}: {count_params(model.specs())} parameters drawn on the device in "
        f"{t_init:.3f} s")
    return cfg, model, prompts, generated, cache


def check_dense_launches(sc, cfg, counts):
    """One `flash_attention` launch a layer for the prefill, one
    `flash_decode` a layer and step."""
    want = dict(flash_attention=cfg.n_layers, flash_decode=cfg.n_layers * sc["steps"])
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"{cfg.name}: launches {counts}, want {want}")


# -------------------------------------------------------------- training ----

@contextlib.contextmanager
def plain_kernels():
    """The model's attention, expert GEMM and SSD scan through their plain
    versions (the reference route of the gradient checks), differentiated
    by autograd."""
    kernel_route = attn_mod.flash_attention, moe_mod.moe_gemm, ssd_ops.ssd_scan

    def plain(q, k, v, *, causal=True, scale=None, window=None):
        return flash_attention_ref(q, k, v, causal=causal,
                                   scale=q.shape[-1] ** -0.5 if scale is None else scale,
                                   window=window)

    attn_mod.flash_attention, moe_mod.moe_gemm, ssd_ops.ssd_scan = (
        plain, moe_gemm_ref, ssd_scan_ref)
    try:
        yield
    finally:
        attn_mod.flash_attention, moe_mod.moe_gemm, ssd_ops.ssd_scan = kernel_route


@contextlib.contextmanager
def routing(calls, replay=None):
    """Within the block each MoE dispatch appends its own top-k picks to
    ``calls`` as (router probabilities, ids sorted, ids as picked), the
    first two on the CPU for `router_flips`; with ``replay`` (another
    run's ``calls``) it then routes as that run did, taking that run's
    picks at its own probabilities (`models.moe.top_k`)."""
    own = moe_mod.top_k
    theirs = None if replay is None else iter(replay)

    def top_k(probs, k):
        gates, ids = own(probs, k)
        calls.append((probs.detach().cpu(), ids.sort(dim=-1).values.cpu(), ids))
        if theirs is not None:
            ids = next(theirs)[2]
            gates = probs.gather(-1, ids)
        return gates, ids

    moe_mod.top_k = top_k
    try:
        yield
    finally:
        moe_mod.top_k = own


def training_state(tc, dev):
    """The driver's state and data: `launch.train.build_state` and its
    synthetic corpus in the Morton token store on the device."""
    cfg = get_smoke_config(tc["arch"]) if tc["smoke"] else get_config(tc["arch"])
    (model, opt), t_init = timed(dev, lambda: train_mod.build_state(cfg, seed=0, device=dev))
    store, t_corpus = timed(dev, lambda: train_mod.synthetic_corpus(
        cfg, doc_len=tc["seq_len"] + 1 + 64, device=dev))
    pipe = DataPipeline(store, PipelineConfig(seq_len=tc["seq_len"],
                                              global_batch=tc["batch"]))
    log(f"{cfg.name} training state: {count_params(model.specs())} parameters in "
        f"{t_init:.3f} s, corpus of {store.n_docs} x {store.doc_len} tokens in "
        f"{t_corpus:.3f} s")
    return cfg, model, opt, pipe


def training_batches_vs_cpu(tc, cfg, pipe, report):
    """The pipeline's batches at the path's own shapes (rows of seq_len + 1
    tokens out of the store's cuboids: on the card through `cutout_gather`)
    against the same corpus in a CPU token store, read by the plain
    gather: bit for bit, at the first and the last step of the counted
    run."""
    cpu = DataPipeline(train_mod.synthetic_corpus(cfg, doc_len=pipe.store.doc_len,
                                                  device="cpu"), pipe.cfg)
    steps = (0, tc["steps"] - 1)
    for s in steps:
        got, want = pipe.get_batch(s), cpu.get_batch(s)
        for k in ("tokens", "labels"):
            if not torch.equal(got[k].cpu(), want[k]):
                n = int((got[k].cpu() != want[k]).sum())
                raise RuntimeError(f"training batch {s}: {k} differ from the plain gather's "
                                   f"in {n} of {want[k].numel()} places")
    report[f"{tc['key']}_batches_vs_cpu"] = dict(steps=list(steps),
                                                 shape=list(want["tokens"].shape),
                                                 cuboid=list(pipe.store.spec.base_cuboid))
    log(f"{cfg.name} training batches {list(steps)} ({tuple(want['tokens'].shape)} tokens "
        f"out of a {pipe.store.n_docs} x {pipe.store.doc_len} store in "
        f"{tuple(pipe.store.spec.base_cuboid)} cuboids): equal to the plain gather's bit "
        f"for bit")


def opt_config(tc, **kw):
    return AdamWConfig(lr_peak=tc["lr"], warmup_steps=5, total_steps=tc["steps"], **kw)


# The gradient check's tolerances.  fp32: phase 6's (atol and rtol 2e-5,
# element by element) for the dense family; for the MoE and ssm families
# rtol 1e-4 and 1e-4 of the leaf's max |g|, the fp32 tolerance of their
# kernels' own checks (MOE_FP32_REL, SSD_REL: the expert sums and the
# scan's cumsum round in another order than the plain versions').  bf16:
# the CPU tests' bf16 gradient tolerance, 2e-2
# of the leaf's max |g| (tests/test_torch_train.py), and 2e-2 in norm; the
# kernel route no farther from the fp32 gradients than 1.25 x the plain
# route's distance; and at most 1% of a leaf's elements outside phase 6's
# bf16 tolerance taken element by element (rtol 2e-2 and 5% of the leaf's
# mean |g|).  That tolerance does not hold for every element of gradients
# after 30 bf16 layers: in two runs on the H100 0.38-0.44% of the elements
# of w_q, w_k and embed fell outside it (and none of the other leaves'),
# with the kernel route 7e-3 from the plain one in norm and each route
# ~1e-2 from the fp32 gradients.  The 1% limit fails a fault confined to
# a few tiles, which the norms would not see.
# The MoE family is held to the same bf16 criteria.  The ssm family's bf16
# check holds the kernel route to the plain route by their distances from
# the fp32 gradients: in norm, and in the share of elements outside phase
# 6's tolerance, the kernel route no farther than 1.25 x the plain route
# (or 1% of the elements, the dense family's limit, where the plain
# route's share is below that).  Its bf16 gradients are as far from each
# other as each is from the fp32 ones: in the first full-width run of
# mamba2-370m on the H100 every leaf's two bf16 routes were 1.3-4.0% apart
# in norm, with 2-8% of the elements outside phase 6's tolerance of each
# other, and each route 3-8% from the fp32 gradients (blocks/ln: kernel
# 7.77%, plain 7.71%), which the two fp32 routes matched to 2.3e-5.  A hole
# or a fault in a few tiles moves the kernel route away from the fp32
# gradients and not the plain route.
GRAD_FP32_TOL = FP32_TOL
GRAD_FP32_REL = 1e-4  # the MoE and ssm families
GRAD_BF16_SHARE = 2e-2
GRAD_BF16_VS_FP32 = 1.25
GRAD_BF16_PHASE6_OUTSIDE = 1e-2
# the leaves that reach the loss only, or in part, through a family's kernels:
# each must get a nonzero gradient through the kernel route
KERNEL_LEAVES = {
    "dense": ("blocks/attn/w_q", "blocks/attn/w_k", "blocks/attn/w_v"),
    "moe": ("blocks/attn/w_q", "blocks/attn/w_k", "blocks/attn/w_v", "blocks/moe/w_gate",
            "blocks/moe/w_up", "blocks/moe/w_down", "blocks/moe/w_router"),
    "ssm": ("blocks/ssm/w_dt", "blocks/ssm/dt_bias", "blocks/ssm/A_log",
            "blocks/ssm/w_xBC", "blocks/ssm/conv_w")}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bf16_holds(family, r):
    """The bf16 criteria above for one leaf's row of `training_grad_check`."""
    nearer = r["bf16_kernel_vs_fp32"] <= GRAD_BF16_VS_FP32 * r["bf16_plain_vs_fp32"]
    if family in ("dense", "moe"):
        return (nearer and r["bf16_max_abs_err"] <= GRAD_BF16_SHARE * r["bf16_max_abs"]
                and r["bf16_rel_norm"] <= GRAD_BF16_SHARE
                and r["bf16_phase6_outside"] <= GRAD_BF16_PHASE6_OUTSIDE)
    return nearer and r["bf16_kernel_outside_fp32"] <= max(
        GRAD_BF16_VS_FP32 * r["bf16_plain_outside_fp32"], GRAD_BF16_PHASE6_OUTSIDE)


def training_grad_check(tc, dev, cfg, model, pipe, report):
    """Every parameter's gradient through the kernel route against the same
    weights with attention, expert GEMM and scan through their plain
    versions (`plain_kernels`), on the first batch's first ``check_seqs``
    sequences: in the model's bf16 and with the weights taken to fp32, at
    the tolerances above; finite, and the kernels' leaves
    (`KERNEL_LEAVES`) nonzero through the kernel route.  A MoE's plain
    route takes the kernel route's top-k picks (`routing`): where the k-th
    and (k+1)-th router probabilities nearly tie, the two routes' rounding
    can pick different experts for a token (a flip), and that token's
    gradient would then go to other experts' weights; the flips the plain
    route would have made are counted and reported (`router_flips`), and
    the gradients are compared under one routing."""
    batch = {k: v[:tc["check_seqs"]] for k, v in pipe.get_batch(0).items()}
    cfg32 = cfg.scaled(dtype="float32")
    model32 = build_model(cfg32, tree_map(lambda t: t.detach().float(), model.param_tree()),
                          device=dev)
    paths = _paths(model.param_tree())
    grads, losses, flips = {}, {}, {}
    for tag, m, c in (("bf16", model, cfg), ("fp32", model32, cfg32)):
        m.requires_grad_(True)
        calls = {}
        for route in ("kernel", "plain"):
            calls[route] = []
            with (plain_kernels() if route == "plain" else contextlib.nullcontext()), \
                    routing(calls[route], calls["kernel"] if route == "plain" else None):
                loss, _, g = loss_and_grads(m, batch, c)
            grads[route, tag] = list(tree_leaves(g))  # bf16 leaves kept in bf16
            losses[f"{route}_{tag}"] = float(loss)
            del g
        if cfg.family == "moe":
            flips[tag] = router_flips(f"{cfg.name} gradient check ({tag})", calls["kernel"],
                                      calls["plain"], cfg.top_k,
                                      between="the kernel route and the plain route")
        del calls
        for name in KERNEL_LEAVES[cfg.family]:
            g = grads["kernel", tag][paths.index(name)]
            if not bool((g != 0).any()):
                raise RuntimeError(f"gradient of {name} ({tag}) is zero through the kernel "
                                   f"route")
    del model32
    fp32_tol = (lambda pf: GRAD_FP32_TOL) if cfg.family == "dense" else (
        lambda pf: dict(rtol=GRAD_FP32_REL, atol=GRAD_FP32_REL * float(pf.abs().max())))
    rows, failed = {}, []
    for i, path in enumerate(paths):
        kb, pb, kf, pf = (grads[k][i].float() for k in (
            ("kernel", "bf16"), ("plain", "bf16"), ("kernel", "fp32"), ("plain", "fp32")))
        if not (bool(torch.isfinite(kb).all()) and bool(torch.isfinite(kf).all())):
            raise RuntimeError(f"gradient {path}: non-finite through the kernel route")
        phase6 = 2e-2 * pb.abs() + FULL_WIDTH_BF16_ATOL_SHARE * pb.abs().mean()
        phase6_fp32 = 2e-2 * pf.abs() + FULL_WIDTH_BF16_ATOL_SHARE * pf.abs().mean()
        r = dict(bf16_max_abs_err=float((kb - pb).abs().max()),
                 bf16_max_abs=float(pb.abs().max()), bf16_rel_norm=_rel(kb, pb),
                 bf16_kernel_vs_fp32=_rel(kb, pf), bf16_plain_vs_fp32=_rel(pb, pf),
                 bf16_phase6_outside=float(((kb - pb).abs() > phase6).float().mean()),
                 bf16_kernel_outside_fp32=float(((kb - pf).abs() > phase6_fp32).float().mean()),
                 bf16_plain_outside_fp32=float(((pb - pf).abs() > phase6_fp32).float().mean()),
                 fp32_max_abs_err=float((kf - pf).abs().max()),
                 fp32_max_abs=float(pf.abs().max()), fp32_rel_norm=_rel(kf, pf))
        rows[path] = r
        try:
            torch.testing.assert_close(kf, pf, **fp32_tol(pf))
        except AssertionError as e:
            failed.append(f"gradient {path} (fp32): kernel route != plain route\n{e}")
        if not bf16_holds(cfg.family, r):
            failed.append(f"gradient {path} (bf16): kernel route != plain route: {r}")
    report[f"{tc['key']}_grad_check"] = dict(seqs=tc["check_seqs"], losses=losses,
                                             leaves=rows, router_flips=flips)
    worst = max(rows.values(), key=lambda r: r["bf16_rel_norm"])
    fp32_desc = (f"atol and rtol {GRAD_FP32_TOL['rtol']}" if cfg.family == "dense"
                 else f"rtol {GRAD_FP32_REL} and {GRAD_FP32_REL} of max |g|")
    if cfg.family in ("dense", "moe"):
        bf16_desc = (f"within {GRAD_BF16_SHARE} of max |g| and in norm (largest "
                     f"{worst['bf16_rel_norm']:.3g}), no farther from the fp32 gradients than "
                     f"{GRAD_BF16_VS_FP32} x the plain route, at most "
                     f"{GRAD_BF16_PHASE6_OUTSIDE} of the elements outside phase 6's tolerance "
                     f"(largest {max(r['bf16_phase6_outside'] for r in rows.values()):.3g})")
    else:
        bf16_desc = (f"no farther from the fp32 gradients than {GRAD_BF16_VS_FP32} x the "
                     f"plain route, in norm and in the share of elements outside phase 6's "
                     f"tolerance (or {GRAD_BF16_PHASE6_OUTSIDE} of them)")
    log(f"{cfg.name} gradients ({tc['check_seqs']} x {tc['seq_len']} tokens), kernel route "
        f"vs plain route, {len(rows)} leaves: fp32 within {fp32_desc} (largest |diff| / |g| "
        f"in norm {max(r['fp32_rel_norm'] for r in rows.values()):.3g}); bf16 {bf16_desc}; "
        f"{', '.join(n.split('/')[-1] for n in KERNEL_LEAVES[cfg.family])} nonzero; "
        f"losses {losses}")
    for path, r in rows.items():
        log(f"  {path}: bf16 |diff| / |g| {r['bf16_rel_norm']:.3g} (max {r['bf16_max_abs_err']:.3g} "
            f"of max |g| {r['bf16_max_abs']:.3g}; vs fp32: kernel {r['bf16_kernel_vs_fp32']:.3g}, "
            f"plain {r['bf16_plain_vs_fp32']:.3g}; outside phase 6's bf16 tolerance "
            f"{r['bf16_phase6_outside']:.2e}, against fp32 kernel "
            f"{r['bf16_kernel_outside_fp32']:.2e}, plain {r['bf16_plain_outside_fp32']:.2e}); "
            f"fp32 max |diff| {r['fp32_max_abs_err']:.3g} of max |g| {r['fp32_max_abs']:.3g}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _paths(tree, prefix=""):
    return [p for k in sorted(tree) for p in (
        _paths(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) else [prefix + k])]


def training_path(tc, dev, cfg, model, opt, pipe, report):
    """The counted run: ``steps`` train steps through `make_train_step`, each
    batch from the pipeline (its rows through `cutout`).  The loss must fall
    from the first step to the last, and every step's gradient norm (so
    every gradient) must be finite."""
    step_fn = make_train_step(model, cfg, opt_config(tc), n_microbatches=tc["microbatches"])
    losses, norms, times = [], [], []
    for s in range(tc["steps"]):
        t0 = time.perf_counter()
        opt, m = step_fn(opt, pipe.get_batch(s))
        losses.append(float(m["loss"]))  # waits for the step
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{cfg.name} training: the loss did not fall: {losses}")
    if not all(np.isfinite(norms)):
        raise RuntimeError(f"{cfg.name} training: a gradient was not finite (grad norms "
                           f"{norms})")
    tokens = tc["batch"] * tc["seq_len"]
    step_s = statistics.median(times[tc["warm"]:])
    report[tc["key"]] = dict(arch=cfg.name, seq_len=tc["seq_len"], batch=tc["batch"],
                             microbatches=tc["microbatches"], steps=tc["steps"], lr=tc["lr"],
                             losses=losses, grad_norms=norms, step_s=times,
                             median_step_s=step_s, tokens_per_s=tokens / step_s)
    log(f"{cfg.name} training ({tc['steps']} steps of {tc['batch']} x {tc['seq_len']} "
        f"tokens in {tc['microbatches']} microbatches, lr {tc['lr']}): loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; median step {step_s:.4f} s after {tc['warm']} warm steps, "
        f"{tokens / step_s:.6g} tokens/s; every grad norm finite")
    log(f"  losses {[round(x, 4) for x in losses]}")
    return opt


# the kernels a family's training forward launches, once per layer and
# microbatch (the backward recomputes through their plain versions)
TRAIN_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention", "moe_gemm"),
                 "ssm": ("ssd_scan",)}


def check_training_launches(tc, cfg, counts):
    """Each of the family's kernels exactly once per layer, microbatch and
    step; `cutout_gather` at least once a step (the pipeline's rows)."""
    want = cfg.n_layers * tc["microbatches"] * tc["steps"]
    bad = {k: counts[k] for k in TRAIN_KERNELS[cfg.family] if counts[k] != want}
    if bad or counts["cutout_gather"] < tc["steps"]:
        raise RuntimeError(f"{cfg.name} training launches {counts}: want "
                           f"{' and '.join(TRAIN_KERNELS[cfg.family])} {want} each (layers x "
                           f"microbatches x steps) and cutout_gather >= {tc['steps']}")


def train_flops(cfg, seq_len, seqs):
    """Model FLOPs of one training step, the forward's and twice that in
    the backward (the backward's recomputes of the forward not counted):
    - 6 x the parameters a token uses x tokens: the tied embedding counted
      once, as the head's product; of a MoE's experts only the top k;
    - causal attention's products, 12 x layers x B x H x D x S(S+1)/2 (QK^T
      and PV);
    - the ssm's SSD products as the chunked scan forms them, the
      intra-chunk ones causal like attention's: 6 x layers x B x (S(Q+1)/2
      x (N + H P) for C.B^T and its product with x dt, plus 2 S H P N for
      the chunk states and the carried state's share), Q the chunk.
    Returns {"dense", "attention", "ssd"}."""
    params = count_params(lm_specs(cfg))
    if cfg.family == "moe":
        experts = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
        params -= experts - experts * cfg.top_k // cfg.n_experts
    out = dict(dense=6 * params * seq_len * seqs, attention=0, ssd=0)
    if cfg.family in ("dense", "moe"):
        out["attention"] = (12 * cfg.n_layers * seqs * cfg.n_heads * cfg.head_dim
                            * seq_len * (seq_len + 1) // 2)
    if cfg.family == "ssm":
        Q, N = min(cfg.ssm_chunk, seq_len), cfg.ssm_state
        HP = cfg.ssm_heads * cfg.ssm_head_dim
        out["ssd"] = 6 * cfg.n_layers * seqs * (seq_len * (Q + 1) // 2 * (N + HP)
                                                + 2 * seq_len * HP * N)
    return out


TRAIN_RANGES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


def training_profile(tc, dev, cfg, model, opt, pipe, name, report, first=100):
    """Two train steps under the profiler (after two warm ones): the
    device's idle share of the steps' wall time, and a step's split into
    forward, backward (of it each kernel's recompute through its plain
    version) and optimizer, the device time launched inside
    `make_train_step`'s and the Functions' profiler ranges (a step's mean).
    Then the model FLOPs over the median step of the counted run as a share
    of the card's bf16 peak."""
    step_fn = make_train_step(model, cfg, opt_config(tc), n_microbatches=tc["microbatches"])
    steps = iter(range(first, first + 4))
    recomputes = [f"{k}.recompute" for k in TRAIN_KERNELS[cfg.family]]

    def two_steps():
        st = opt
        for _ in range(2):
            st, m = step_fn(st, pipe.get_batch(next(steps)))
        return float(m["loss"])

    _, prof = profile_window(dev, two_steps, TRAIN_RANGES + tuple(recomputes))
    report[tc["key"]]["profile"] = prof
    log_profile(f"{cfg.name}: 2 train steps", prof)
    r = prof["ranges"]
    split = dict(forward_ms=r["train_step.forward"]["ms"] / 2,
                 backward_ms=r["train_step.backward"]["ms"] / 2,
                 optimizer_ms=r["train_step.optimizer"]["ms"] / 2,
                 recompute={n: dict(ms=r[n]["ms"] / 2, calls=r[n]["calls"] / 2)
                            for n in recomputes})
    want = cfg.n_layers * tc["microbatches"]
    parts = [split["forward_ms"], split["backward_ms"], split["optimizer_ms"]] + [
        v["ms"] for v in split["recompute"].values()]
    if any(v["calls"] != want for v in split["recompute"].values()) or min(parts) <= 0:
        raise RuntimeError(f"{cfg.name} train step split {split}: want every part's "
                           f"device time > 0 and {want} calls of each recompute a step")
    flops = train_flops(cfg, tc["seq_len"], tc["batch"])
    total = sum(flops.values())
    step_s = report[tc["key"]]["median_step_s"]
    peak = bf16_peak_flops(name)
    split.update(model_flops=total, flops=flops, model_tflops=total / step_s / 1e12,
                 bf16_peak_share=total / step_s / peak)
    report[tc["key"]]["split"] = split
    log(f"{cfg.name} train step split (device time launched in each profiler range, "
        f"a step's mean over the profiled 2): forward {split['forward_ms']:.1f} ms, "
        f"backward {split['backward_ms']:.1f} ms (of it " + ", ".join(
            f"{n} {v['ms']:.1f} ms over {v['calls']:.0f} calls"
            for n, v in split["recompute"].items()) +
        f"), optimizer {split['optimizer_ms']:.1f} ms")
    log(f"{cfg.name} model FLOPs a step {total:.4g} ({flops}; "
        f"{tc['batch'] * tc['seq_len']} tokens): {split['model_tflops']:.2f} TFLOP/s "
        f"over the median step = {100 * split['bf16_peak_share']:.2f}% of the "
        f"{peak / 1e12:.0f} TFLOP/s bf16 peak")


def training_compressed_steps(tc, dev, cfg, model, opt, pipe, report):
    """One step each with bf16 and int8 gradient compression."""
    out = {}
    for i, method in enumerate(("bf16", "int8")):
        step_fn = make_train_step(model, cfg, opt_config(tc, grad_compression=method),
                                  n_microbatches=tc["microbatches"])
        (opt, m), t = timed(dev, lambda: step_fn(opt, pipe.get_batch(300 + i)))
        out[method] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), step_s=t)
        if not np.isfinite(out[method]["loss"]):
            raise RuntimeError(f"training with {method} compression: loss not finite")
    report[tc["key"]]["compressed_steps"] = out
    log(f"{cfg.name} one step each with gradient compression: " + "; ".join(
        f"{k} loss {v['loss']:.4f}, grad norm {v['grad_norm']:.4f}, {v['step_s']:.4f} s"
        for k, v in out.items()))


def training_phase(tc, dev, name, report, by_path):
    """A family's training at full width: the batch and gradient checks,
    then the counted run with the launch counts set to 0 just before it
    and read just after, the step's profile, and (``compressed``) a step
    each with compressed gradients."""
    t0 = time.perf_counter()
    cfg, model, opt, pipe = training_state(tc, dev)
    del opt  # the checks take no step; the counted run gets the same state anew
    training_batches_vs_cpu(tc, cfg, pipe, report)
    training_grad_check(tc, dev, cfg, model, pipe, report)
    torch.cuda.empty_cache()
    opt = adamw_init(model.param_tree())
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = training_path(tc, dev, cfg, model, opt, pipe, report)
    by_path[tc["key"]] = counts = read_launches(tc["key"])
    check_training_launches(tc, cfg, counts)
    report[tc["key"]]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the {tc['key']} path: {counts} ({', '.join(TRAIN_KERNELS[cfg.family])} "
        f"= {cfg.n_layers} layers x {tc['microbatches']} microbatches x {tc['steps']} steps "
        f"each, forward only); max memory allocated "
        f"{report[tc['key']]['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    training_profile(tc, dev, cfg, model, opt, pipe, name, report)
    if tc.get("compressed"):
        training_compressed_steps(tc, dev, cfg, model, opt, pipe, report)
    pipe.stop()
    del model, opt, pipe
    torch.cuda.empty_cache()
    training_small_vs_cpu(dev, report, tc["arch"])
    report[tc["key"]]["phase_s"] = time.perf_counter() - t0
    log(f"{tc['key']} phase {report[tc['key']]['phase_s']:.1f} s")


# the 2-layer fp32 models trained on the card and the CPU; the ssm's at the
# published chunk of 256 over 256 steps with `build_state`'s init, whose
# decay overflowed exp above the chunk's diagonal before the plain scan's
# repair (`kernels/ssd_scan/ref.py` `causal_decay`)
SMALL_TRAIN = dict(smoke=True, seq_len=32, batch=4, microbatches=2, steps=5, lr=3e-3)
SMALL_TRAIN_ARCH = {"mamba2-370m": (dict(seq_len=256), dict(ssm_chunk=256))}
SMALL_TRAIN_RTOL = 1e-4  # losses and grad norms, fp32 card (kernel) vs CPU (plain)


def training_small_vs_cpu(dev, report, arch="smollm-135m"):
    """A 2-layer fp32 model at the smoke widths trains 5 steps from the
    same weights and batches on the card and on the CPU: losses and grad
    norms within rtol 1e-4, the parameters within 2 x the sum of the steps'
    lr (AdamW moves an element whose gradient is ~0 by about +-lr a step,
    whichever way its rounding falls); a MoE's routing flips between the
    two are reported."""
    run, scale = SMALL_TRAIN_ARCH.get(arch, ({}, {}))
    tc = SMALL_TRAIN | run
    cfg = get_smoke_config(arch).scaled(dtype="float32", **scale)
    cpu, _ = train_mod.build_state(cfg, seed=1, device="cpu")
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), dev)
    runs, routes = {}, {}
    for model in (card, cpu):
        d = model.device
        pipe = DataPipeline(train_mod.synthetic_corpus(cfg, doc_len=tc["seq_len"] + 65,
                                                       device=d),
                            PipelineConfig(seq_len=tc["seq_len"], global_batch=tc["batch"]))
        opt = adamw_init(model.param_tree())
        step_fn = make_train_step(model, cfg, opt_config(tc),
                                  n_microbatches=tc["microbatches"])
        runs[d.type] = rows = []
        routes[d.type] = calls = []
        with routing(calls):
            for s in range(tc["steps"]):
                batch = pipe.get_batch(s)
                opt, m = step_fn(opt, batch)
                rows.append((batch["tokens"].cpu(), float(m["loss"]), float(m["grad_norm"]),
                             float(m["lr"])))
        pipe.stop()
    flips = (router_flips(f"{arch} training", routes[dev.type], routes["cpu"], cfg.top_k)
             if cfg.family == "moe" else None)
    lrs = 0.0
    for (tk, lk, nk, _), (tp, lp, np_, lr) in zip(runs[dev.type], runs["cpu"]):
        if not torch.equal(tk, tp):
            raise RuntimeError(f"training small {arch}: card and CPU batches differ")
        for what, a, b in (("loss", lk, lp), ("grad norm", nk, np_)):
            if not (np.isfinite(a) and abs(a - b) <= SMALL_TRAIN_RTOL * abs(b)):
                raise RuntimeError(f"training small {arch}: {what} {a} on the card, "
                                   f"{b} on the CPU")
        lrs += lr
    diffs = [float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(lm_params_to_numpy(card)), tree_leaves(lm_params_to_numpy(cpu)))]
    if max(diffs) > 2 * lrs:
        raise RuntimeError(f"training small {arch}: parameters {max(diffs)} apart, "
                           f"tolerance {2 * lrs}")
    key = "training_small_vs_cpu" if arch == "smollm-135m" else f"{arch}_training_small_vs_cpu"
    report[key] = dict(
        seq_len=tc["seq_len"], scale=scale, losses=[r[1] for r in runs["cpu"]],
        card_losses=[r[1] for r in runs[dev.type]], grad_norms=[r[2] for r in runs["cpu"]],
        max_param_diff=max(diffs), param_tol=2 * lrs, router_flips=flips)
    log(f"training small {arch} (fp32, {tc['steps']} steps of {tc['batch']} x {tc['seq_len']}"
        f"{', ' + str(scale) if scale else ''}, card vs CPU): losses "
        f"{[round(r[1], 6) for r in runs[dev.type]]} vs {[round(r[1], 6) for r in runs['cpu']]} "
        f"within rtol {SMALL_TRAIN_RTOL}, grad norms too; parameters at most "
        f"{max(diffs):.3g} apart (tolerance 2 x sum of lr = {2 * lrs:.3g})")


# ------------------------------------------------ checkpoint and restart ----

RESTART_RUN = ["--smoke", "--steps", "10", "--seq-len", "64", "--batch", "4"]
RESTART_ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "mamba2-370m")


def _state_bits(tree):
    """The leaves of a train-state tree as (path, CPU tensor)."""
    return [(p, t.detach().cpu()) for p, t in zip(_paths(tree), tree_leaves(tree))]


def restart_vs_uninterrupted(dev, report, arch):
    """`launch.train.main` at the smoke widths, 10 steps with ``--ckpt-every
    5 --inject-failure-at 8`` against the same run without a failure: the
    recovery log must show the restore to step 5 and the replay of steps
    5-7, the replayed losses must equal the first run's, and the final
    parameters and optimizer state must be equal bit for bit (the largest
    difference is printed where they are not).  Then the step-10 checkpoint
    the card wrote restores on the CPU (`ckpt.restore_checkpoint`, into a
    CPU model's live tensors) bit for bit."""
    root = HERE / "build" / "smoke_ckpt" / arch
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", arch] + RESTART_RUN + (["--device", "cpu"] if dev.type == "cpu" else [])
    plain = train_mod.main(argv)
    out = train_mod.main(argv + ["--ckpt-dir", str(root), "--ckpt-every", "5",
                                 "--inject-failure-at", "8"])
    want_log = [dict(failed_step=8, worker=0, restored_to=5, lost_steps=3)]
    if out["recoveries"] != want_log:
        raise RuntimeError(f"{arch} restart: recovery log {out['recoveries']}, want {want_log}")
    if out["losses"][:8] != plain["losses"][:8] or out["losses"][8:] != plain["losses"][5:]:
        raise RuntimeError(f"{arch} restart: losses {out['losses']} against the "
                           f"uninterrupted run's {plain['losses']}")
    got, want = _state_bits(out["state"]), _state_bits(plain["state"])
    diffs = {p: float((g.double() - w.double()).abs().max()) for (p, g), (_, w) in
             zip(got, want) if not torch.equal(g, w)}
    if diffs:
        worst = max(diffs, key=diffs.get)
        raise RuntimeError(f"{arch} restart: {len(diffs)} of {len(got)} leaves differ from "
                           f"the uninterrupted run, the largest {worst} by {diffs[worst]}")
    step, tree = restore_checkpoint(str(root))
    cfg = get_smoke_config(arch)
    cpu_model, cpu_opt = train_mod.build_state(cfg, seed=1, device="cpu")
    restored = _state_bits(train_state_to_tree(
        cpu_model, train_state_from_tree(tree, cpu_model, cpu_opt)))
    if step != 10 or any(not torch.equal(r, g) for (_, r), (_, g) in zip(restored, got)):
        raise RuntimeError(f"{arch} restart: the step-{step} checkpoint does not restore on "
                           f"the CPU to the card's final state")
    shutil.rmtree(root, ignore_errors=True)
    report.setdefault("restart", {})[arch] = dict(
        recoveries=out["recoveries"], losses=out["losses"], leaves=len(got),
        bit_equal=True, restored_step=step)
    log(f"{arch} restart on {dev.type}: recovered {out['recoveries']}; replayed losses equal; "
        f"final parameters and optimizer state ({len(got)} leaves) bit-equal to the "
        f"uninterrupted run; the step-{step} checkpoint restores on the CPU bit for bit")


def rehearse():
    """Every path at a tiny size on the CPU: control flow only, no kernels,
    no timing claims and no result line.  One intra-op thread: at these
    sizes more threads add only their overhead, and beside other busy
    processes on the same cores they stall the run many times over."""
    torch.set_num_threads(1)
    dev = torch.device("cpu")
    report = {}
    spec, store, proj = main_path(TINY, dev, report)
    check_results(TINY, dev, spec, store, proj, report)
    for sc in (SERVE_TINY, SSM_TINY, MOE_TINY):
        cfg, model = serving_model(sc, dev)
        serving_path(sc, dev, cfg, model, report)
    morton_path(MM_TINY, dev, report)
    for sc in DENSE_TINY:
        dense_family_path(sc, dev, report)
    for tc in TRAINS_TINY:
        cfg, model, opt, pipe = training_state(tc, dev)
        training_batches_vs_cpu(tc, cfg, pipe, report)
        training_grad_check(tc, dev, cfg, model, pipe, report)
        training_path(tc, dev, cfg, model, opt, pipe, report)
        pipe.stop()
        training_small_vs_cpu(dev, report, tc["arch"])
    for arch in RESTART_ARCHS:
        restart_vs_uninterrupted(dev, report, arch)
    log(json.dumps({"rehearsal": report}, default=str))
    return 0


def reset_launches():
    for k in KERNELS.values():
        k["ops"].reset_launches()


def read_launches(path):
    """Launch counts of the kernels of ``path``; each must be > 0."""
    counts = {n: k["ops"].launches for n, k in KERNELS.items() if path in k["paths"]}
    for n, c in counts.items():
        if c <= 0:
            raise RuntimeError(f"kernel {n} was not launched on the {path} path")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of the control flow (no result line)")
    args = ap.parse_args(argv)
    if args.rehearse:
        return rehearse()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peak = hbm_peak_bytes_per_s(name)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    report = {"card": smi}

    t_start = t0 = time.perf_counter()
    _build.build(KERNELS)
    report["build_s"] = time.perf_counter() - t0
    log(f"built {list(KERNELS)} in {report['build_s']:.2f} s")

    # the detection path
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    spec, store, proj = main_path(FULL, dev, report)
    by_path = {"detection": read_launches("detection")}
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the detection path: {by_path['detection']}; max memory allocated "
        f"{report['max_memory_allocated'] / 2 ** 30:.2f} GiB")
    check_results(FULL, dev, spec, store, proj, report)
    where_time_goes(FULL, dev, spec, store, report)
    small_pipeline_vs_cpu(dev, report)
    gather_err, tile = kernel_checks(dev, store, spec, FULL, report, peak)
    del spec, store, proj
    torch.cuda.empty_cache()

    # the serving path
    cfg, model = serving_model(SERVE_FULL, dev)
    serving_path(SERVE_TINY | dict(smoke=False), dev, cfg, model, {})  # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(SERVE_FULL, dev, cfg, model, report)
    by_path["serving"] = serve_launches = read_launches("serving")
    report["serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the serving path: {serve_launches}; max memory allocated "
        f"{report['serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(SERVE_FULL, dev, cfg, model, prompts, cache, generated, report)
    errs = {"flash_attention": [], "flash_decode": []}
    layer0_attention_vs_plain(SERVE_FULL, dev, cfg, model, prompts, cache, report, errs)
    batcher_decode_checks(SERVE_FULL, dev, cfg, report, errs["flash_decode"])
    del prompts, generated, cache
    torch.cuda.empty_cache()
    serving_small_vs_cpu(dev, report)
    attention_kernel_checks(dev, errs)
    timings = attention_timings(SERVE_FULL, dev, cfg, name, report)
    del model
    torch.cuda.empty_cache()

    # the ssm serving path
    cfg, model = serving_model(SSM_FULL, dev)
    serving_path(SSM_TINY | dict(smoke=False), dev, cfg, model, {})  # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(SSM_FULL, dev, cfg, model, report)
    by_path["ssm_serving"] = ssm_launches = read_launches("ssm_serving")
    report["ssm_serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the ssm_serving path: {ssm_launches}; max memory allocated "
        f"{report['ssm_serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(SSM_FULL, dev, cfg, model, prompts, cache, generated, report)
    errs["ssd_scan"] = []
    layer0_ssm_vs_plain(SSM_FULL, dev, cfg, model, prompts, report, errs["ssd_scan"])
    del prompts, generated, cache
    torch.cuda.empty_cache()
    serving_small_vs_cpu(dev, report, "mamba2-370m")
    ssd_kernel_checks(dev, errs["ssd_scan"])
    timings["ssd_scan"] = ssd_timing(SSM_FULL, dev, cfg, name, report)
    del model
    torch.cuda.empty_cache()

    # the MoE serving path
    cfg, model = serving_model(MOE_FULL, dev)
    serving_path(MOE_TINY | dict(smoke=False), dev, cfg, model, {})  # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(MOE_FULL, dev, cfg, model, report)
    by_path["moe_serving"] = moe_launches = read_launches("moe_serving")
    check_moe_launches(MOE_FULL, cfg, report, moe_launches)
    report["moe_serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the moe_serving path: {moe_launches}; max memory allocated "
        f"{report['moe_serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(MOE_FULL, dev, cfg, model, prompts, cache, generated, report)
    moe_drop_shares(MOE_FULL, dev, cfg, model, prompts, cache, generated, report)
    layer0_attention_vs_plain(MOE_FULL, dev, cfg, model, prompts, cache, report, errs)
    batcher_decode_checks(MOE_FULL, dev, cfg, report, errs["flash_decode"])
    del generated, cache
    torch.cuda.empty_cache()
    errs["moe_gemm"] = []
    gemm_args = layer0_moe_vs_plain(MOE_FULL, dev, cfg, model, prompts, report,
                                    errs["moe_gemm"])
    del prompts
    serving_small_vs_cpu(dev, report, "granite-moe-1b-a400m")
    moe_kernel_checks(dev, report, errs["moe_gemm"])
    timings["moe_gemm"] = moe_timing(dev, name, report, *gemm_args)
    del gemm_args, model
    torch.cuda.empty_cache()

    # the tile-order path of morton_matmul
    t0 = time.perf_counter()
    reset_launches()
    morton_path(MM_FULL, dev, report)
    by_path["morton_matmul"] = read_launches("morton_matmul")
    report["morton_matmul"]["padded_copies"] = mm_ops.padded_copies
    log(f"launches on the morton_matmul path: {by_path['morton_matmul']}; bf16 operands "
        f"copied for TMA: {mm_ops.padded_copies}")
    errs["morton_matmul"] = []
    morton_kernel_checks(dev, report, errs["morton_matmul"])
    timings["morton_matmul"] = morton_timing(dev, name, report)
    report["morton_matmul"]["phase_s"] = time.perf_counter() - t0
    log(f"morton_matmul phase {report['morton_matmul']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the rest of the dense family at full width
    for sc in DENSE_FULL:
        cfg, model, prompts, generated, cache = dense_family_path(sc, dev, report)
        by_path[sc["key"]] = counts = read_launches(sc["key"])
        check_dense_launches(sc, cfg, counts)
        report[sc["key"]]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        log(f"launches on the {sc['key']} path: {counts}; max memory allocated "
            f"{report[sc['key']]['max_memory_allocated'] / 2 ** 30:.3f} GiB")
        serving_profile(sc, dev, cfg, model, prompts, cache, generated, report)
        layer0_attention_vs_plain(sc, dev, cfg, model, prompts, cache, report, errs)
        del model, prompts, generated, cache
        torch.cuda.empty_cache()
    for arch in ("gemma-2b", "minitron-8b", "llama3-405b"):
        serving_small_vs_cpu(dev, report, arch)

    # training at full width: the dense, MoE and ssm families
    for tc in TRAINS_FULL:
        training_phase(tc, dev, name, report, by_path)

    # checkpoint and restart of each family's smoke model on the card
    t0 = time.perf_counter()
    for arch in RESTART_ARCHS:
        restart_vs_uninterrupted(dev, report, arch)
    report["restart"]["phase_s"] = time.perf_counter() - t0
    log(f"restart phase {report['restart']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    rows = [dict(name="cutout_gather", max_abs_err=gather_err, ms=tile["ms"],
                 plain_ms=tile["plain_ms"], bound_ms=tile["bound_ms"],
                 bound_by="bytes", library_ms=None)]
    for n in ("flash_attention", "flash_decode", "ssd_scan", "moe_gemm", "morton_matmul"):
        t = timings[n]
        rows.append(dict(name=n, max_abs_err=max(errs[n]), ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=t["library_ms"]))
    rows = [dict(name=r["name"], route=KERNELS[r["name"]]["route"],
                 source=KERNELS[r["name"]]["source"],
                 replaces=KERNELS[r["name"]]["replaces"],
                 launches=sum(c[r["name"]] for c in by_path.values() if r["name"] in c),
                 **{k: v for k, v in r.items() if k != "name"},
                 launches_by_path={pth: c[r["name"]] for pth, c in by_path.items()
                                   if r["name"] in c}) for r in rows]
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    log(f"smoke wall time {report['wall_s']:.1f} s (from the build on)")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
