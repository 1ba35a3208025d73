"""The port's dry run (`repro_torch.launch.dryrun`) end to end.

The production cell that tests/test_system.py tries on the JAX side,
granite-moe-1b-a400m x decode_32k on both meshes, in a process of its own
(the fake group of 512 ranks), within 120 s; and one cell per family at
its smoke widths on a 2 x 2 mesh, train and decode, status ``ok`` with
finite, positive costs.
"""
import math
import os
import pathlib
import subprocess
import sys
import time

import pytest

from repro_torch.launch.dryrun import run_cell
from torch_fake_world import mesh2x2  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_granite_decode_cell_on_both_meshes_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "granite-moe-1b-a400m", "--shape", "decode_32k", "--mesh", "both"],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.count("OK") == 2
    assert time.time() - t0 < 120


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m", "mamba2-370m",
                                  "recurrentgemma-2b", "seamless-m4t-medium"])
def test_one_cell_per_family_at_smoke_widths(mesh2x2, arch, shape):
    cell = run_cell(arch.replace("-", "_"), shape, smoke=True, mesh_name="2x2",
                    verbose=False)
    assert cell["status"] == "ok", cell
    row = cell["roofline"]
    for key in ("t_compute_s", "t_memory_s", "hlo_flops", "hlo_bytes", "model_flops",
                "peak_mem_per_device"):
        assert math.isfinite(row[key]) and row[key] > 0, (key, row)
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert cell["memory_analysis"]["argument_bytes"] > 0
    assert set(cell["coll_breakdown"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                           "all-to-all", "collective-permute"}


def test_long_context_is_skipped_with_the_jax_reason(mesh2x2):
    cell = run_cell("smollm_135m", "long_500k", smoke=True, mesh_name="2x2")
    assert cell["status"] == "skipped" and "524k" in cell["reason"]


def test_peak_breakdown_adds_up_and_keeps_the_vocab_sharded(mesh2x2):
    """What is live at the peak of smollm-135m's train step (smoke widths, 2
    x 2): the rows add up to the peak; no tensor holds the whole vocab of a
    device's tokens (the loss takes the log-softmax over the vocab's
    shards; a gathered vocab would be (128, 4096, 256) floats), and none
    the whole batch of 256 sequences (the rotary tables broadcast over
    the batch)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import peak_breakdown

    vocab = get_smoke_config("smollm_135m").vocab
    peak, rows = peak_breakdown("smollm_135m", "train_4k", "2x2", smoke=True, top=10_000)
    assert peak > 0 and sum(b for _, b in rows) == peak
    assert [b for _, b in rows] == sorted((b for _, b in rows), reverse=True)
    whole_vocab = [w for w, _ in rows if w != "input" and f", {vocab})" in w]
    assert not whole_vocab, whole_vocab
    whole_batch = [w for w, _ in rows if " (256, " in w]
    assert not whole_batch, whole_batch
