"""``flash_attention_grad_roofline``'s reader: nothing where no gradient
kernel ran (the saved trace, as a program without them gives), and the
least time of the traced steps' gradient calls over the ``attn_grad*``
ops' device time in the train range where they did."""
import dataclasses

import pytest

from ocpbench import harness
from ocpbench.counts import moe_lm as counts
from ocpbench.trace import Op

from test_ocpbench_harness import saved_run

reader = harness.reader("flash_attention_grad_roofline")


def test_reads_nothing_without_the_gradient_kernels():
    run = saved_run()
    run.mix = dict(run.mix, microbatches=2)
    assert reader.read("flash_attention_grad_roofline.train", run) is None
    run.calls = {}
    assert reader.read("flash_attention_grad_roofline.train", run) is None


def test_reads_the_gradient_kernels_in_the_train_range():
    run = saved_run()
    run.mix = dict(run.mix, microbatches=2)
    run.calls = {"flash_attention": [(2, 4), (2, 4)]}  # two traced steps
    inside = frozenset({"ocpbench.train_step", "flash_attention.recompute"})
    ops = [Op("void attn_grad_dkdv_tc<64>", 300e-9, inside),
           Op("void attn_grad_dq_tc<64>", 200e-9, inside),
           Op("void attn_grad_delta<64>", 50e-9, inside),
           Op("void attn_grad_dq_tc<64>", 900e-9, frozenset({"ocpbench.prefill"})),
           Op("void flash_attention_tc<64, true>", 700e-9, inside)]
    run.trace = dataclasses.replace(run.trace, ops=ops)
    m = run.model
    flops, nbytes = reader.grad_call(m, 2, 4)
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    assert flops == 10 * 2 * H * hd * counts.causal_pairs(4)
    assert nbytes == 2 * (4 * 2 * 4 * H * hd + 4 * 2 * 4 * K * hd) + 4 * 2 * H * 4
    least = 2 * m["n_layers"] * 2 * counts.least_s(flops, nbytes, run.peaks)
    got = reader.read("flash_attention_grad_roofline.train", run)
    assert got == pytest.approx(100 * least / 550e-9)
