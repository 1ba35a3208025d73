"""The port's hill-climb harness (`repro_torch.launch.hillclimb`): its
variant table is the JAX package's (the hypotheses' prose aside), and `run_variant` costs
``baseline``, ``dp_only`` and ``local_dispatch`` on granite-moe-1b-a400m's
smoke config on a 2 x 2 mesh of the fake process group.  ``big_blocks``
(attention tile sizes, which the port's kernel fixes) is reported as not
applicable, with its reason.  `main` appends its rows to the log it is
given.
"""
import json
import math

from repro.launch.hillclimb import VARIANTS as J_VARIANTS
from repro.train.sharding import default_rules as j_default_rules
from repro_torch.launch import hillclimb
from repro_torch.launch.hillclimb import VARIANTS, run_variant
from repro_torch.train.sharding import default_rules
from torch_fake_world import mesh2x2  # noqa: F401


def test_variant_table_is_the_jax_one():
    assert list(VARIANTS) == list(J_VARIANTS)
    for name, v in VARIANTS.items():
        j = J_VARIANTS[name]
        assert (v.cfg_overrides, v.loss_impl, v.n_microbatches, v.opt_overrides) == \
            (j.cfg_overrides, j.loss_impl, j.n_microbatches, j.opt_overrides)
        if v.rules_fn is not None:
            for mp in (False, True):
                assert v.rules_fn(default_rules(mp)) == j.rules_fn(j_default_rules(mp))
    assert [n for n, v in VARIANTS.items() if v.not_applicable] == ["big_blocks"]


def test_run_variant_costs_three_variants(mesh2x2):
    rows = {name: run_variant("granite_moe_1b_a400m", "train_4k", VARIANTS[name],
                              smoke=True, mesh_name="2x2")
            for name in ("baseline", "dp_only", "local_dispatch")}
    for name, row in rows.items():
        assert row["status"] == "ok" and row["variant"] == name
        for key in ("t_compute_s", "t_memory_s", "t_collective_s", "hlo_flops",
                    "peak_mem_per_device"):
            assert math.isfinite(row[key]) and row[key] > 0, (name, key)
    # the same model work whatever the layout
    assert len({row["model_flops"] for row in rows.values()}) == 1
    # local dispatch moves no tokens across devices: no all-to-all
    assert rows["local_dispatch"]["collective_bytes"] < rows["baseline"]["collective_bytes"]


def test_big_blocks_is_not_applicable_and_main_appends(tmp_path, mesh2x2):
    out = tmp_path / "perf_log.json"
    out.write_text(json.dumps([{"earlier": 1}]))
    rows = hillclimb.main(["--arch", "granite-moe-1b-a400m", "--shape", "decode_32k",
                           "--smoke", "--mesh", "2x2", "--variant", "big_blocks",
                           "--variant", "baseline", "--out", str(out)])
    log = json.loads(out.read_text())
    assert log[0] == {"earlier": 1} and log[1:] == json.loads(json.dumps(rows))
    assert rows[0]["status"] == "not_applicable" and "attn_block_q" in rows[0]["reason"]
    assert rows[1]["status"] == "ok"
