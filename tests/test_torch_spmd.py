"""Port: the sharded path (DTensors under a sharding plan, the path the dry
run and the hill climb cost) against the plain one, over a process group
that moves data.

Four gloo ranks in spawned processes (tests/torch_spmd_worker.py) form a
2 x 2 ("data", "model") mesh.  Each family's smoke config, in fp32, runs
the forward pass, the prefill, two decode steps and one AdamW train step
once on plain tensors and once on DTensors laid out by the plan; every
result of the sharded run, gathered whole on every rank, equals the plain
run's within 1e-5 (absolute and relative; the sharded sums run in another
order): logits, the MoE aux loss, the caches, the sampled tokens, the
loss, the gradient norm, every gradient and every updated weight.

The cases cover the per-device code of `models.spmd` and the MoE's sharded
dispatch: attention with the kv heads split over ``model`` (smollm-135m)
and with one kv head picked a device by its coordinate (gemma-2b,
recurrentgemma-2b, whose caches then shard their sequence: the prefill's
prefix written slice by slice, `cache_insert` by the owning device and
`flash_decode`'s split-KV merge), the embedding and the loss with the
vocab sharded and, at an odd vocab, whole on each device, the
chunked ssd scan (mamba2-370m), the RG-LRU scan, the encoder-decoder, and
the MoE's ``gspmd`` dispatch (all-to-alls, per-device capacity; granite
and arctic, with its dense residual) and ``local`` dispatch.  The MoE
cases run at a capacity at which nothing drops, where a device's capacity
and the global one keep the same picks; tests/test_torch_moe_local.py
holds the dispatches with drops.  The ``local`` case runs without the
router loss: its loss is the mean of the groups' (the JAX ``_moe_local``),
not one dispatch's, and test_torch_moe_local.py holds it against JAX.
"""
import numpy as np
import pytest

import torch_spmd_worker as worker

TOL = 1e-5

CASES = {
    "dense": ("smollm_135m", {}),
    "dense_whole_vocab": ("smollm_135m", {"vocab": 255}),
    "dense_seq_cache": ("gemma_2b", {}),
    "moe_gspmd": ("granite_moe_1b_a400m", {"capacity_factor": 2.0}),
    "moe_local": ("granite_moe_1b_a400m", {"capacity_factor": 2.0, "moe_dispatch": "local",
                                           "router_aux_coef": 0.0}),
    "moe_residual": ("arctic_480b", {"capacity_factor": 4.0}),
    "ssm": ("mamba2_370m", {}),
    "hybrid": ("recurrentgemma_2b", {}),
    "encdec": ("seamless_m4t_medium", {}),
}
PHASES = {"forward": ("forward.",), "prefill": ("prefill.", "prefill_cache."),
          "decode": ("decode",), "train": ("train.",)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [dict(name=name, kind="model", arch=arch, overrides=over)
             for name, (arch, over) in CASES.items()]
    return worker.spawn(cases, tmp_path_factory.mktemp("spmd"))


def test_the_ranks_are_the_2x2_mesh(ranks):
    assert sorted(tuple(r["coordinate"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_plain(ranks, case, phase):
    for r, res in enumerate(ranks):
        assert f"{case}/error" not in res, (r, str(res[f"{case}/error"]))
        keys = [k for k in res if k.startswith(f"{case}/shd/")
                and k.split("/")[2].startswith(PHASES[phase])]
        assert keys, (case, phase)
        for k in keys:
            want = res[k.replace("/shd/", "/ref/")]
            np.testing.assert_allclose(res[k], want, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("case,expected", [("dense", False), ("dense_seq_cache", True),
                                           ("hybrid", True)])
def test_kv_cache_shards_its_sequence_where_the_kv_heads_do_not_divide(ranks, case,
                                                                       expected):
    """One kv head does not divide ``model``'s 2 devices: the cache falls
    back to sharding its sequence (``kv_len``), which the split-KV decode
    then reads."""
    for res in ranks:
        assert bool(res[f"{case}/shd/seq_sharded"]) is expected
