"""The port's dry-run cost model (`repro_torch.launch.roofline`, `specs`,
`dryrun`) against the JAX package's and against itself.

`model_flops_estimate` and `cell_is_applicable` equal JAX's for every arch
x shape (exactly).  The `Roofline` terms on the H100 SXM constants.  The
collective counter on hand-built redistributes over a 2 x 2 mesh of the
fake process group: exact byte counts, the all-to-all filed under
``all-to-all``.  Sharding conserves the work: a dense smoke step's FLOPs
per device x 4 equal the unsharded step's (every product's sharded dims
divide), exactly.  The extrapolation from depths 2 and 4 equals a direct
count at depth 6 within 1e-9 relative.
"""
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch.roofline import model_flops_estimate as j_model_flops_estimate
from repro.launch.specs import cell_is_applicable as j_cell_is_applicable
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import _cost_tuple, depth_variant, extrapolated_cost
from repro_torch.launch.roofline import CostMode, Roofline, model_flops_estimate
from repro_torch.launch.specs import cell_is_applicable, fake_dtensor, fake_mode
from repro_torch.models.config import SHAPES
from repro_torch.train.sharding import make_plan
from torch_fake_world import mesh2x2  # noqa: F401


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_applicability_equal_jax(arch, shape):
    jcfg, cfg = j_get_config(arch), get_config(arch, abstract=True)
    assert model_flops_estimate(cfg, SHAPES[shape]) == \
        j_model_flops_estimate(jcfg, J_SHAPES[shape])
    assert cell_is_applicable(cfg, SHAPES[shape]) == \
        j_cell_is_applicable(jcfg, J_SHAPES[shape])


def test_roofline_terms_and_bottleneck_on_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    r = Roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                 coll_bytes={"all-reduce": int(450e9 / 4)}, n_chips=256,
                 model_flops=989e12 * 256 * 0.5)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.5)
    r = Roofline(flops=1e12, hbm_bytes=1e9, coll_bytes={"all-gather": int(9e11)},
                 n_chips=4, model_flops=2e12)
    assert r.bottleneck == "collective" and r.t_collective == pytest.approx(2.0)
    assert set(r.row()) == {"t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                            "hlo_flops", "hlo_bytes", "collective_bytes", "model_flops",
                            "useful_ratio", "roofline_fraction", "peak_mem_per_device"}


def test_collective_counter_on_hand_built_redistributes(mesh2x2):
    """One all-gather, one all-to-all, one all-reduce and one
    reduce-scatter, each at its result's bytes on this rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    plan = make_plan(mesh2x2)
    x = fake_dtensor((8, 16), torch.float32, plan, ("data", None))    # local (4, 16)
    with fake_mode(), CostMode() as cost:
        x.redistribute(mesh2x2, (Replicate(), Replicate()))          # all-gather -> (8, 16)
        assert cost.coll["all-gather"] == 8 * 16 * 4
        x.redistribute(mesh2x2, (Shard(1), Replicate()))              # all-to-all -> (8, 8)
        assert cost.coll["all-to-all"] == 8 * 8 * 4
        assert cost.coll["all-gather"] == 8 * 16 * 4                  # not filed twice
        p = DTensor.from_local(x.to_local(), mesh2x2, (Partial(), Replicate()),
                               run_check=False)
        p.redistribute(mesh2x2, (Replicate(), Replicate()))          # all-reduce (4, 16)
        p.redistribute(mesh2x2, (Shard(0), Replicate()))              # reduce-scatter (2, 16)
    assert cost.coll == {"all-gather": 512, "all-to-all": 256, "all-reduce": 256,
                         "reduce-scatter": 128, "collective-permute": 0}
    # the local product is counted at its local shapes
    with fake_mode(), CostMode() as cost:
        x.to_local() @ torch.ones(16, 3)
    assert cost.flops == 2 * 4 * 16 * 3


def test_sharding_conserves_the_work(mesh2x2):
    """smollm's smoke step (heads 4, kv heads 2, d 64, ff 128, vocab 256:
    every sharded dim divides 2) on the 2 x 2 mesh: FLOPs per device x 4
    equal the 1 x 1 mesh's FLOPs, for training and a decode step."""
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_smoke_config("smollm-135m")
    one = make_plan(make_local_mesh())
    four = make_plan(mesh2x2)
    for shape in (SHAPES["train_4k"], SHAPES["decode_32k"]):
        f1 = _cost_tuple(cfg, shape, one)[0]
        f4 = _cost_tuple(cfg, shape, four)[0]
        assert f1 > 0 and 4 * f4 == f1, (shape.name, f1, f4)


@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("granite-moe-1b-a400m", "decode_32k")])
def test_extrapolation_is_exact_for_identical_layers(mesh2x2, arch, shape):
    """Costs at depths 2 and 4 extrapolated to 6 against a direct count at
    depth 6: FLOPs, bytes, collectives and the peak within 1e-9."""
    plan = make_plan(mesh2x2)
    cfg = depth_variant(get_smoke_config(arch), 6)
    f, b, c, m, extrapolated = extrapolated_cost(cfg, SHAPES[shape], plan, depths=(2, 4))
    F, B, C, M = _cost_tuple(cfg, SHAPES[shape], plan)
    assert extrapolated
    for got, want in ((f, F), (b, B), (m, M)):
        assert abs(got - want) <= 1e-9 * want
    assert c == C
