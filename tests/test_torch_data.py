"""Port parity: the training-data pipeline and the CPU training driver
against the JAX package.

The port's `TokenStore` is a rank-2 uint32 `DeviceCuboidStore` read
through `cutout` (the `cutout_gather` wrapper pads the grid to rank 3 for
the kernel); batches must equal the JAX pipeline's bit for bit, on the
same corpus and step.  The driver's first loss is held within 2e-2 of the
JAX driver's (other weights from other generators, the same corpus and
the same ~ln(vocab) start).
"""
import numpy as np
import pytest
import torch

from repro.core.cuboid import DatasetSpec as JDatasetSpec
from repro.core.cutout import cutout as j_cutout
from repro.core.cutout import ingest as j_ingest
from repro.core.store import CuboidStore
from repro.data import DataPipeline as JDataPipeline
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenStore as JTokenStore
from repro.launch import train as j_train
from repro_torch.configs import get_smoke_config
from repro_torch.core import cutout as cut
from repro_torch.core import morton
from repro_torch.core.cuboid import CuboidGrid, DatasetSpec
from repro_torch.core.store import DeviceCuboidStore
from repro_torch.data import DataPipeline, PipelineConfig, TokenStore
from repro_torch.kernels.cutout_gather.ops import build_plan
from repro_torch.launch import train


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 2 ** 32, size=(64, 256), dtype=np.uint64).astype(np.uint32)
    jstore = JTokenStore(64, 256, cuboid=(16, 256))
    jstore.ingest_corpus(toks)
    store = TokenStore(64, 256, cuboid=(16, 256), device="cpu")
    store.ingest_corpus(toks)
    return jstore, store, toks


@pytest.mark.parametrize("box", [((3, 0), (4, 256)), ((5, 17), (40, 133)),
                                 ((0, 0), (64, 256)), ((60, 250), (70, 300))])
def test_rank2_cutout_matches_jax(box):
    """A 2-D uint32 store: the port's cutout returns the JAX cutout's bits
    (whole rows, a ragged box, the whole grid, a box past the edge)."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 2 ** 32, size=(64, 200), dtype=np.uint64).astype(np.uint32)
    jspec = JDatasetSpec("tokens", (64, 200), dtype="uint32", base_cuboid=(16, 64),
                         scaled_dims=())
    jstore = CuboidStore(jspec)
    j_ingest(jstore, 0, toks)
    spec = DatasetSpec("tokens", (64, 200), dtype="uint32", base_cuboid=(16, 64),
                       scaled_dims=())
    store = DeviceCuboidStore(spec, device="cpu")
    cut.ingest(store, 0, toks)
    lo, hi = box
    want = np.asarray(j_cutout(jstore, 0, lo, hi))
    got = cut.cutout(store, 0, lo, hi)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("rank", [1, 2])
def test_unit_axes_keep_the_morton_plan(rank):
    """Leading unit axes (what the wrapper adds for the kernel) take no
    Morton bits: the padded grid's plan visits the same cells."""
    vol, cs = ((300,), (64,)) if rank == 1 else ((64, 200), (16, 64))
    lo, hi = ((7,), (250,)) if rank == 1 else ((5, 17), (40, 133))
    grid = CuboidGrid(vol, cs)
    pad = 3 - rank
    padded = CuboidGrid((1,) * pad + vol, (1,) * pad + cs)
    assert padded.bits == (0,) * pad + grid.bits
    assert padded.n_cells == grid.n_cells
    a, b = build_plan(grid, lo, hi), build_plan(padded, (0,) * pad + lo,
                                                  (1,) * pad + hi)
    assert b[0] == (1,) * pad + a[0]
    np.testing.assert_array_equal(b[1], a[1])


def test_rank1_cutout_reads_back():
    spec = DatasetSpec("v", (300,), dtype="float32", base_cuboid=(64,), scaled_dims=())
    store = DeviceCuboidStore(spec, device="cpu")
    v = np.random.default_rng(2).normal(size=300).astype(np.float32)
    cut.ingest(store, 0, v)
    np.testing.assert_array_equal(cut.cutout(store, 0, (7,), (250,)).numpy(), v[7:250])


def test_partition_curve_matches_jax():
    from repro.core.morton import partition_curve as j_partition_curve

    for n, k in [(8, 4), (10, 3), (3, 5), (0, 2), (16, 1)]:
        assert morton.partition_curve(n, k) == j_partition_curve(n, k)
    with pytest.raises(ValueError):
        morton.partition_curve(4, 0)


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_get_batch_bit_equal_to_jax(corpus, step):
    jstore, store, toks = corpus
    cfg = dict(seq_len=32, global_batch=8, seed=3)
    want = JDataPipeline(jstore, JPipelineConfig(**cfg)).get_batch(step)
    pipe = DataPipeline(store, PipelineConfig(**cfg))
    got = pipe.get_batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    rows = pipe.batch_rows(step)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks[rows, :32].astype(np.int32))
    np.testing.assert_array_equal(got["labels"].numpy(), toks[rows, 1:33].astype(np.int32))
    assert pipe.units_processed == 8 and pipe.steals >= 0


@pytest.mark.parametrize("host", [0, 1])
def test_host_slices_bit_equal_to_jax(corpus, host):
    jstore, store, _ = corpus
    cfg = dict(seq_len=16, global_batch=7, n_hosts=2, host_id=host, seed=5)
    jpipe = JDataPipeline(jstore, JPipelineConfig(**cfg))
    pipe = DataPipeline(store, PipelineConfig(**cfg))
    np.testing.assert_array_equal(pipe.host_slice(2), jpipe.host_slice(2))
    for step in range(2):
        want, got = jpipe.get_batch(step), pipe.get_batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    halves = [DataPipeline(store, PipelineConfig(**(cfg | dict(host_id=h)))).host_slice(2)
              for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves), pipe.batch_rows(2))


def test_prefetch_gives_the_stateless_batches(corpus):
    _, store, _ = corpus
    pipe = DataPipeline(store, PipelineConfig(seq_len=16, global_batch=4))
    pipe.start(first_step=5)
    try:
        for want_step in (5, 6):
            step, batch = pipe.next()
            assert step == want_step
            assert torch.equal(batch["tokens"], pipe.get_batch(step)["tokens"])
    finally:
        pipe.stop()


def test_pipeline_refuses_short_documents(corpus):
    _, store, _ = corpus
    with pytest.raises(ValueError, match="doc_len"):
        DataPipeline(store, PipelineConfig(seq_len=256, global_batch=2))


def test_synthetic_corpus_is_the_jax_drivers():
    cfg = get_smoke_config("smollm-135m")
    j = j_train.synthetic_corpus(cfg, n_docs=32, doc_len=50, seed=4)
    t = train.synthetic_corpus(cfg, n_docs=32, doc_len=50, seed=4, device="cpu")
    want = np.asarray(j_cutout(j.store, 0, (0, 0), (32, 50)))
    got = t.read_rows(0, 32, 0, 50).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert t.spec.grid(0).cuboid_shape == (16, 50)


def test_cpu_driver_trains_and_starts_at_the_jax_loss(capsys):
    out = train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
    want = j_train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])["losses"]
    assert abs(losses[0] - want[0]) < 2e-2


def test_cpu_driver_microbatches_and_compression():
    out = train.main(["--arch", "llama3-405b", "--smoke", "--device", "cpu", "--steps",
                      "8", "--seq-len", "32", "--batch", "4", "--microbatches", "2",
                      "--grad-compression", "int8"])
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("argv,err", [
    (["--arch", "arctic-480b"], "A13"),  # the full model; its smoke config trains
    (["--arch", "internvl2-76b"], "does not fit one card.*A13"),  # the full model
])
def test_driver_raises_for_what_is_not_ported(argv, err):
    args = ["--device", "cpu", "--steps", "1"]
    with pytest.raises(NotImplementedError, match=err):
        train.main(args + argv)


def test_driver_refuses_a_failure_without_checkpoints():
    with pytest.raises(SystemExit):
        train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "1",
                    "--inject-failure-at", "3"])


def test_driver_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenStore(4, 8, cuboid=(2, 8))
