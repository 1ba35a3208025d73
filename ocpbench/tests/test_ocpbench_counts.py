"""The frozen counts against hand counts, at the smoke widths and at the
published ones."""
import pytest

from ocpbench.counts import moe_lm as counts

from smoke import GRANITE

ARCTIC = dict(n_layers=2, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128, d_ff=4864,
              vocab=32000, n_experts=128, top_k=2, moe_dense_residual=True, dtype="bfloat16")
GRANITE_FULL = dict(n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64, d_ff=512,
                    vocab=49155, n_experts=32, top_k=8, moe_dense_residual=False,
                    dtype="bfloat16")
H100 = counts.peaks("NVIDIA H100 80GB HBM3")


def test_kernel_calls_at_smoke_widths():
    # q, k, v, o: 64 x 64 twice and 64 x 32 twice; an expert 3 x 64 x 64
    assert counts.attention_weights(GRANITE) == 12288
    assert counts.expert_weights(GRANITE) == 12288
    # B 2, S 4, H 4, D 16: 10 causal pairs; q and out 2 x 4 x 4 x 16, k and v 2 x 4 x 2 x 16
    assert counts.flash_attention_call(GRANITE, 2, 4) == (4 * 2 * 4 * 16 * 10,
                                                          2 * (2 * 512 + 2 * 256))
    # 8 live positions of K 2, D 16; q and out 2 x 4 x 16; the lengths 2 x 4 bytes
    assert counts.flash_decode_call(GRANITE, 2, [3, 5]) == (4 * 4 * 16 * 8,
                                                            2 * (2 * 8 * 32 + 2 * 128) + 8)
    # C 3: live rows 0 + 1 + 3 + 2, three experts touched, an (8, 3, 64) output
    flops, nbytes = counts.moe_gemm_call(GRANITE, 3, [0, 1, 5, 2, 0, 0, 0, 0])
    assert flops == 6 * 64 * 64 * 6
    assert nbytes == 2 * (6 * 64 + 8 * 3 * 64 + 3 * 12288) + 4 * 8


def test_whole_steps_at_smoke_widths():
    # a token's products in a layer: projections 12288, router 64 x 8, 4 experts
    per_token = 2 * (12288 + 512 + 4 * 12288)
    fwd = 2 * 2 * 4 * per_token + 2 * 8 * 64 * 256 + 2 * 4 * 2 * 4 * 16 * 10
    assert counts.train_step_flops(GRANITE, 2, 4) == 3 * fwd
    assert counts.prefill_flops(GRANITE, 2, 4) == (2 * 2 * 4 * per_token + 2 * 4 * 2 * 4 * 16 * 10
                                                   + 2 * 2 * 64 * 256)
    flops, nbytes = counts.decode_step_cost(GRANITE, 2, [5, 5], [3, 4])
    assert flops == 2 * 2 * per_token + 2 * 4 * 4 * 16 * 10 + 2 * 2 * 64 * 256
    weights = 2 * 12288 + 64 * 256 + 2 * 64 + 7 * 12288
    cache = 2 * (2 * 10 * 2 * 16 + 2 * 2 * 2 * 16)
    assert nbytes == 2 * (weights + cache) + 4 * (2 * 64 * 8 + 5 * 64)


def test_arctic_prefill_flops_at_published_widths():
    """mfu.rag's count: 32 prompts of 2,048 tokens through 2 layers."""
    proj = 2 * 7168 * 7168 + 2 * 7168 * 1024           # 117,440,512
    expert = 3 * 7168 * 4864                            # 104,595,456
    per_token = 2 * (proj + 7168 * 128 + 2 * expert + expert)
    attn = 2 * 4 * 32 * 56 * 128 * (2048 * 2049 // 2)
    head = 2 * 32 * 7168 * 32000
    want = 2 * 32 * 2048 * per_token + attn + head
    assert counts.prefill_flops(ARCTIC, 32, 2048) == want
    assert want == pytest.approx(1.1713e14, rel=1e-3)
    # at the bf16 peak about 0.118 s: a prefill of ~0.37 s is ~32% of it
    assert counts.least_s(want, 0, H100) == pytest.approx(0.1184, rel=1e-3)


def test_arctic_decode_step_bytes_at_published_widths():
    """A decode step of 32 tokens at length 2,049 touching 50 and 48
    experts: about 22 GB, bytes-bound at about 6.7 ms."""
    proj, expert = 117440512, 104595456
    flops, nbytes = counts.decode_step_cost(ARCTIC, 32, [2049] * 32, [50, 48])
    weights = 2 * proj + 7168 * 32000 + 32 * 7168 + 2 * expert + 98 * expert
    cache = 2 * (2 * 32 * 2049 * 8 * 128 + 2 * 32 * 8 * 128)
    assert nbytes == 2 * (weights + cache) + 4 * (2 * 7168 * 128 + 5 * 7168)
    assert counts.bound_by(flops, nbytes, H100) == "bytes"
    assert counts.least_s(flops, nbytes, H100) == pytest.approx(6.684e-3, rel=1e-3)


def test_arctic_moe_gemm_bounds():
    """The prefill's call is bound by its operations, a decode step's by
    its bytes (the weights of the experts with picks)."""
    f1, b1 = counts.moe_gemm_call(ARCTIC, 1280, [1024] * 128)
    assert counts.bound_by(f1, b1, H100) == "operations"
    assert f1 == 6 * 7168 * 4864 * 1024 * 128
    f2, b2 = counts.moe_gemm_call(ARCTIC, 2, [1] * 50 + [0] * 78)
    assert counts.bound_by(f2, b2, H100) == "bytes"
    assert b2 == 2 * (50 * 7168 + 128 * 2 * 7168 + 50 * 104595456) + 4 * 128


def test_granite_train_step_flops_at_published_widths():
    """9.42e13 a step of 16 x 2,048 tokens: at 5.0 s, 1.9% of the peak."""
    flops = counts.train_step_flops(GRANITE_FULL, 16, 2048)
    per_token = 2 * (2 * 1024 * 1024 + 2 * 1024 * 512 + 1024 * 32 + 8 * 3 * 1024 * 512)
    fwd = (24 * 32768 * per_token + 2 * 32768 * 1024 * 49155
           + 24 * 4 * 16 * 16 * 64 * (2048 * 2049 // 2))
    assert flops == 3 * fwd
    assert flops / 5.0078 / H100["flops"] == pytest.approx(0.019, rel=0.02)


def test_peaks_by_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == {"flops": 989e12, "bytes": 3.35e12}
    with pytest.raises(ValueError):
        counts.peaks("NVIDIA H100 PCIe")
    with pytest.raises(ValueError):
        counts.peaks("cpu")
