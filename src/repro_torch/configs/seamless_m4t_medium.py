"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder multimodal
backbone (MHA, kv=16). The speech frontend is a stub: the encoder takes
precomputed frame embeddings.

A copy of `repro.configs.seamless_m4t_medium`."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, act="swiglu", tie_embeddings=True,
    frontend="frame_stub",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, n_enc_layers=2, n_dec_layers=2,
                         d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                         d_ff=128, vocab=256)
