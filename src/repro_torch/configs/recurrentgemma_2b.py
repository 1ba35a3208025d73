"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin: RG-LRU recurrent blocks
with local (sliding-window) attention at a 1:2 ratio (pattern RRA).

A copy of `repro.configs.recurrentgemma_2b`."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, act="geglu", tie_embeddings=True,
    hybrid_pattern="RRA", local_window=2048, d_rnn=2560, conv_width=4,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=1,
                         head_dim=16, d_ff=128, vocab=256, d_rnn=64,
                         local_window=32)
