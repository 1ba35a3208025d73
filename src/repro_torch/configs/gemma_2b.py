"""Gemma-2B [arXiv:2403.08295]: GeGLU, head_dim=256, MQA (kv=1).

A copy of `repro.configs.gemma_2b`."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                         head_dim=32, d_ff=256, vocab=256)
