"""Minitron-8B [arXiv:2407.14679]: width-pruned Nemotron-4, dense GQA.

A copy of `repro.configs.minitron_8b`."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab=256000, act="swiglu", tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=192, vocab=256)
