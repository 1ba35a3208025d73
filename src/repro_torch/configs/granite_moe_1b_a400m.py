"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32-expert top-8 fine-grained MoE.

A copy of `repro.configs.granite_moe_1b_a400m`."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, act="swiglu", tie_embeddings=True,
    n_experts=32, top_k=8,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=64, vocab=256, n_experts=8,
                         top_k=4)
