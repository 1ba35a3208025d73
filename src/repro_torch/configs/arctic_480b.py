"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base] -- 128-expert top-2
MoE with a dense residual MLP in parallel (dense-MoE hybrid).

A copy of `repro.configs.arctic_480b`.  `smoke()` runs in the port; the
full model (480B parameters) does not fit one card: `get_config` refuses
it, and `get_config(..., abstract=True)` hands it to the dry run
(`launch.dryrun`), which costs it on the production meshes."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, act="swiglu", tie_embeddings=False,
    n_experts=128, top_k=2, moe_dense_residual=True,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=96, vocab=256, n_experts=8,
                         top_k=2)
