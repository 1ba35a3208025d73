"""Mamba2-370M [arXiv:2405.21060]: attention-free SSD (state-space
duality), chunked-scan prefill and O(1)-state decode.

A copy of `repro.configs.mamba2_370m`."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, d_ff=0,
    vocab=50280, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, vocab=256, ssm_state=16,
                         ssm_head_dim=16, ssm_chunk=16)
