"""Llama-3.1-405B [arXiv:2407.21783]: dense GQA, 128k vocab.

A copy of `repro.configs.llama3_405b`.  `smoke()` runs in the port; the
full model does not fit one card: `get_config` refuses it, and
`get_config(..., abstract=True)` hands it to the dry run (`launch.dryrun`)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab=128256, act="swiglu", tie_embeddings=False, rope_theta=500000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
                         head_dim=16, d_ff=384, vocab=512)
