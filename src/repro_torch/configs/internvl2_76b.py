"""InternVL2-Llama3-76B [arXiv:2404.16821] -- VLM; the LM backbone is a
dense llama3-70B-class decoder.  The InternViT frontend is a stub:
precomputed patch embeddings are prepended to the token sequence
(`LM.forward`'s ``embeds``).

A copy of `repro.configs.internvl2_76b`.  `smoke()` runs in the port; the
full model does not fit one card: `get_config` refuses it, and
`get_config(..., abstract=True)` hands it to the dry run (`launch.dryrun`)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, act="swiglu", tie_embeddings=False,
    frontend="patch_stub", n_frontend_tokens=256,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=192, vocab=256,
                         n_frontend_tokens=8)
