"""Model configuration: a copy of `repro.models.config.ModelConfig`.

The XLA and TPU knobs have no meaning here and are left out
(`use_flash_kernel`, `use_flash_decode`, `use_ssd_kernel`, `attn_unroll`,
`attn_block_q`/`attn_block_kv`, `remat`, `scan_layers`): the route is fixed
by the device, a CUDA tensor going through the hand-written kernels and a
CPU tensor through their plain versions.  Only the fields of the dense,
MoE and ssm families are kept; the hybrid and encoder-decoder fields come
with the slices that run those families (ROADMAP A10).  ``moe_dispatch``
is left out: its ``"local"`` mode is a vmap over a data-parallel mesh axis
and falls back to the one global dispatch without a sharding plan, which
is what the port always does (sharding is ROADMAP A13).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free (ssm)
    n_kv_heads: int = 0              # GQA groups; == n_heads -> MHA; 1 -> MQA
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    act: str = "swiglu"              # swiglu | geglu
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    fused_prefill_kv: bool = False   # build the decode cache from the forward
                                     # pass's K/V (no second projection)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    router_aux_coef: float = 0.01

    # --- ssm (mamba2 / SSD) ---
    conv_width: int = 4
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:        # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)
