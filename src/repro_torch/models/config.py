"""Model configuration: a copy of `repro.models.config` (`ModelConfig`,
`ShapeConfig`, `SHAPES`).

The XLA and TPU knobs have no meaning here and are left out
(`use_flash_kernel`, `use_flash_decode`, `use_ssd_kernel`, `attn_unroll`,
`attn_block_q`/`attn_block_kv`, `scan_layers`): the route is fixed
by the device, a CUDA tensor going through the hand-written kernels and a
CPU tensor through their plain versions.  ``moe_dispatch`` is kept:
``"local"`` dispatches each data-parallel group's tokens into its own
capacity buffer under an active sharding plan (`models.moe`), and falls
back to the one global dispatch (``"gspmd"``) without one.
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

    remat: str = "block"             # none | block | dots (`layers.maybe_remat`)
    fused_prefill_kv: bool = False   # build the decode cache from the forward
                                     # pass's K/V (no second projection)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    router_aux_coef: float = 0.01
    moe_dispatch: str = "gspmd"       # gspmd | local (a dispatch per
                                      # data-parallel group, `models.moe`)

    # --- hybrid (recurrentgemma / griffin) ---
    # layer pattern: 'R' = RG-LRU recurrent block, 'A' = local attention
    hybrid_pattern: str = "RRA"
    local_window: int = 2048
    d_rnn: int = 0                   # RG-LRU width (griffin: ~4/3 d_model)
    conv_width: int = 4              # hybrid and ssm

    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | patch_stub | frame_stub
    n_frontend_tokens: int = 256     # patches/frames provided by the stub

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "hybrid" and not self.d_rnn:
            object.__setattr__(self, "d_rnn", self.d_model)
        if self.family == "encdec" and not self.n_enc_layers:
            object.__setattr__(self, "n_enc_layers", self.n_layers)
            object.__setattr__(self, "n_dec_layers", self.n_layers)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:        # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context?  (Its cache and its step
        are O(1) or O(window) in the sequence.)"""
        return self.family in ("ssm", "hybrid")

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
