"""Model zoo of the port (`repro.models`): the decoder LM (dense, MoE,
hybrid and ssm families) and the encoder-decoder."""
from typing import Dict, Optional, Union

import torch

from ..device import DeviceLike
from .config import ModelConfig
from .encdec import EncDecLM, encdec_specs
from .lm import LM, lm_specs
from .params import ParamSpec, count_params, init_params


def model_specs(cfg: ModelConfig) -> dict:
    """The parameter specs of ``cfg``'s model, in the JAX package's tree."""
    return encdec_specs(cfg) if cfg.family == "encdec" else lm_specs(cfg)


def build_model(cfg: ModelConfig, params: Optional[Dict] = None, *,
                device: DeviceLike = "cuda",
                generator: Optional[torch.Generator] = None) -> Union[LM, EncDecLM]:
    """The model of ``cfg``: `EncDecLM` for the encoder-decoder family,
    `LM` for the others."""
    cls = EncDecLM if cfg.family == "encdec" else LM
    return cls(cfg, params, device=device, generator=generator)


__all__ = ["ModelConfig", "LM", "EncDecLM", "build_model", "model_specs", "ParamSpec",
           "count_params", "init_params"]
