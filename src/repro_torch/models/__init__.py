"""Model zoo of the port: the decoder LM, dense, MoE and ssm families
(`repro.models`)."""
from typing import Dict, Optional

import torch

from ..device import DeviceLike
from .config import ModelConfig
from .lm import LM
from .params import ParamSpec, count_params, init_params


def build_model(cfg: ModelConfig, params: Optional[Dict] = None, *,
                device: DeviceLike = "cuda",
                generator: Optional[torch.Generator] = None) -> LM:
    """The model of ``cfg`` (dense, MoE or ssm family)."""
    return LM(cfg, params, device=device, generator=generator)


__all__ = ["ModelConfig", "LM", "build_model", "ParamSpec", "count_params",
           "init_params"]
