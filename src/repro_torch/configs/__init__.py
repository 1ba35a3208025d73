"""Architecture registry of the port (``--arch <id>``).

The ids are the JAX package's; the port holds the configurations of the
archs whose model family it runs.  An arch in ``SMOKE_ONLY`` has its smoke
config in the port, but not its full one: the full model does not fit one
card.  Not yet ported: arctic-480b (its smoke config too) and the full
configs of llama3-405b and internvl2-76b; each raises NotImplementedError
naming ROADMAP A13 (sharding), which brings them.
"""
import importlib
from typing import List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "smollm_135m",
    "minitron_8b",
    "llama3_405b",
    "gemma_2b",
    "arctic_480b",
    "granite_moe_1b_a400m",
    "internvl2_76b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
    "mamba2_370m",
]

SUPPORTED = ("smollm_135m", "minitron_8b", "gemma_2b", "granite_moe_1b_a400m",
             "mamba2_370m", "recurrentgemma_2b", "seamless_m4t_medium")
SMOKE_ONLY = ("llama3_405b", "internvl2_76b")

_LATER = {
    "llama3_405b": "ROADMAP A13 (sharded dense models)",
    "internvl2_76b": "ROADMAP A13 (sharded dense models: 76B does not fit one card)",
    "arctic_480b": "ROADMAP A13 (sharded MoE models: 480B does not fit one card)",
}


def canonical(arch: str) -> str:
    a = arch.replace("-", "_")
    if a not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return a


def _module(arch: str, smoke: bool = False):
    a = canonical(arch)
    if a not in SUPPORTED and not (smoke and a in SMOKE_ONLY):
        what = ("the full model does not fit one card" if a in SMOKE_ONLY
                else "not in the port yet")
        raise NotImplementedError(f"{arch}: {what}; see {_LATER[a]}")
    return importlib.import_module(f".{a}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch, smoke=True).smoke()
