"""Architecture registry of the port (``--arch <id>``).

The ids are the JAX package's; the port holds the configurations of the
archs whose model family it runs.  An arch in ``SMOKE_ONLY`` has its smoke
config in the port, but not its full one: the full model does not fit one
card (llama3-405b, internvl2-76b, arctic-480b).  `get_config` refuses
those full configs with NotImplementedError; ``get_config(arch,
abstract=True)`` returns them for what only reads their shapes: the
sharding rules and the dry run on the production meshes
(`launch.dryrun`), which allocate nothing on a card.
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
SMOKE_ONLY = ("llama3_405b", "internvl2_76b", "arctic_480b")

_LATER = {
    "llama3_405b": "ROADMAP A13: `launch.dryrun` reports it (405B parameters)",
    "internvl2_76b": "ROADMAP A13: `launch.dryrun` reports it (76B parameters)",
    "arctic_480b": "ROADMAP A13: `launch.dryrun` reports it (480B parameters)",
}


def canonical(arch: str) -> str:
    a = arch.replace("-", "_")
    if a not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return a


def _module(arch: str, smoke: bool = False):
    a = canonical(arch)
    if a in SMOKE_ONLY and not smoke:
        raise NotImplementedError(
            f"{arch}: the full model does not fit one card; see {_LATER[a]}")
    return importlib.import_module(f".{a}", __package__)


def get_config(arch: str, abstract: bool = False) -> ModelConfig:
    """``arch``'s full config.  Those of `SMOKE_ONLY` raise unless
    ``abstract``: a caller that only reads shapes (the sharding rules, the
    dry run) asks for them so, and must not allocate them on a card."""
    return _module(arch, smoke=abstract).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch, smoke=True).smoke()
