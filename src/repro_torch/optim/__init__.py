"""Optimizer of the port (`repro.optim`): AdamW with fp32 masters and
gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_init_specs, adamw_update,
                    cosine_schedule, global_norm)
from .compression import compress_grads, decompress_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_init_specs", "adamw_update", "cosine_schedule",
           "global_norm", "compress_grads", "decompress_grads"]
