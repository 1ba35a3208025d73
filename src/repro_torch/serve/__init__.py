"""LM serving of the port (`repro.serve`'s serving steps and batcher)."""
from .batcher import ContinuousBatcher, Request
from .serve_step import make_prefill_step, make_serve_step

__all__ = ["make_serve_step", "make_prefill_step", "ContinuousBatcher", "Request"]
