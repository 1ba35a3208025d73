"""PyTorch/CUDA port of the OCP data cluster's vision path.

A second package beside the JAX reference `repro`: the volume lives on the
device as a Morton-ordered cuboid-major tensor per resolution level
(`core.store.DeviceCuboidStore`), every cutout is assembled by the
hand-written CUDA kernel `kernels.cutout_gather`, and the synapse detector
(`vision.synapse_detector`) runs as PyTorch ops on the same device.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
This package imports torch and numpy only.
"""
from .device import resolve_device  # noqa: F401
