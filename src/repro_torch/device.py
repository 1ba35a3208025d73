"""Device resolution: the card unless the caller asks for the CPU.

There is no silent fallback.  ``"cuda"`` (the default everywhere in the
port) without an available card raises; the CPU is used only when the
caller names it, as the parity tests do.

On the card, TF32 is switched off for matmul and cuDNN.  cuDNN's TF32 is
on by default in PyTorch; a float32 convolution in TF32 keeps about three
decimal digits, which moves a difference-of-Gaussians response by ~1e-3
relative — enough to flip voxels at the detection threshold against the
full-fp32 reference.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return the torch device for ``device`` or raise if it is unusable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # "cuda" and "cuda:0" name one card
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
