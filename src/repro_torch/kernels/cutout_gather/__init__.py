"""Port of `repro.kernels.cutout_gather`: kernel.cu + ops.py + ref.py."""
from . import ops, ref  # noqa: F401
