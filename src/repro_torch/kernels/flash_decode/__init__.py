"""Port of `repro.kernels.flash_decode`: kernel.cu + ops.py + ref.py."""
from . import ops, ref  # noqa: F401
