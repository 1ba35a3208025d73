"""Port of `repro.kernels.flash_attention`: kernel.cu + ops.py + ref.py."""
from . import ops, ref  # noqa: F401
