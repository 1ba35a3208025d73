"""Port of `repro.kernels.ssd_scan`: kernel.cu + ops.py + ref.py."""
from . import ops, ref  # noqa: F401
