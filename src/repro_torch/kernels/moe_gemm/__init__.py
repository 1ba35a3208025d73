"""Port of `repro.kernels.moe_gemm`: kernel.cu + ops.py + ref.py."""
from . import ops, ref  # noqa: F401
