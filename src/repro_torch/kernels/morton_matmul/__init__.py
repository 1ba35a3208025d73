"""Port of `repro.kernels.morton_matmul`: kernel.cu + ops.py + ref.py."""
from . import ops, ref  # noqa: F401
