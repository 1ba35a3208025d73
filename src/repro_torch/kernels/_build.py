"""Build the port's CUDA kernels from the repository's sources at first use.

Each kernel is one ``.cu`` file with a plain C entry point.  It is compiled
by ``nvcc`` into a shared library under ``build/repro_torch_ext/`` (listed
in ``.gitignore`` through ``build/``) and bound with ctypes: the wrapper
passes ``data_ptr()`` integers and PyTorch's current stream.  No PyTorch
header is included, so a build takes seconds rather than the minutes a
``torch/extension.h`` translation unit costs.

Libraries are keyed by a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is reused.  A failed build raises
with the compiler's output; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_libs_guard = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or CUDA_HOME); "
                       "the port's CUDA kernels cannot be built")


def source_of(name: str) -> pathlib.Path:
    return KERNELS_DIR / name / "kernel.cu"


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256(source_of(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(name: str) -> None:
    """Compile kernel ``name`` unless its library is already built."""
    target = _target(name)
    if target.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_of(name))]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source_of(name)}:\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, target)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    with _libs_guard:
        lib = _libs.get(name)
        if lib is None:
            _compile(name)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
