"""Build the port's CUDA kernels from the repository's sources at first use.

Each kernel is one ``.cu`` file with a plain C entry point.  It is compiled
by ``nvcc`` into a shared library under ``build/repro_torch_ext/`` (listed
in ``.gitignore`` through ``build/``) and bound with ctypes (`entry`): the
wrapper passes ``data_ptr()`` integers and PyTorch's current stream
(`launch`), and every C entry returns a ``cudaError_t`` (`check`).  No PyTorch
header is included, so a build takes seconds rather than the minutes a
``torch/extension.h`` translation unit costs.

Libraries are keyed by a hash of the source, of every header it includes
with ``#include "..."`` (found beside the source or in this directory,
which nvcc gets as ``-I``; `includes`), and of the flags, so an edited
kernel or header is rebuilt and an unchanged one is reused.  `build`
compiles several sources at once, one ``nvcc`` each.  A failed build raises with the
compiler's output; nothing falls back to another implementation.

    python -m repro_torch.kernels._build     # on a machine with nvcc

times a cold build of every kernel, one source after another and then all
at once, each into a fresh directory under ``build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, Iterable, List, Tuple

import torch

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

INCLUDE_FLAGS = ("-I", str(KERNELS_DIR))  # for the shared headers (_hopper.cuh)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_libs: Dict[str, ctypes.CDLL] = {}
_libs_guard = threading.Lock()
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


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


def includes(src: pathlib.Path) -> List[pathlib.Path]:
    """The headers ``src`` includes with ``#include "..."``, and theirs, in
    the order first met; each is looked up beside its includer, then in
    the kernels' directory (nvcc's ``-I``)."""
    found: List[pathlib.Path] = []
    todo = [src]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_text()):
            for base in (cur.parent, KERNELS_DIR):
                path = (base / name).resolve()
                if path.exists():
                    if path not in found:
                        found.append(path)
                        todo.append(path)
                    break
            else:
                raise FileNotFoundError(f"{cur} includes {name!r}, which is not in "
                                        f"{cur.parent} or {KERNELS_DIR}")
    return found


def _target(name: str) -> pathlib.Path:
    src = source_of(name)
    h = hashlib.sha256(src.read_bytes())
    for header in includes(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(names: Iterable[str]) -> None:
    """Compile the kernels among ``names`` whose library is not built yet,
    all at once, and wait for every one."""
    started = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *INCLUDE_FLAGS, "-o", str(tmp),
               str(source_of(name))]
        started.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in started:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source_of(name)}:\n"
                          f"{out.decode(errors='replace')}")
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names: Iterable[str]) -> None:
    """Compile and load the named kernels, one ``nvcc`` per source in
    parallel."""
    with _libs_guard:
        todo = list(dict.fromkeys(n for n in names if n not in _libs))
        _compile(todo)
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_target(n)))


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    build([name])
    return _libs[name]


def entry(kernel: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of kernel ``kernel``'s library, typed once with
    ``argtypes`` and an int return (untyped ctypes would cut pointers to 32
    bits) and kept for later calls."""
    fn = _entries.get((kernel, name))
    if fn is None:
        fn = getattr(library(kernel), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[kernel, name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (non-zero)."""
    if err != 0:
        raise RuntimeError(f"{what} failed (cudaError {err})")


def launch(fn, device: torch.device, *args, what: str) -> None:
    """``fn(*args, stream)`` with ``device``'s current stream, under
    ``torch.cuda.device(device)``; raises if the launch failed."""
    with torch.cuda.device(device):
        check(fn(*args, torch.cuda.current_stream(device).cuda_stream), what)


def main() -> int:
    global BUILD_DIR
    names = sorted(p.parent.name for p in KERNELS_DIR.glob("*/kernel.cu"))
    base = BUILD_DIR
    for mode in ("sequential", "parallel"):
        BUILD_DIR = base / f"timing-{mode}"
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        for group in ([[n] for n in names] if mode == "sequential" else [names]):
            _compile(group)
        print(f"cold build of {names}, {mode}: {time.perf_counter() - t0:.2f} s",
              flush=True)
        shutil.rmtree(BUILD_DIR)
    BUILD_DIR = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
