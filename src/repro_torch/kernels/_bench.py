"""What the kernels' timing tools (`<kernel>/bench.py`) share: the card's
name and power limit, a build of one source with the compiler's register
and spill report, a count of instructions in the built library's SASS,
a timer by CUDA events and one of the host's time to enqueue a call."""
from __future__ import annotations

import pathlib
import re
import shutil
import statistics
import subprocess
import time
from typing import Dict, Iterable

import torch

from . import _build


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def compile_with_report(src: pathlib.Path, out: pathlib.Path) -> str:
    """Build ``src`` into ``out`` with the kernels' flags and return
    ptxas's register and spill report."""
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *_build.INCLUDE_FLAGS,
                        "-Xptxas", "-v", "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    lines = [line.strip() for line in r.stderr.splitlines()
             if "entry function" in line or "registers" in line or "spill" in line]
    return _demangle("\n".join(lines))


def _tool(name: str) -> str:
    """A CUDA toolkit program beside nvcc."""
    return str(pathlib.Path(_build._nvcc()).parent / name)


def _demangle(text: str) -> str:
    filt = shutil.which("c++filt") or _tool("cu++filt")
    try:
        return subprocess.run([filt], input=text, capture_output=True, text=True,
                              check=True).stdout.rstrip("\n")
    except (OSError, subprocess.CalledProcessError):
        return text


def sass_counts(lib: pathlib.Path, opcodes: Iterable[str]) -> Dict[str, int]:
    """How many instructions of each opcode (``HGMMA``, ``HMMA``, ...) the
    SASS of the built library ``lib`` holds, by ``cuobjdump -sass``."""
    r = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                       text=True, check=True)
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     r.stdout, re.M)
    return {op: sum(o == op for o in ops) for op in opcodes}


def event_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` calls, after a
    warm-up, with the calls queued behind a device-side sleep so that host
    launch gaps do not count."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(fn, calls: int = 200) -> float:
    """Mean host time in us to enqueue one call of ``fn`` (no synchronise
    between calls), after a warm-up: what a host-bound caller pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6
