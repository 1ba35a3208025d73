"""What the kernels' timing tools (`<kernel>/bench.py`) share: the card's
name and power limit, a build of one source with the compiler's register
and spill report, and a timer by CUDA events."""
from __future__ import annotations

import pathlib
import statistics
import subprocess

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
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(out), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    return "\n".join(line.strip() for line in r.stderr.splitlines()
                     if "registers" in line or "spill" in line)


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
