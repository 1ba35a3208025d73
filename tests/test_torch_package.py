"""The port stands alone: no JAX, no reference package, no silent CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT.rglob("*.py"))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 46
    assert {"repro_torch.optim.adamw", "repro_torch.optim.compression",
            "repro_torch.train.train_step", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.ft", "repro_torch.ft.supervisor"} <= set(MODULES)


def test_store_defaults_to_the_card():
    from repro_torch.core.annotations import AnnotationProject
    from repro_torch.core.cuboid import DatasetSpec
    from repro_torch.core.store import DeviceCuboidStore

    spec = DatasetSpec("d", (16, 16, 8), base_cuboid=(8, 8, 4))
    if torch.cuda.is_available():
        assert DeviceCuboidStore(spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceCuboidStore(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnnotationProject("a", spec)
    assert DeviceCuboidStore(spec, device="cpu").device.type == "cpu"


def test_detect_synapses_defaults_to_the_card():
    """A numpy volume goes to the card unless the caller names the CPU; a
    tensor stays on its own device."""
    import numpy as np

    from repro_torch.vision.synapse_detector import detect_synapses

    vol = np.full((8, 8, 4), 7.0, dtype=np.float32)
    if torch.cuda.is_available():
        assert detect_synapses(vol)[1].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            detect_synapses(vol)
    assert detect_synapses(vol, device="cpu")[1].device.type == "cpu"
    assert detect_synapses(torch.from_numpy(vol))[1].device.type == "cpu"


def test_lm_serving_defaults_to_the_card():
    """The LM, the batcher and the serve driver run on the card unless the
    caller names the CPU; without a card they raise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.serve import ContinuousBatcher

    for arch in ("smollm-135m", "mamba2-370m", "granite-moe-1b-a400m"):
        cfg = get_smoke_config(arch)
        if torch.cuda.is_available():
            assert LM(cfg).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LM(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", arch, "--smoke"])
        model = LM(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ContinuousBatcher(model, cfg, n_slots=2, cache_len=8)
        cache = ContinuousBatcher(model, cfg, n_slots=2, cache_len=8, device="cpu").cache
        assert all(t.device.type == "cpu" for t in cache["blocks"].values())


def test_kernel_build_flags_and_location():
    from repro_torch.kernels import _build

    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert _build.source_of("cutout_gather").exists()


def test_build_runs_one_compiler_per_source_and_reports_failures(tmp_path, monkeypatch):
    """`build` starts every compile before waiting; a failed source raises
    with the compiler's output and leaves no library, the others land."""
    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    log = tmp_path / "calls"
    fake.write_text("#!/bin/sh\n"   # each waits (up to 10 s) for the other to start
                    f"echo start >> {log}; i=0\n"
                    f'while [ $(grep -c start {log}) -lt 2 ] && [ $i -lt 100 ]; do '
                    'sleep 0.1; i=$((i+1)); done\n'
                    f'[ $(grep -c start {log}) -ge 2 ] || {{ echo "ran alone"; exit 1; }}\n'
                    'for a in "$@"; do case "$a" in *flash_decode*) echo "bad kernel"; exit 1;; esac; done\n'
                    'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    with pytest.raises(RuntimeError, match="(?s)flash_decode.*bad kernel"):
        _build.build(["flash_attention", "flash_decode"])
    assert log.read_text().count("start") == 2
    assert _build._target("flash_attention").exists()
    assert not _build._target("flash_decode").exists()
    _build.build(["flash_attention"])          # built before: no compile
    assert log.read_text().count("start") == 2



def test_build_target_hashes_every_included_header(tmp_path, monkeypatch):
    """Editing a header that a kernel includes (directly or through another
    header) renames the kernel's library, so it is rebuilt; `_target`
    needs no nvcc."""
    from repro_torch.kernels import _build

    kdir = tmp_path / "kernels"
    (kdir / "demo").mkdir(parents=True)
    (kdir / "demo" / "kernel.cu").write_text('#include "_common.cuh"\nint x;\n')
    (kdir / "_common.cuh").write_text('#pragma once\n#include "demo/local.cuh"\n')
    (kdir / "demo" / "local.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", kdir)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("_target ran nvcc"))
    assert _build.includes(_build.source_of("demo")) == [
        (kdir / "_common.cuh").resolve(), (kdir / "demo" / "local.cuh").resolve()]
    first = _build._target("demo")
    assert _build._target("demo") == first
    (kdir / "demo" / "local.cuh").write_text("// v2\n")
    second = _build._target("demo")
    assert second != first
    (kdir / "_common.cuh").write_text('#pragma once  \n#include "demo/local.cuh"\n')
    assert _build._target("demo") not in (first, second)
    (kdir / "_common.cuh").write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError, match="missing.cuh"):
        _build._target("demo")


def test_every_kernel_gets_the_shared_header_directory():
    """nvcc is told where the shared headers are, and the ones the port's
    kernels include exist there."""
    from repro_torch.kernels import _build

    assert _build.INCLUDE_FLAGS == ("-I", str(_build.KERNELS_DIR))
    for src in _build.KERNELS_DIR.glob("*/kernel.cu"):
        for header in _build.includes(src):
            assert header.is_relative_to(_build.KERNELS_DIR)
    assert (_build.KERNELS_DIR / "_hopper.cuh") in _build.includes(
        _build.source_of("morton_matmul"))

def test_build_timing_compiles_every_source_twice_into_fresh_dirs(
        tmp_path, monkeypatch, capsys):
    """`python -m repro_torch.kernels._build` times a sequential and a
    parallel cold build and leaves neither library behind."""
    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    log = tmp_path / "calls"
    fake.write_text(f"#!/bin/sh\necho start >> {log}\n"
                    'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.main() == 0
    n = len(list(_build.KERNELS_DIR.glob("*/kernel.cu")))
    assert log.read_text().count("start") == 2 * n
    out = capsys.readouterr().out
    assert "sequential:" in out and "parallel:" in out
    assert _build.BUILD_DIR == tmp_path / "build"
    assert list((tmp_path / "build").iterdir()) == []


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode"])
def test_attention_kernel_sources_have_a_c_entry(name):
    from repro_torch.kernels import _build

    src = _build.source_of(name).read_text()
    assert f'extern "C" int {name}_launch(' in src


def test_ssd_scan_binding_matches_its_c_entry():
    """The ctypes argument list declares as many arguments as the C entry
    point takes, and the wrapper passes that many."""
    import inspect
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops

    src = _build.source_of("ssd_scan").read_text()
    params = re.search(r'extern "C" int ssd_scan_launch\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(ops.ARGTYPES)
    tree = ast.parse(inspect.getsource(ops.ssd_scan_cuda))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "fn"]
    assert [len(c.args) for c in calls] == [len(ops.ARGTYPES)]


def test_moe_gemm_binding_matches_its_c_entry():
    """The ctypes argument list declares as many arguments as the C entry
    point takes, and the wrapper passes that many."""
    import inspect
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gemm import ops

    src = _build.source_of("moe_gemm").read_text()
    params = re.search(r'extern "C" int moe_gemm_launch\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(ops.ARGTYPES)
    tree = ast.parse(inspect.getsource(ops.moe_gemm_cuda))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "fn"]
    assert [len(c.args) for c in calls] == [len(ops.ARGTYPES)]


def test_morton_matmul_binding_matches_its_c_entry():
    """The ctypes argument list declares as many arguments as the C entry
    point takes, and the wrapper passes that many."""
    import inspect
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.morton_matmul import ops

    src = _build.source_of("morton_matmul").read_text()
    params = re.search(r'extern "C" int morton_matmul_launch\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(ops.ARGTYPES)
    tree = ast.parse(inspect.getsource(ops.morton_matmul_cuda))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "fn"]
    assert [len(c.args) for c in calls] == [len(ops.ARGTYPES)]


def test_moe_gemm_wrapper_never_reads_counts_on_the_host():
    """The dispatch and the kernel wrapper keep counts on the device: no
    host sync per layer (.item(), .tolist(), .cpu(), int(), bool masks)."""
    import inspect

    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.models import moe

    for fn in (ops._check, ops.moe_gemm_cuda, ops.moe_gemm, moe.dispatch, moe.combine,
               moe.moe):
        src = inspect.getsource(fn)
        for bad in (".item(", ".tolist(", ".cpu(", "int(counts", "nonzero"):
            assert bad not in src, (fn.__name__, bad)


def _smoke(*args):
    return subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


def test_chip_smoke_rehearsal_runs_on_cpu():
    """The smoke's main path and checks run end to end at a tiny size on the
    CPU (plain gather), and print no result line."""
    out = _smoke("--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"rehearsal"' in out.stdout and '"ok"' not in out.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without one")
    out = _smoke()
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
