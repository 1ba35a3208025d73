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
    assert len(MODULES) >= 53
    assert {"repro_torch.optim.adamw", "repro_torch.optim.compression",
            "repro_torch.train.train_step", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.ft", "repro_torch.ft.supervisor", "repro_torch.cluster.router",
            "repro_torch.cluster.deadline", "repro_torch.cluster.store",
            "repro_torch.cluster.handlers", "repro_torch.cluster.api",
            "repro_torch.serve.http_front", "repro_torch.serve.client"} <= set(MODULES)


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


def test_front_door_defaults_to_the_card(monkeypatch, capsys):
    """``python -m repro_torch.serve.http_front`` serves from the card
    unless ``--device cpu`` is given; without a card it raises."""
    from repro_torch.serve import http_front

    if torch.cuda.is_available():
        assert http_front.demo_service(size=32).datasets["demo"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        http_front.main(["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        http_front.demo_service(size=32)

    def interrupted():
        raise KeyboardInterrupt  # what Ctrl-C does to the serving loop

    monkeypatch.setattr(http_front, "_block_until_interrupted", interrupted)
    http_front.main(["--port", "0", "--device", "cpu", "--deadline-ms", "500", "--nodes", "2"])
    assert "dataset 'demo' on cpu" in capsys.readouterr().out


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


# every C entry of the kernels: (kernel, entry, the ops function that calls it)
C_ENTRIES = [
    ("cutout_gather", "cutout_gather_launch", "cutout_gather_cuda"),
    ("flash_attention", "flash_attention_launch", "flash_attention_cuda"),
    ("flash_attention", "attn_grad_launch", "flash_attention_grad_cuda"),
    ("flash_decode", "flash_decode_launch", "flash_decode_cuda"),
    ("flash_decode", "flash_decode_stages", "kernel_stages"),
    ("moe_gemm", "moe_gemm_launch", "moe_gemm_cuda"),
    ("moe_gemm", "moe_gemm_grad_launch", "moe_gemm_grad_cuda"),
    ("moe_gemm", "moe_gemm_tiles", "kernel_tiles"),
    ("morton_matmul", "morton_matmul_launch", "morton_matmul_cuda"),
    ("morton_matmul", "morton_matmul_blocks_per_sm", "blocks_per_sm"),
    ("ssd_scan", "ssd_scan_launch", "ssd_scan_cuda"),
    ("ssd_scan", "ssd_scan_tc_plan", "kernel_tc_plan"),
]


def _starred_args(ops, name):
    """The tuple of argument function ``name`` (the wrapper passes it
    starred), made here from CPU tensors, with the values it must carry."""
    if name == "grad_args":  # flash_attention's gradient
        q, out, dout, dq = (torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16) for _ in range(4))
        k, v, dk, dv = (torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16) for _ in range(4))
        lse, delta = torch.zeros(2, 4, 16), torch.zeros(2, 4, 16)
        args = ops.grad_args(q, k, v, out, dout, lse, delta, dq, dk, dv, scale=0.125, window=8)
        assert args[10:15] == (2, 16, 2, 2, 64) and args[-2:] == (8, 0.125)
    elif ops.NAME == "flash_attention":
        q, out = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16), torch.zeros(2, 16, 4, 64)
        k = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
        lse = torch.zeros(2, 4, 16)
        args = ops.launch_args(q, k, k, out, lse, causal=True, scale=0.125, window=None)
        assert args[4] == lse.data_ptr() and args[5:11] == (2, 16, 16, 2, 2, 64)
        plain = ops.launch_args(q, k, k, out, None, causal=True, scale=0.125, window=None)
        assert plain[4] is None and plain[5:] == args[5:]
    else:  # flash_decode's launch
        q, kc = torch.zeros(2, 1, 4, 64), torch.zeros(2, 32, 2, 64)
        lens = torch.ones(2, dtype=torch.int32)
        args = ops.launch_args(q, kc, kc, lens, torch.zeros_like(q), 2, 0.125)
        assert args[8:13] == (2, 32, 2, 2, 64) and args[-3:] == (2, 0.125, 0)
    return args


def _entry_call(ops, wrapper, entry):
    """(argtypes, the arguments ``wrapper`` passes C entry ``entry``, whether
    it adds the stream): the entry is bound once with `_build.entry` and
    called through `_build.launch` (a kernel, which adds the current stream)
    or directly (a query)."""
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(ops, wrapper))))

    def build_call(node, name):
        return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == name and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_build")

    (bind,) = [n for n in ast.walk(tree) if build_call(n, "entry")
               and isinstance(n.args[1], ast.Constant) and n.args[1].value == entry]
    names = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign) and n.value is bind
             for t in n.targets}

    def is_fn(node):
        return node is bind or (isinstance(node, ast.Name) and node.id in names)

    calls = ([(n.args[2:], True) for n in ast.walk(tree)
              if build_call(n, "launch") and is_fn(n.args[0])]
             + [(n.args, False) for n in ast.walk(tree)
                if isinstance(n, ast.Call) and is_fn(n.func)])
    ((args, stream),) = calls
    passed = 0
    for a in args:
        if isinstance(a, ast.Starred):
            passed += len(_starred_args(ops, a.value.func.id))
        else:
            passed += 1
    return getattr(ops, bind.args[2].id), passed, stream


def test_every_c_entry_has_a_binding_case():
    import re

    from repro_torch.kernels import _build

    entries = {e for src in _build.KERNELS_DIR.glob("*/kernel.cu")
               for e in re.findall(r'extern "C" int (\w+)\(', src.read_text())}
    assert entries == {e for _, e, _ in C_ENTRIES}


@pytest.mark.parametrize("kernel,entry,wrapper", C_ENTRIES, ids=[e for _, e, _ in C_ENTRIES])
def test_binding_matches_its_c_entry(kernel, entry, wrapper):
    """The ctypes argument list declares each parameter of the C entry, a
    pointer, a 64-bit integer, an int or a float in its place; and the
    wrapper passes that many arguments, less the stream that
    `_build.launch` adds."""
    import ctypes
    import importlib
    import re

    from repro_torch.kernels import _build

    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    src = _build.source_of(kernel).read_text()
    params = [p.strip() for p in
              re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")]
    argtypes, passed, stream = _entry_call(ops, wrapper, entry)
    assert len(argtypes) == len(params)
    for param, t in zip(params, argtypes):
        if "*" in param:
            assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), (param, t)
        else:
            kind = param.split()[0]
            assert t is {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
                         "float": ctypes.c_float}[kind], (param, t)
    assert stream == params[-1].endswith("stream")
    assert passed == len(params) - stream


def test_moe_gemm_wrapper_never_reads_counts_on_the_host():
    """The dispatch and the kernel wrapper keep counts on the device: no
    host sync per layer (.item(), .tolist(), .cpu(), int(), bool masks)."""
    import inspect

    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.models import moe

    for fn in (ops._check, ops.moe_gemm_cuda, ops.moe_gemm_grad_cuda, ops.MoeGemm.backward,
               ops.moe_gemm, moe.dispatch, moe.combine, moe.moe):
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
