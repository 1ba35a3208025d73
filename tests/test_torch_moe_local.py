"""Port parity: the MoE's sharded dispatches, the local one
(``moe_dispatch="local"``) against the JAX package's.

JAX runs its ``local`` mode on 4 host devices in a subprocess
(tests/test_moe_local.py's script: a 2 x 2 ("data", "model") mesh, the
tokens sharded over ``data``).  The port runs its local dispatch, the one
a sharded step runs (`models.moe._moe_sharded`), on DTensors over four
gloo ranks in spawned processes that form a 2 x 2 ("data", "model") mesh
(tests/torch_spmd_worker.py), on the same weights and tokens: outputs and
aux loss within 1e-5 (fp32; the sums run in another order).  At capacity
factor 2.0 nothing drops; at 1.0 picks drop, and each rank's dispatch
keeps the (token, expert) pairs of JAX's dispatch rule applied to its
data-parallel group's tokens.

The ``gspmd`` mode on DTensors dispatches each device's tokens into a
buffer of that device's capacity; at capacity factor 1.0 its outputs and
kept pairs equal the plain dispatch of each device's tokens alone, and
its aux loss the loss over all the tokens.  On plain tensors the local
mode is the global dispatch, bit for bit, plan or no plan.
"""
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_spmd_worker as worker
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.train.sharding import make_plan, use_plan
from torch_fake_world import ShapeMesh

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models.config import ModelConfig
from repro.models.moe import moe, moe_specs, _capacity
from repro.models.params import init_params
from repro.train.sharding import make_plan, use_plan

cap = float(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                  n_kv_heads=2, d_ff=16, vocab=64, n_experts=4, top_k=2,
                  capacity_factor=cap, dtype="float32", moe_dispatch="local")
params = init_params(moe_specs(cfg), jax.random.key(0))
x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 8, 32)), jnp.float32)
with mesh, use_plan(make_plan(mesh)):
    xs = jax.device_put(x, NamedSharding(mesh, P(("data",), None, None)))
    out, aux = jax.jit(lambda p, x: moe(p, cfg, x))(params, xs)
# JAX's dispatch rule (repro/models/moe.py `_moe_tokens`) on each group's
# tokens: the kept (token, expert) picks
kept = []
for xl in np.asarray(x).reshape(2, 16, 32):
    xl = jnp.asarray(xl)
    T, k, E = xl.shape[0], cfg.top_k, cfg.n_experts
    probs = jax.nn.softmax(xl @ params["w_router"], axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    flat = ids.reshape(T * k)
    order = jnp.argsort(flat)
    sid = flat[order]
    counts = jnp.zeros((E,), jnp.int32).at[sid].add(1)
    pos = jnp.arange(T * k) - (jnp.cumsum(counts) - counts)[sid]
    keep = np.asarray(pos < _capacity(cfg, T))
    kept.append(np.stack([np.asarray(order // k)[keep], np.asarray(sid)[keep]], 1))
np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux), x=np.asarray(x),
         kept0=kept[0], kept1=kept[1],
         **{k: np.asarray(v) for k, v in params.items()})
print("OK")
"""


def jax_local(cap, out_dir):
    path = out_dir / f"jax_{cap}.npz"
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(cap), str(path)],
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    return path


def cfg_dict(cap, dispatch):
    return dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=16, vocab=64, n_experts=4, top_k=2,
                capacity_factor=cap, dtype="float32", moe_dispatch=dispatch)


def port_cfg(cap, dispatch="local"):
    return ModelConfig(**cfg_dict(cap, dispatch))


def seeded_layer(path):
    """Weights and tokens of the gspmd case, from a numpy seed."""
    rng = np.random.default_rng(3)
    arrays = {"w_router": rng.normal(size=(32, 4)), "w_gate": rng.normal(size=(4, 32, 16)) * 0.2,
              "w_up": rng.normal(size=(4, 32, 16)) * 0.2,
              "w_down": rng.normal(size=(4, 16, 32)) * 0.2, "x": rng.normal(size=(4, 8, 32))}
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one world of four ranks: (JAX's arrays by case, each
    rank's results)."""
    out = tmp_path_factory.mktemp("moe_local")
    data = {f"local_{cap}": jax_local(cap, out) for cap in (2.0, 1.0)}
    data["gspmd_1.0"] = seeded_layer(out / "gspmd.npz")
    cases = [dict(name=name, kind="moe", data=str(path),
                  cfg=cfg_dict(float(name.split("_")[1]), name.split("_")[0]))
             for name, path in data.items()]
    return {k: dict(np.load(v)) for k, v in data.items()}, worker.spawn(cases, out)


def as_set(pairs):
    return {tuple(map(int, r)) for r in pairs}


@pytest.mark.parametrize("cap", [2.0, 1.0])
def test_local_dispatch_matches_jax(world, cap):
    jax_arrays, ranks = world
    j, name = jax_arrays[f"local_{cap}"], f"local_{cap}"
    dropped = 0
    for res in ranks:
        assert f"{name}/error" not in res, str(res[f"{name}/error"])
        np.testing.assert_allclose(res[f"{name}/shd/moe.out"], j["out"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res[f"{name}/shd/moe.aux"], j["aux"], atol=TOL, rtol=TOL)
        assert int(res[f"{name}/shd/n_dispatches"]) == 1  # one a device, its group's
        group = int(res["coordinate"][0])                 # its ``data`` coordinate
        kept = res[f"{name}/shd/kept0"]
        assert as_set(kept) == as_set(j[f"kept{group}"]), group
        dropped += 16 * 2 - len(kept)
    assert (dropped == 0) == (cap == 2.0), dropped


def test_gspmd_sharded_dispatch_is_each_devices_own(world):
    """At capacity factor 1.0 (picks drop): the batch is split over both
    mesh dims (``data`` major), each device dispatches its own 8 tokens."""
    jax_arrays, ranks = world
    a = {k: torch.from_numpy(v) for k, v in jax_arrays["gspmd_1.0"].items()}
    cfg = port_cfg(1.0, "gspmd")
    p = SimpleNamespace(**{k: a[k] for k in ("w_router", "w_gate", "w_up", "w_down")})
    disps, outs = [], []
    for xg in a["x"]:                                  # one batch row a device
        disp = moe_mod.dispatch(p, cfg, xg)
        disps.append(disp)
        outs.append(moe_mod.combine(moe_mod.moe_gemm(disp.grouped, p.w_gate, p.w_up,
                                                     p.w_down, disp.counts), disp))
    me = torch.stack([d.me for d in disps]).mean(0)
    ce = torch.stack([d.ce for d in disps]).mean(0)
    aux = cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce)
    n_kept = 0
    for res in ranks:
        assert "gspmd_1.0/error" not in res, str(res["gspmd_1.0/error"])
        np.testing.assert_allclose(res["gspmd_1.0/shd/moe.out"],
                                   torch.stack(outs).numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res["gspmd_1.0/shd/moe.aux"], aux.numpy(),
                                   atol=TOL, rtol=TOL)
        d, m = map(int, res["coordinate"])
        disp = disps[2 * d + m]
        tok = torch.arange(8)[:, None].expand_as(disp.expert_ids)
        want = torch.stack([tok[disp.keep], disp.expert_ids[disp.keep]], 1).numpy()
        assert as_set(res["gspmd_1.0/shd/kept0"]) == as_set(want)
        n_kept += len(want)
    assert n_kept < 4 * 8 * 2                         # picks dropped
    # one global dispatch would keep other picks, at another capacity
    assert moe_mod.capacity(cfg, 8) != moe_mod.capacity(cfg, 32)


def test_local_without_a_plan_is_the_global_dispatch_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    p = SimpleNamespace(w_router=torch.randn(32, 4, generator=gen),
                        w_gate=torch.randn(4, 32, 16, generator=gen) * 0.2,
                        w_up=torch.randn(4, 32, 16, generator=gen) * 0.2,
                        w_down=torch.randn(4, 16, 32, generator=gen) * 0.2)
    x = torch.randn(4, 8, 32, generator=gen)
    for cap in (2.0, 1.0):
        a, aux_a = moe_mod.moe(p, port_cfg(cap, "local"), x)
        b, aux_b = moe_mod.moe(p, port_cfg(cap, "gspmd"), x)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
        # plain tensors under a plan take the one dispatch too
        for shape in ({"data": 1, "model": 4}, {"data": 2, "model": 2}):
            with use_plan(make_plan(ShapeMesh(shape))):
                c, aux_c = moe_mod.moe(p, port_cfg(cap, "local"), x)
            assert torch.equal(a, c) and torch.equal(aux_a, aux_c)
