"""Port parity: checkpoints (`repro_torch.ckpt`), the training supervisor
(`repro_torch.ft`) and the training driver's checkpoint/restart path
against the JAX package.

The on-disk format is shared: a checkpoint the JAX package wrote restores
in the port, and one the port wrote restores in the JAX package, bit for
bit, bfloat16 leaves included (the JAX side reads them as ml_dtypes'
bfloat16, the port through a 16-bit view).  A supervised run with an
injected failure replays from its last checkpoint (or from step 0) and
ends bit-equal to an uninterrupted run: the CPU step is deterministic and
batches are addressed by step.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore
from repro.ckpt import save_checkpoint as j_save
from repro.ft import FailureInjector as JFailureInjector
from repro.ft import StragglerMonitor as JStragglerMonitor
from repro.ft import TrainingSupervisor as JTrainingSupervisor
from repro.launch import train as j_train
from repro_torch.carry import (lm_params_to_numpy, train_state_from_tree,
                               train_state_to_tree)
from repro_torch.ckpt import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs import get_smoke_config
from repro_torch.ft import (FailureInjector, StragglerMonitor, TrainingSupervisor,
                            WorkerFailure)
from repro_torch.launch import train
from repro_torch.models.params import tree_leaves, tree_map


def np_tree(seed=0, big=False):
    """A JAX-style numpy tree: fp32, bf16 (ml_dtypes), int32, a scalar, and
    optionally a leaf of three 4 MiB chunks and a bit."""
    rng = np.random.default_rng(seed)
    tree = {"params": {"w": rng.normal(size=(17, 5)).astype(np.float32),
                       "emb": rng.normal(size=(33, 8)).astype(ml_dtypes.bfloat16),
                       "blocks": {"ln": rng.normal(size=(2, 8)).astype(ml_dtypes.bfloat16)}},
            "opt": {"step": np.array(7, np.int32),
                    "ids": rng.integers(-9, 9, size=(4, 3)).astype(np.int32)}}
    if big:
        tree["params"]["big"] = rng.normal(size=(5 << 20) // 2 + 3).astype(ml_dtypes.bfloat16)
    return tree


def torch_of(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x):
    """Raw bytes and dtype name of a numpy array or tensor."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16", tuple(x.shape)
        x = x.numpy()
    return np.ascontiguousarray(x).tobytes(), x.dtype.name, tuple(x.shape)


def assert_same_bits(got, want):
    got_l, want_l = tree_leaves(got), tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert bits(g) == bits(w)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("big", [False, True])
def test_jax_checkpoint_restores_in_the_port(tmp_path, compress, big):
    tree = np_tree(big=big)
    j_save(str(tmp_path), 3, tree, compress=compress)
    step, got = restore_checkpoint(str(tmp_path))
    assert step == 3
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 7
    assert_same_bits(got, tree)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("big", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, compress, big):
    want = np_tree(seed=1, big=big)
    save_checkpoint(str(tmp_path), 5, tree_map(torch_of, want), compress=compress)
    step, got = j_restore(str(tmp_path))
    assert step == 5
    assert got["params"]["emb"].dtype == ml_dtypes.bfloat16
    assert_same_bits(got, want)
    # the same files as the JAX package writes, chunk for chunk
    j_save(str(tmp_path / "j"), 5, want, compress=compress)
    ours, theirs = tmp_path / "step_00000005", tmp_path / "j" / "step_00000005"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert (json.loads((ours / "manifest.json").read_text())
            == json.loads((theirs / "manifest.json").read_text()))
    for name in os.listdir(theirs):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_sharded_restore_matches_jax_and_covers_the_leaf(tmp_path, n_hosts):
    """``shard_info``: each host reads its curve segment of each leaf's
    chunk list, zeros elsewhere, as the JAX restore does; the segments are
    disjoint and cover the leaf."""
    tree = np_tree(seed=2, big=True)
    j_save(str(tmp_path), 1, tree)
    acc = np.zeros(tree["params"]["big"].shape, np.float32)
    for h in range(n_hosts):
        _, got = restore_checkpoint(str(tmp_path), shard_info=(h, n_hosts))
        _, want = j_restore(str(tmp_path), shard_info=(h, n_hosts))
        assert_same_bits(got, want)
        acc += got["params"]["big"].float().numpy()
    np.testing.assert_array_equal(acc, tree["params"]["big"].astype(np.float32))


def test_uncommitted_checkpoint_is_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    os.makedirs(tmp_path / ".tmp_step_00000002")
    step, got = restore_checkpoint(str(tmp_path))
    assert step == 1 and torch.equal(got["w"], torch.ones(3))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / ".tmp_step_00000002"))


def test_manager_snapshots_on_the_callers_thread_and_keeps_the_newest(tmp_path):
    """`save_async` copies the tree before returning: an in-place update
    after it does not reach the checkpoint.  `wait` returns when all are
    committed; ``keep`` 2 leaves the newest two."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros(1000)
    for s in (1, 2, 3, 4):
        w.fill_(s)
        mgr.save_async(s, {"w": w, "bf": w.to(torch.bfloat16)})
        w.fill_(-1)  # the step updates its state in place
    mgr.wait()
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4 and len(mgr.flush_times) == 4
    for s in (3, 4):
        _, got = restore_checkpoint(str(tmp_path), s)
        assert torch.equal(got["w"], torch.full((1000,), float(s)))
        assert torch.equal(got["bf"], torch.full((1000,), float(s), dtype=torch.bfloat16))


def test_manager_wait_raises_when_a_write_fails(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    assert mgr.latest_step() is None


# ------------------------------------------------------ the supervisor ----

@pytest.mark.parametrize("fail_at,every,restored", [(7, 3, 6), (1, 100, 0)])
def test_supervisor_recovers_as_the_jax_one(tmp_path, fail_at, every, restored):
    """A warm restart (from step 6) and a cold one (no checkpoint yet:
    from the step-0 snapshot), against the JAX supervisor's log.  The
    state is a tensor updated in place, so the step-0 snapshot must be a
    copy."""
    logs = []
    for sup_cls, inj_cls, path in ((TrainingSupervisor, FailureInjector, "t"),
                                   (JTrainingSupervisor, JFailureInjector, "j")):
        sup = sup_cls(str(tmp_path / path), ckpt_every=every, injector=inj_cls({fail_at: 2}))
        if path == "t":
            x = torch.zeros(())

            def step_fn(s, i):
                s["x"].add_(1.0)
                return s

            def load(t, s):
                s["x"].copy_(t["x"])
                return s

            out = sup.run({"x": x}, step_fn, 10, tree_to_state=load)
            assert out["x"] is x and float(x) == 10.0
        else:
            out = sup.run({"x": np.float32(0)}, lambda s, i: {"x": s["x"] + 1.0}, 10,
                          tree_to_state=lambda t, s: {"x": np.float32(t["x"])})
            assert float(out["x"]) == 10.0
        assert sup.restarts == 1
        logs.append(sup.recovery_log)
    assert logs[0] == logs[1] == [dict(failed_step=fail_at, worker=2, restored_to=restored,
                                       lost_steps=fail_at - restored)]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = TrainingSupervisor(str(tmp_path), injector=FailureInjector({0: 0, 1: 1, 2: 2}),
                             max_restarts=2)
    with pytest.raises(WorkerFailure):
        sup.run({"x": torch.zeros(())}, lambda s, i: s, 5)


def test_straggler_monitor_matches_jax():
    got, want = StragglerMonitor(4, threshold=1.5), JStragglerMonitor(4, threshold=1.5)
    for _ in range(5):
        for w, dt in [(0, 1.0), (1, 1.0), (2, 1.1), (3, 3.0)]:
            got.record(w, dt)
            want.record(w, dt)
    np.testing.assert_array_equal(got.ema, want.ema)
    assert got.stragglers() == want.stragglers() == [3]
    assert StragglerMonitor(1).stragglers() == []


# ------------------------------------------------- the train state tree ----

def test_train_state_from_a_jax_checkpoint(tmp_path):
    """The JAX driver's state tree, saved by the JAX package, restores into
    the port's live model and optimizer state bit for bit, in place."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    _, jp, jo = j_train.build_state(cfg, seed=3)
    jo["step"] = jnp.int32(4)
    j_save(str(tmp_path), 4, jax.tree.map(np.asarray, {"params": jp, "opt": jo}))
    model, opt = train.build_state(cfg, seed=0, device="cpu")
    live = tree_leaves(train_state_to_tree(model, opt))
    _, tree = restore_checkpoint(str(tmp_path))
    assert train_state_from_tree(tree, model, opt) is opt
    after = tree_leaves(train_state_to_tree(model, opt))
    assert all(a is b for a, b in zip(live[:-1], after[:-1]))  # the same tensors
    assert int(opt["step"]) == 4
    assert_same_bits(train_state_to_tree(model, opt),
                     jax.tree.map(np.asarray, {"params": jp, "opt": jo}))


def test_train_state_from_tree_refuses_another_model(tmp_path):
    model, opt = train.build_state(get_smoke_config("mamba2-370m"), device="cpu")
    tree = tree_map(lambda t: t.clone(), train_state_to_tree(model, opt))
    tree["params"]["embed"] = tree["params"]["embed"].float()
    with pytest.raises(ValueError, match="params/embed"):
        train_state_from_tree(tree, model, opt)
    tree["params"]["embed"] = tree["params"]["embed"].to(torch.bfloat16)
    del tree["opt"]["mu"]
    with pytest.raises(ValueError, match="keys"):
        train_state_from_tree(tree, model, opt)


# -------------------------------------------------- the driver's path ----

RUN = ["--smoke", "--device", "cpu", "--steps", "12", "--seq-len", "32", "--batch", "4"]


@pytest.mark.parametrize("arch,fail_at", [
    ("smollm-135m", 8), ("granite-moe-1b-a400m", 8), ("mamba2-370m", 8),
    ("mamba2-370m", 3)])  # before the first checkpoint: a cold restart
def test_driver_restart_ends_bit_equal_to_an_uninterrupted_run(tmp_path, arch, fail_at):
    """``--ckpt-every 5 --inject-failure-at N`` against the same run without
    a failure: the replay, and the final parameters and optimizer state
    bit for bit."""
    base = ["--arch", arch] + RUN
    plain = train.main(base)
    out = train.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "5",
                             "--inject-failure-at", str(fail_at)])
    restored = 5 if fail_at >= 5 else 0
    assert out["recoveries"] == [dict(failed_step=fail_at, worker=0, restored_to=restored,
                                      lost_steps=fail_at - restored)]
    assert len(out["losses"]) == 12 + fail_at - restored
    assert out["losses"][:fail_at] == plain["losses"][:fail_at]
    assert out["losses"][fail_at:] == plain["losses"][restored:]  # the replay
    assert_same_bits(out["state"], plain["state"])
    assert plain["recoveries"] == []


def test_driver_checkpoints_restore_in_jax(tmp_path):
    """tests/test_system.py's run through the port's CLI: smollm with
    checkpoints and a failure; the committed step directories read back
    through the JAX `restore_checkpoint`, equal to the state at that step."""
    out = train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "16",
                      "--seq-len", "64", "--batch", "4", "--lr", "3e-3",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                      "--inject-failure-at", "8"])
    losses = out["losses"]
    assert losses[-1] < losses[0]
    assert out["recoveries"][0]["restored_to"] == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000005", "step_00000010", "step_00000015"]
    step, tree = j_restore(str(tmp_path), 15)
    assert step == 15 and int(tree["opt"]["step"]) == 15
    assert tree["params"]["embed"].dtype == ml_dtypes.bfloat16
    assert tree["opt"]["master"]["embed"].dtype == np.float32
    _, ours = restore_checkpoint(str(tmp_path), 15)
    assert_same_bits(ours, tree)


@pytest.mark.parametrize("arch,extra", [
    ("granite-moe-1b-a400m", ["--microbatches", "2", "--grad-compression", "bf16"]),
    ("mamba2-370m", []),
    ("mamba2-370m", ["--microbatches", "2", "--grad-compression", "int8"])])
def test_driver_trains_the_moe_and_ssm_families(arch, extra):
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "10",
                      "--seq-len", "32", "--batch", "4"] + extra)
    losses = out["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    params = lm_params_to_numpy_float(out["state"]["params"])
    assert all(np.isfinite(p).all() for p in params)


def lm_params_to_numpy_float(tree):
    return [t.detach().float().numpy() for t in tree_leaves(tree)]
