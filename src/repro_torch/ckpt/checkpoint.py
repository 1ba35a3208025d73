"""Cuboid-chunked checkpoints with an async write path
(`repro.ckpt.checkpoint`), in the JAX package's on-disk format.

Every leaf of a tree (nested dicts of torch tensors or numpy arrays) is
flattened and cut into 4 MiB chunks, the 1-d analogue of cuboids, named
``key.replace("/", "__") + ".%05d.chunk"`` (raw, or zlib level 1).  The
directory's ``manifest.json`` (each leaf's shape, dtype string, chunk
count, byte count and file stem) is written last, and the directory is
renamed from ``.tmp_step_*`` to ``step_*``: that rename commits it.  A
restore with ``shard_info=(host, n_hosts)`` reads only the host's segment
of each leaf's chunk list (`core.morton.partition_curve`), zeros
elsewhere, as the JAX restore does for an elastic restart.

A bfloat16 leaf is written as its raw 2-byte patterns under the dtype
string ``"bfloat16"``, which the JAX `restore_checkpoint` reads as
ml_dtypes' bfloat16; the port reads it back through a 16-bit integer
view, so it needs no ml_dtypes.  Restored leaves are CPU torch tensors.

`CheckpointManager.save_async` copies the tree to the host on the caller's
thread (a snapshot the step may then update in place) and writes it from
a background thread, keeping the ``keep`` newest checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.morton import partition_curve
from ..models.params import tree_map

CHUNK_BYTES = 4 << 20  # 4 MiB chunks (the "cuboid" of the 1-d curve)
BF16 = "bfloat16"


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(key, leaf) in sorted key order, keys joined by "/"."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [kv for k in sorted(tree)
            for kv in _leaf_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]


def host_copy(leaf):
    """A host copy of a leaf that no later in-place update reaches: a CPU
    tensor for a tensor (``.numpy()`` of a CPU tensor would alias it), a
    numpy array otherwise."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _raw(leaf) -> Tuple[bytes, List[int], str]:
    """(bytes, shape, dtype string) of a leaf in C order."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), list(t.shape), BF16
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, compress: bool = False) -> str:
    """Write one checkpoint synchronously.  Returns the committed dir."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "chunk_bytes": CHUNK_BYTES,
                "compress": compress}
    for key, leaf in _leaf_paths(tree):
        raw, shape, dtype = _raw(leaf)
        n_chunks = max(1, -(-len(raw) // CHUNK_BYTES))
        fn = key.replace("/", "__")
        for c in range(n_chunks):
            blob = raw[c * CHUNK_BYTES:(c + 1) * CHUNK_BYTES]
            if compress:
                blob = zlib.compress(blob, 1)
            with open(os.path.join(tmp, f"{fn}.{c:05d}.chunk"), "wb") as f:
                f.write(blob)
        manifest["leaves"][key] = {"shape": shape, "dtype": dtype,
                                   "n_chunks": n_chunks, "nbytes": len(raw),
                                   "file": fn}
    # manifest last + atomic rename = commit point
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)
    return final


def committed_steps(ckpt_dir: str) -> List[int]:
    """Steps of the committed checkpoints in ``ckpt_dir``, ascending."""
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_"))


def _tensor(buf: bytearray, dtype: str, shape) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(np.frombuffer(buf, dtype=np.int16).reshape(shape)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape))


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       shard_info: Optional[Tuple[int, int]] = None
                       ) -> Tuple[int, Dict]:
    """Restore (step, tree) of the given or the newest committed step;
    leaves are CPU tensors.  ``shard_info=(host_id, n_hosts)``: this host
    reads only its curve segment of each leaf's chunk list (chunks outside
    it are zero-filled)."""
    steps = committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    compress = manifest.get("compress", False)

    def load_leaf(meta):
        n = meta["n_chunks"]
        lo, hi = 0, n
        if shard_info is not None:
            host, n_hosts = shard_info
            lo, hi = partition_curve(n, n_hosts)[host]
        buf = bytearray(meta["nbytes"])
        for c in range(lo, hi):
            with open(os.path.join(d, f"{meta['file']}.{c:05d}.chunk"), "rb") as f:
                blob = f.read()
            if compress:
                blob = zlib.decompress(blob)
            start = c * manifest["chunk_bytes"]
            buf[start:start + len(blob)] = blob
        return _tensor(buf, meta["dtype"], meta["shape"])

    tree: Dict = {}
    for key, meta in manifest["leaves"].items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = load_leaf(meta)
    return step, tree


@dataclasses.dataclass
class _Pending:
    step: int
    snapshot: Dict
    t_start: float


class CheckpointManager:
    """Async checkpointing: snapshot on the step path, flush off it."""

    def __init__(self, ckpt_dir: str, keep: int = 3, compress: bool = False):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.compress = compress
        os.makedirs(ckpt_dir, exist_ok=True)
        self._q: List[_Pending] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False  # a writer owns the queue; set and read under _lock
        self._error: Optional[Exception] = None
        self.flush_times: List[float] = []

    def save_async(self, step: int, tree) -> None:
        # synchronous part: device -> host copy (snapshot isolation)
        snap = tree_map(host_copy, tree)
        with self._lock:
            self._q.append(_Pending(step, snap, time.perf_counter()))
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._drain, daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        try:
            while True:
                with self._lock:
                    if not self._q:
                        self._running = False
                        return
                    item = self._q[0]
                save_checkpoint(self.ckpt_dir, item.step, item.snapshot,
                                compress=self.compress)
                self.flush_times.append(time.perf_counter() - item.t_start)
                self._gc()
                with self._lock:
                    self._q.pop(0)
        except Exception as e:  # handed to the caller by wait()
            with self._lock:
                self._error = e
                self._running = False

    def _gc(self) -> None:
        for s in committed_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        """Return when every snapshot taken so far is committed; raise if
        the writer failed."""
        while True:
            with self._lock:
                if self._error is not None:
                    raise RuntimeError("checkpoint write failed") from self._error
                if not self._q:
                    thread = self._thread
                    break
            time.sleep(0.01)
        if thread is not None:
            thread.join(timeout=10)

    def latest_step(self) -> Optional[int]:
        steps = committed_steps(self.ckpt_dir)
        return steps[-1] if steps else None
