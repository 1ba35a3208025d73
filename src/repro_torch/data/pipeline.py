"""Morton-sharded training-data pipeline (`repro.data.pipeline`).

The corpus is a 2-D (documents x positions) uint32 token grid held as
Morton-indexed cuboids in a `DeviceCuboidStore`; every row is read with
`cutout`, so on the card through the `cutout_gather` kernel.  Batch
addressing is stateless: the rows of batch ``step`` are a pure function
of (seed, step), drawn with numpy as the JAX pipeline draws them, so both
give the same tokens bit for bit.  Hosts take contiguous curve segments
of the batch (`partition_curve`), and assembly over-decomposes the rows
into work units that a pool of workers steals from one queue.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import morton
from ..core.cuboid import DatasetSpec
from ..core.cutout import cutout, ingest
from ..core.store import DeviceCuboidStore
from ..device import DeviceLike
from ..obs.trace import span


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    prefetch: int = 2
    # over-decomposition factor for work stealing (units per worker)
    overdecompose: int = 4


class TokenStore:
    """Token corpus as a (docs, positions) uint32 grid over a
    `DeviceCuboidStore` on ``device`` (held as int32 with the same bits)."""

    def __init__(self, n_docs: int, doc_len: int,
                 cuboid: Tuple[int, int] = (64, 4096),
                 device: DeviceLike = "cuda"):
        self.spec = DatasetSpec(name="tokens", volume_shape=(n_docs, doc_len),
                                dtype="uint32", base_cuboid=cuboid,
                                scaled_dims=())
        self.store = DeviceCuboidStore(self.spec, device=device)
        self.n_docs = n_docs
        self.doc_len = doc_len

    @property
    def device(self) -> torch.device:
        return self.store.device

    def ingest_corpus(self, tokens: np.ndarray, offset=(0, 0)) -> None:
        ingest(self.store, 0, np.asarray(tokens).astype(np.uint32), offset=offset)

    def read_rows(self, doc_lo: int, doc_hi: int, pos_lo: int,
                  pos_hi: int) -> torch.Tensor:
        return cutout(self.store, 0, (doc_lo, pos_lo), (doc_hi, pos_hi))

    @property
    def grid(self):
        return self.spec.grid(0)


class DataPipeline:
    """Deterministic, stateless-addressed, prefetching batch pipeline."""

    def __init__(self, store: TokenStore, cfg: PipelineConfig):
        self.store = store
        self.cfg = cfg
        if store.doc_len < cfg.seq_len + 1:
            raise ValueError("doc_len must exceed seq_len (need labels)")
        self._rows_per_batch = cfg.global_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._count_guard = threading.Lock()
        # instrumentation
        self.steals = 0
        self.units_processed = 0

    # ---- stateless batch addressing ------------------------------------
    def batch_rows(self, step: int) -> np.ndarray:
        """Document rows of global batch ``step``: a pure f(seed, step)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step]))
        return rng.choice(self.store.n_docs, size=self._rows_per_batch,
                          replace=self.store.n_docs < self._rows_per_batch)

    def host_slice(self, step: int) -> np.ndarray:
        """The rows this host produces (a contiguous shard of the batch)."""
        rows = self.batch_rows(step)
        lo, hi = morton.partition_curve(len(rows), self.cfg.n_hosts)[self.cfg.host_id]
        return rows[lo:hi]

    # ---- assembly with work stealing ------------------------------------
    def _assemble(self, rows: np.ndarray, n_workers: int = 2) -> torch.Tensor:
        S = self.cfg.seq_len + 1  # +1: labels are next-token shifted
        out = torch.zeros((len(rows), S), dtype=torch.int32, device=self.store.device)
        n_units = max(1, n_workers * self.cfg.overdecompose)
        work: "queue.Queue" = queue.Queue()
        for u in np.array_split(np.arange(len(rows)), n_units):
            if len(u):
                work.put(u)

        def worker(wid: int) -> int:
            local = 0
            while True:
                try:
                    u = work.get_nowait()
                except queue.Empty:
                    return local
                # visit docs in sorted order: longer runs along the curve
                for k in np.argsort(rows[u], kind="stable"):
                    doc = int(rows[u[k]])
                    out[int(u[k])] = self.store.read_rows(doc, doc + 1, 0, S)[0]
                local += 1
                with self._count_guard:
                    self.units_processed += 1

        with cf.ThreadPoolExecutor(max_workers=n_workers) as ex:
            counts = list(ex.map(worker, range(n_workers)))
        # steal count: units processed beyond an even share
        even = n_units // n_workers
        self.steals += sum(max(0, c - even) for c in counts if c)
        return out

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"}: (rows, seq_len) int32 on the store's
        device, the labels shifted by one position (the span
        ``data.get_batch``)."""
        with span("data.get_batch"):
            data = self._assemble(self.host_slice(step))
        return {"tokens": data[:, :-1], "labels": data[:, 1:]}

    # ---- prefetch (the read path decoupled from the training loop) ------
    def start(self, first_step: int = 0) -> None:
        def run():
            step = first_step
            while not self._stop.is_set():
                batch = self.get_batch(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def next(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
