"""One rank of tests/test_torch_distributed.py, run in a spawned process.

Imports torch and the port only (no JAX), joins a gloo group through the
``file://`` rendezvous it is given, builds the case's volume from its seed,
runs the multi-rank cutouts and writes on its own shard, and saves what it
read to ``rank<r>.npz`` in the output directory.
"""
import datetime

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cuboid import CuboidGrid
from repro_torch.core.distributed import (distributed_cutout, distributed_write_cutout,
                                          pack_to_cuboids, shard_cuboids)


def case_volume(case) -> np.ndarray:
    rng = np.random.default_rng(case["seed"])
    return rng.integers(1, 250, size=case["volume"]).astype(case["dtype"])


def run(rank, world, init_method, case, out_dir):
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        grid = CuboidGrid(tuple(case["volume"]), tuple(case["cuboid"]))
        packed = pack_to_cuboids(torch.from_numpy(case_volume(case)), grid)
        shard = shard_cuboids(packed, rank, world).clone()
        out = {f"cut{i}": distributed_cutout(shard, grid, lo, hi).numpy()
               for i, (lo, hi) in enumerate(case["boxes"])}
        for lo, data in case["writes"]:
            assert distributed_write_cutout(shard, grid, lo, data) is shard
        out["after"] = distributed_cutout(shard, grid, (0,) * grid.rank,
                                          grid.volume_shape).numpy()
        out["shard"] = shard.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
