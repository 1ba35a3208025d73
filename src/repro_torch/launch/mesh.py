"""Production meshes (`repro.launch.mesh`) as `DeviceMesh`es over a fake
process group.

The dry run costs the production layouts on the host: 16 x 16 = 256
devices per pod, 2 pods = 512 multi-pod.  Their ranks live in one
``"fake"`` process group of 512 ranks (`FakeStore`), this process being
rank 0: collectives issued on it move no data and return at once, so
DTensor's redistributes run as they would on rank 0 of the real job, and
what they issue can be counted (`launch.roofline`).  The 16 x 16 mesh
takes ranks 0-255.

A process holds one default process group.  The dry run therefore runs
in a process of its own (`python -m repro_torch.launch.dryrun`); a
process already holding another group (NCCL, gloo) cannot build these
meshes.  Defined as functions, so importing this module starts nothing.
"""
from __future__ import annotations

import torch

WORLD = 512   # ranks of the fake group: the multi-pod mesh


def fake_world(size: int = WORLD) -> None:
    """The process's default group: a fake group of ``WORLD`` ranks,
    started here if none is; refuses another kind of group, or one too
    small for ``size`` ranks."""
    import torch.distributed as dist

    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    if dist.get_backend() != "fake" or dist.get_world_size() < size:
        raise RuntimeError(
            f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is "
            f"this process's default group; the dry run needs a fake group of "
            f"{size}: run it in a process of its own")


def make_mesh(shape, axes):
    """A `DeviceMesh` of ``shape`` named ``axes`` over ranks 0..n-1 of the
    fake group."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    fake_world(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh():
    """The 1 x 1 ("data", "model") mesh (rank 0 alone)."""
    return make_mesh((1, 1), ("data", "model"))
