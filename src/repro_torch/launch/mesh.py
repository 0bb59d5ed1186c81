"""Mesh construction over `torch.distributed`.

Importing this module starts nothing: meshes and process groups are built
inside functions only (`launch/dryrun.py` starts its fake group of 256 or
512 ranks in `run_cell`).
"""
from __future__ import annotations

import math

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    from ..dist.sharding import Mesh
    return Mesh(init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod. Needs a
    process group of that many ranks: a real one, or the dry run's fake
    one."""
    import torch.distributed as dist
    shape, axes = PRODUCTION[multi_pod]
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks, have {have} "
            "— run under launch/dryrun.py (python -m "
            "repro_torch.launch.dryrun), which starts a fake group of that "
            "size")
    return _device_mesh("cuda", shape, axes)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device="cuda"):
    """A small mesh over the current process group (tests, one card). With
    no group, starts one of world size 1 (NCCL on CUDA, gloo on the CPU)
    on an in-process store: no file and no network port."""
    import torch.distributed as dist
    from ..device import resolve
    dev = resolve(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"mesh {tuple(shape)} needs a process group "
                               f"of {n} ranks; none is started")
        if dev.type == "cuda" and dev.index is not None:
            import torch
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return _device_mesh(dev.type, shape, axes)
