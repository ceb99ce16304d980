"""Production mesh construction (functions, never at import time, so
importing this module builds no process group), the JAX package's
``launch/mesh.py`` on ``torch.distributed``.

Each mesh needs a process group of its world size.  A production mesh
(256 or 512 ranks, one per GPU) is built inside the group that
``torchrun`` (or ``init_process_group``) made, or the dry run's fake
group; the host mesh makes a world-size-1 group itself when none
exists.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _make_mesh(shape, axes, device_type: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs a process group of {n} ranks; none exists")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh {axes} needs a world size of {n}; this process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """16x16 = 256 GPUs; multi_pod stacks 2 of those = 512 GPUs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, torch.device(device).type)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """Degenerate 1x1 mesh over this process alone.  Without a process
    group it makes a world-size-1 one (NCCL on the card, gloo on the CPU)
    over an in-process ``HashStore``."""
    kind = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return _make_mesh((1, 1), ("data", "model"), kind)


def make_mesh(shape, axes, device="cuda") -> DeviceMesh:
    """Any named mesh over the current process group (tests, the dry run
    on a small fake group)."""
    return _make_mesh(tuple(shape), tuple(axes), torch.device(device).type)
