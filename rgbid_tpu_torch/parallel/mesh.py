"""Mesh construction (counterpart of ``rgbid_tpu/parallel/mesh.py``)."""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: int | None = None, axis: str = "sp") -> DeviceMesh:
    """1-D mesh named ``axis`` over the first ``n_devices`` ranks (all of
    them by default) of the initialised process group. Its device type is
    "cuda" under NCCL and "cpu" under gloo, whose tensors may live on a
    card all the same. Raises ValueError when the group has fewer ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (parallel/launch.py)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))
