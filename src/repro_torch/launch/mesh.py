"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device and no process group.  The reference's ``jax.make_mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same dim names over
the process group the caller has already initialised
(``torch.distributed.init_process_group``: NCCL on the card, gloo on the
CPU), ranks numbered row-major over the mesh.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .. import device as _device

POD = (16, 16)                 # 16 x 16 = 256 chips a pod


def _mesh(shape, names, device):
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed before building a "
                           "mesh (init_process_group)")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh {dict(zip(names, shape))} needs {n} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(_device.resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 × 16 ("data", "model") = 256 ranks; ``multi_pod``: 2 pods, (2, 16,
    16) ("pod", "data", "model") = 512.  Raises unless the world is that
    size."""
    shape = (2,) + POD if multi_pod else POD
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_host_mesh(tp: int = 1, device=None):
    """The whole world as (world / tp, tp) ("data", "model"): ``tp`` ranks
    a model group (CPU tests, the one-card smoke run)."""
    world = dist.get_world_size() if dist.is_initialized() else tp
    if tp < 1 or world % tp:
        raise ValueError(f"tp {tp} does not divide the world of {world}")
    return _mesh((world // tp, tp), ("data", "model"), device)
