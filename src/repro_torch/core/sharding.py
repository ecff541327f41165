"""Owner maps and mesh helpers of sharded Roomy structures (port of
``repro/core/sharding.py``).

Roomy distributes each structure across "disks" by a static owner
function; here the disks are the ranks of a process group.  Two owner
maps, matching the paper:

* arrays: block distribution — owner(i) = i // ceil(n / nshards)
* hash tables / lists: hash distribution — owner(x) = hash(x) % nshards

Both are bit-identical to the reference's and to its numpy mirrors in
``repro/core/disk/buckets.py``, which golden values in
``tests/test_cluster.py`` pin.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, as ``launch/mesh.py`` builds it (``("data", "model")`` or
``("pod", "data", "model")``).  The reference places a global array on
its mesh (``shard_leading``, ``replicated``); the port runs one process a
rank, so the helpers here return what this rank holds: its slice of the
leading dim, or the whole tensor.  ``axis_group`` gives the process group
and this rank's coordinate of one axis, or of a tuple of axes taken as one
flattened axis, major first, as ``jax.lax.axis_index(("pod", "data"))``
numbers it.  Specs alone need no devices: ``mesh_axes`` also reads a
stand-in with a ``shape`` mapping, as the reference's tests use.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from . import types as T
from .disk.buckets import block_owner  # noqa: F401 — the one block map

__all__ = ["block_owner", "hash_owner", "mesh_axes", "data_axes",
           "axis_size", "axis_index", "axis_group", "shard_leading",
           "replicated", "gather_leading"]

Axes = Union[str, Sequence[str]]


def hash_owner(rows: torch.Tensor, nshards: int) -> torch.Tensor:
    """Owner shard of each element/key row under hash distribution, as
    int32: the row's 32-bit hash read as unsigned, modulo ``nshards``."""
    h = T.hash_rows(rows).to(torch.int64) & T.UINT32_MASK
    return (h % nshards).to(torch.int32)


# ------------------------------------------------------------ the mesh

def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in the mesh's order: a ``DeviceMesh``'s dim names
    and sizes, or the ``shape`` mapping of a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """``axes`` as a tuple in the mesh's order (a flattened axis numbers
    its ranks major first, so its names must come in that order)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = list(mesh_axes(mesh))
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims) or len(set(dims)) != len(dims):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    return axes


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data axes, ("pod", "data") where present; () off a
    mesh."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def axis_size(mesh, axes: Axes) -> int:
    """The size of one axis, or the product of a tuple's."""
    shape = mesh_axes(mesh)
    return math.prod(shape[a] for a in _axes(mesh, axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's coordinate on ``axes``: row-major over a tuple."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_axes(mesh)
    idx = 0
    for a in _axes(mesh, axes):
        idx = idx * shape[a] + coord[a]
    return idx


def axis_group(mesh, axes: Axes):
    """(process group, this rank's coordinate, size) of ``axes``.  One
    axis is the mesh's own group; a tuple's groups are made the first time
    it is asked for, by every rank in the same order (``new_group`` is
    collective over the world), and kept on the mesh.  A group's ranks
    must be numbered as the coordinates, so that an all-to-all's chunk j
    reaches coordinate j: checked."""
    axes = _axes(mesh, axes)
    idx, size = axis_index(mesh, axes), axis_size(mesh, axes)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        cache = mesh.__dict__.setdefault("_roomy_flat_groups", {})
        if axes not in cache:
            names = list(mesh.mesh_dim_names)
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            rows = mesh.mesh.permute(*rest, *dims).reshape(-1, size)
            me = dist.get_rank()
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    cache[axes] = g
        group = cache[axes]
    if dist.get_rank(group) != idx:
        raise ValueError(f"the group of {axes} numbers its ranks otherwise "
                         "than the mesh's coordinates")
    return group, idx, size


def shard_leading(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """This rank's block of x's leading dim sharded over ``axes``."""
    n = axis_size(mesh, axes)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not split over "
                         f"{axes} of size {n}")
    per = x.shape[0] // n
    i = axis_index(mesh, axes)
    return x[i * per:(i + 1) * per]


def replicated(x, mesh):
    """Every rank holds the whole of x."""
    return x


def gather_leading(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Every coordinate's x on ``axes`` joined along the leading dim, in
    coordinate order: the inverse of ``shard_leading`` (an all-gather)."""
    group, _, n = axis_group(mesh, axes)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
