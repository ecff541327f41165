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

Two conventions for what a rank's activations hold, one switch between
them (``rows_local``):

* **global** (serving: ``lm.prefill``, ``lm.decode_step``): every rank
  passes the same whole inputs and gets the whole outputs back.  An
  exchange takes this rank's block of the B·S tokens split over every
  axis (data axes, then ``model``) and gathers over every axis.
* **local** (training: ``lm.forward_hidden`` / ``lm.loss_fn`` on a mesh,
  which wrap the mesh in ``LocalRows``): the batch splits over the data
  axes as ``ShardingRules.batch_spec()`` says, and every rank of one model
  group holds the same rows.  An exchange takes this data rank's rows,
  splits them over ``model`` alone and gathers over ``model`` alone.
  Row-major data-then-model order is the reference's token order, so each
  device holds the same tokens as under the reference's ``shard_map``.

Training on a mesh computes the host's math with explicit collectives
(under GSPMD the reference changes only the layout).  The rules:

1. The batch splits over the data axes (the local convention above).
2. The loss is a sum of shares: rank r computes ``L_r = Σ_{its rows}
   −ll·mask / (global mask count · tp)``, so that ``Σ_r L_r`` over the
   mesh is the host's mean (``models/lm.py``).
3. Every collective's backward is its adjoint: all-gather ↔
   reduce-scatter (sum), all-to-all ↔ the reverse all-to-all
   (``delayed.exchange``), a slice of a replicated tensor ↔ zeros
   elsewhere (plain indexing), and a replicated value's gradient summed
   over the ranks that replicate it (``gather_param``).  With rule 2 the
   gradient of every parameter is then the sum of every rank's part of it
   over the whole mesh, which is the host's gradient.
4. Params (and AdamW's moments) are each rank's shard under
   ``ShardingRules.param_specs``: ``shard_param`` cuts a whole leaf,
   ``gather_param`` rebuilds it differentiably (its backward
   reduce-scatters the gradient to the shard and sums it over the axes
   the spec replicates).
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
           "replicated", "gather_leading", "LocalRows", "rows_local",
           "token_axes", "group_gather", "group_reduce_scatter",
           "all_gather", "reduce_scatter", "sum_grad",
           "spec_axes", "gather_param", "shard_param"]

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


def _base(mesh):
    """The ``DeviceMesh`` behind a ``LocalRows`` view (or ``mesh``)."""
    return mesh.base if isinstance(mesh, LocalRows) else mesh


def axis_group(mesh, axes: Axes):
    """(process group, this rank's coordinate, size) of ``axes``.  One
    axis is the mesh's own group; a tuple's groups are made the first time
    it is asked for, by every rank in the same order (``new_group`` is
    collective over the world), and kept on the mesh.  A group's ranks
    must be numbered as the coordinates, so that an all-to-all's chunk j
    reaches coordinate j: checked."""
    axes = _axes(mesh, axes)
    idx, size = axis_index(mesh, axes), axis_size(mesh, axes)
    mesh = _base(mesh)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    elif len(axes) == len(mesh.mesh_dim_names) \
            and size == dist.get_world_size():
        group = dist.group.WORLD              # the whole mesh is the world
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
    coordinate order: the inverse of ``shard_leading`` (an all-gather,
    whose backward reduce-scatters)."""
    return all_gather(x, mesh, axes, 0)


# ----------------------------------------- the two conventions of rows

class LocalRows:
    """``mesh`` under the local convention of the module docstring: the
    activations hold this data rank's rows.  Everything else is the
    mesh's own (attributes are read through)."""

    def __init__(self, mesh):
        self.__dict__["base"] = _base(mesh)

    def __getattr__(self, name):
        return getattr(self.base, name)


def rows_local(mesh) -> bool:
    """True under the local (training) convention, False under the
    global (serving) one."""
    return isinstance(mesh, LocalRows)


def token_axes(mesh) -> Tuple[str, ...]:
    """The axes an exchange splits the tokens it holds over: every axis
    under the global convention, ``model`` alone under the local one."""
    if rows_local(mesh):
        return ("model",)
    return tuple(mesh_axes(mesh))


# ------------------------------------------ differentiable collectives

# newer torch names the two tensor collectives ``*_single`` and warns on
# the older names, which are all that older builds have
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def group_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's x joined along dim 0, in rank order (``group`` of
    ``n`` ranks; not differentiable: ``all_gather`` is)."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    _ALL_GATHER(out, x, group=group)
    return out


def group_reduce_scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``group`` of x, this rank's block
    of dim 0 (not differentiable: ``reduce_scatter`` is)."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    _REDUCE_SCATTER(out, x, group=group)
    return out


def _moved(fn, x: torch.Tensor, dim: int, *args) -> torch.Tensor:
    """``fn`` along ``dim`` (moved to the front and back)."""
    if dim == 0:
        return fn(x, *args)
    return fn(x.movedim(dim, 0), *args).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _moved(group_gather, x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _moved(group_reduce_scatter, g, dim, group, n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _moved(group_reduce_scatter, x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _moved(group_gather, g, dim, group, n), None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """Every coordinate's x on ``axes`` joined along ``dim`` in
    coordinate order; the backward reduce-scatters (sums) the gradient
    back to this coordinate's block."""
    group, _, n = axis_group(mesh, axes)
    if n == 1:
        return x
    return _AllGather.apply(x, group, n, dim)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of x over the coordinates of ``axes``, this coordinate's
    block of ``dim``; the backward all-gathers."""
    group, _, n = axis_group(mesh, axes)
    if n == 1:
        return x
    return _ReduceScatter.apply(x, group, n, dim)


def sum_grad(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """x itself; its gradient summed over ``axes`` (the adjoint of
    handing one value to every coordinate of ``axes``)."""
    if not axes or axis_size(mesh, axes) == 1:
        return x
    return _SumGrad.apply(x, axis_group(mesh, axes)[0])


# ------------------------------------------------ params under a spec

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards some dim over."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _replicated_axes(mesh, spec) -> Tuple[str, ...]:
    named = set(spec_axes(spec))
    return tuple(a for a in mesh_axes(mesh) if a not in named)


def gather_param(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block of it under ``spec`` (one
    entry a dim: an axis, a tuple of axes taken as one, or None),
    differentiably: the backward reduce-scatters the gradient to the
    block and sums it over the axes the spec replicates, so that a
    rank's gradient of its shard is the whole mesh's."""
    x = sum_grad(shard, mesh, _replicated_axes(mesh, spec))
    for dim, entry in enumerate(spec):
        if _entry_axes(entry):
            x = all_gather(x, mesh, _entry_axes(entry), dim)
    return x


def shard_param(whole: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf under ``spec`` (a view of
    ``whole``): the inverse of ``gather_param``."""
    x = whole
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = axis_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(whole.shape)} does not "
                             f"split over {axes} of size {n}")
        per = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axes) * per, per)
    return x
