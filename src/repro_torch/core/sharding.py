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

* **global**: every rank holds the same whole rows.  An exchange takes
  this rank's block of the B·S tokens split over every axis (data axes,
  then ``model``) and gathers over every axis.  Serving keeps it for a
  batch that does not tile the data axes (batch 1, say).
* **local** (training, and serving a batch that tiles the data axes; a
  ``MeshView`` with ``local=True``): the batch splits over the data axes
  as ``ShardingRules.batch_spec()`` says, and every rank of one model
  group holds the same rows.  An exchange takes this data rank's rows,
  splits them over ``model`` alone and gathers over ``model`` alone.
  Row-major data-then-model order is the reference's token order, so each
  device holds the same tokens as under the reference's ``shard_map``.

Under a ``MeshView`` (serving and training on a mesh) the layers also
get this model rank's param shards under ``param_specs``
(``model_shards``): tensor parallelism, each layer computing its heads, ff
columns, ``d_inner`` channels and vocab columns where its weight is split
(``sharding_rules.model_dim``) and joining them with ``all_reduce`` /
``all_gather`` over ``model``, as the reference's ``jit`` partitions it
under GSPMD; ``gather_fsdp`` gathers a leaf over its data axes alone.  A
bare mesh gives the layers whole params (``gather_param`` rebuilds one).

Training on a mesh computes the host's math with explicit collectives.
One gradient convention holds everywhere:

1. The batch splits over the data axes (the local convention above); the
   rows of a data rank are repeated on every rank of its model group, and
   what a layer does not split over ``model`` (the norms, the router, a
   fallback's replicated weight) each rank of the group computes whole.
2. The loss is a sum of shares: rank r computes ``L_r = Σ_{its rows}
   −ll·mask / (global mask count · tp)``, ``tp`` because the model group
   repeats the rows, so that ``Σ_r L_r`` over the mesh is the host's mean
   (``models/lm.py``).  A rank's vocab-parallel cross-entropy joins its
   ``V / tp`` logit columns by all-reduces over ``model`` first, so every
   rank of the group holds the same row losses.
3. Every collective's backward is its exact adjoint, so that a rank's
   gradient of any tensor it holds is the derivative of ``Σ_r L_r``:
   all-gather ↔ reduce-scatter (sum), all-reduce ↔ all-reduce (a
   row-parallel product's partials joined forward; the gradient of each
   partial is the sum of every rank's gradient of the joined value),
   all-to-all ↔ the reverse all-to-all (``delayed.exchange``,
   ``take_columns``), a slice of a tensor ↔ zeros elsewhere (plain
   indexing).  A replicated value, whose copies are separate tensors on
   the ranks, gets the sum of the copies' gradients over the axes that
   replicate it (``sum_grad``): ``gather_param`` and ``gather_fsdp`` do
   that for every leaf, over ``model`` too wherever the spec replicates
   it there.  With rule 2 the gradient of every parameter shard is then
   the host's gradient of that block.
4. Params (and AdamW's moments) are each rank's shard under
   ``ShardingRules.param_specs``: ``shard_param`` cuts a whole leaf,
   ``gather_param`` rebuilds it differentiably (its backward
   reduce-scatters the gradient to the shard and sums it over the axes
   the spec replicates), and ``gather_fsdp`` rebuilds it over the data
   axes alone (the same backward, with ``model`` among the summed axes
   where the spec does not split the leaf over it).

This is not Megatron's convention (an identity backward for the
row-parallel all-reduce, an all-reduce at each column-parallel input, no
``tp`` in the loss, no sum for replicated leaves).  Mixed, the two are off
by a factor of ``tp`` on one class of leaf.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from . import types as T
from .disk.buckets import block_owner  # noqa: F401 — the one block map

__all__ = ["block_owner", "hash_owner", "mesh_axes", "data_axes",
           "axis_size", "axis_index", "axis_group", "shard_leading",
           "replicated", "gather_leading", "MeshView", "rows_local",
           "model_shards", "token_axes", "group_gather",
           "group_reduce_scatter", "all_gather", "reduce_scatter",
           "all_reduce", "shard_dim", "sum_grad", "spec_axes",
           "gather_param", "gather_fsdp", "shard_param", "take_columns"]

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
    """The ``DeviceMesh`` behind a ``MeshView`` (or ``mesh``)."""
    return mesh.base if isinstance(mesh, MeshView) else mesh


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
    return shard_dim(x, mesh, axes, 0)


def replicated(x, mesh):
    """Every rank holds the whole of x."""
    return x


def gather_leading(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Every coordinate's x on ``axes`` joined along the leading dim, in
    coordinate order: the inverse of ``shard_leading`` (an all-gather,
    whose backward reduce-scatters)."""
    return all_gather(x, mesh, axes, 0)


# ----------------------------------------- the two conventions of rows

class MeshView:
    """``mesh`` under one convention of the module docstring: ``local``,
    the activations hold this data rank's rows (else every rank holds the
    whole rows); and a block's params are this model rank's shards
    (``model_shards``).  Everything else is the mesh's own (attributes
    are read through)."""

    def __init__(self, mesh, *, local: bool):
        self.__dict__.update(base=_base(mesh), local=local)

    def __getattr__(self, name):
        return getattr(self.base, name)


def rows_local(mesh) -> bool:
    """True under the local convention, False under the global one."""
    return isinstance(mesh, MeshView) and mesh.local


def model_shards(mesh) -> bool:
    """True where the layers get each model rank's param shards and split
    their compute over ``model`` (a ``MeshView``: serving and training on
    a mesh); a bare mesh gives them whole params."""
    return isinstance(mesh, MeshView)


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


class _AllReduce(torch.autograd.Function):
    """The sum over the group forward; backward its adjoint, the same sum
    of the gradient (rule 3 of the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum of x over the coordinates of ``axes``, on each of them: a
    row-parallel product's partials joined.  Under autograd (x requiring a
    gradient) out of place, with the all-reduce of the gradient as its
    backward; else written into x, which must be a temporary of the
    caller's."""
    group, _, n = axis_group(mesh, axes)
    if n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def shard_dim(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """This coordinate's block of x's ``dim`` split over ``axes`` (a
    view): the inverse of ``all_gather`` along ``dim``."""
    n = axis_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axes} of size {n}")
    per = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * per, per)


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


def gather_fsdp(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The leaf gathered over the data axes of ``spec`` alone: a dim whose
    entry names ``model`` stays this model rank's block, which the
    tensor-parallel layers compute on.  Differentiable as ``gather_param``
    is: the backward reduce-scatters the gradient over the data axes and
    sums it over every axis the spec replicates, ``model`` among them
    where the leaf is not split over it (the norms, the router, a
    fallback's replicated weight)."""
    x = sum_grad(shard, mesh, _replicated_axes(mesh, spec))
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes and "model" not in axes:
            x = all_gather(x, mesh, axes, dim)
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


# ------------------------------------------- columns regrouped over an axis

class _AllToAllV(torch.autograd.Function):
    """An all-to-all of rows in uneven blocks (``send[j]`` rows to rank j,
    ``recv[j]`` from it); backward the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.args = (group, send, recv)
        return _all_to_all_v(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        group, send, recv = ctx.args
        return _all_to_all_v(g, group, recv, send), None, None, None


def _all_to_all_v(x, group, send, recv):
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + x.shape[1:])
    dist.all_to_all_single(out, x, list(recv), list(send), group=group)
    return out


@functools.lru_cache(maxsize=None)
def _columns_plan(width: int, n: int, me: int, want: Tuple) -> Tuple:
    """(the local columns to send, by destination; the count to each rank;
    the count from each rank; the order that puts the received columns
    into ``want[me]``'s) for ``take_columns``: rank s holds the global
    columns [s·width, (s + 1)·width), and ``want[t]`` lists rank t's
    ranges (start, stop) in the order it wants them."""
    def cols(t):
        return [c for a, b in want[t] for c in range(a, b)]
    send, send_n = [], []
    for t in range(n):
        mine = [c - me * width for c in cols(t)
                if me * width <= c < (me + 1) * width]
        send += mine
        send_n.append(len(mine))
    wanted = cols(me)
    by_src = [[c for c in wanted if s * width <= c < (s + 1) * width]
              for s in range(n)]
    at, base = {}, 0
    for s in range(n):
        for i, c in enumerate(by_src[s]):
            at[c] = base + i
        base += len(by_src[s])
    return (tuple(send), tuple(send_n), tuple(len(b) for b in by_src),
            tuple(at[c] for c in wanted))


def take_columns(x: torch.Tensor, mesh, axes: Axes, dim: int,
                 want: Tuple) -> torch.Tensor:
    """The global columns of ``dim`` that this coordinate wants, from
    every coordinate's contiguous block of them (x: this coordinate's,
    ``x.shape[dim]`` wide): one all-to-all of the columns each coordinate
    wants from each, differentiable (the backward sends the gradient back
    and sums a column taken by several).  ``want``: a tuple, one entry a
    coordinate of ``axes``, of the (start, stop) ranges it wants, in its
    order.  A tensor-parallel layer whose weight concatenates several
    channel blocks along one dim (mamba's ``in_proj``) regroups its
    stored block this way into the channels its rank computes."""
    group, me, n = axis_group(mesh, axes)
    send, send_n, recv_n, order = _columns_plan(x.shape[dim], n, me, want)
    dev = x.device
    xs = x.movedim(dim, 0).index_select(
        0, torch.tensor(send, dtype=torch.long, device=dev))
    got = _AllToAllV.apply(xs, group, send_n, recv_n) if n > 1 else xs
    got = got.index_select(0, torch.tensor(order, dtype=torch.long,
                                           device=dev))
    return got.movedim(0, dim)
