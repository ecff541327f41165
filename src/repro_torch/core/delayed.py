"""BucketExchange — the Roomy delayed-op engine across a process group (port
of ``repro/core/delayed.py``).

Random-access operations are *delayed*, binned by the rank that owns their
target, exchanged in fixed-capacity buckets with ONE all-to-all per
direction, then applied as a streaming batch on the owner.  The reference
runs inside ``jax.shard_map`` over a named mesh axis; here every function
works on this rank's local tensors and takes the caller's process group
(``torch.distributed``; None is the default group), whose size is ``S``,
the number of shards.  ``C`` is the per-(src, dst) bucket capacity:
overflowing items are dropped and counted exactly.

The three phases:

  bin_by_dest   local sort-by-owner + scatter into (S, C, ·) buckets
  exchange      ``all_to_all_single`` over the leading (S) axis
  unbin         route per-item results back to their issue order

``bucket_sync_update`` / ``bucket_sync_access`` compose them into the two
delayed-op flavours of the paper (update: fire-and-forget scatter; access:
full round trip).  The reference's ``psum`` of ``dropped`` is an
``all_reduce``, and carries no gradient.

Training runs through these phases (the roomy embedding and the roomy
MoE on a mesh), so each carries the gradient of its payload: ``exchange``
is an ``autograd.Function`` whose backward is the reverse all-to-all, the
same call on the gradient's (S, C, …) buckets (an all-to-all is its own
adjoint); ``bin_by_dest`` and ``unbin`` move rows by index, so autograd
routes their gradients back by the same indices.  The ids and validity
masks carry none.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from . import types as T


class Binned(NamedTuple):
    payload: torch.Tensor   # (S, C, *d) bucketed payloads
    valid: torch.Tensor     # (S, C) bool
    src_idx: torch.Tensor   # (S, C) int32 — originating local item (or m)
    dropped: torch.Tensor   # () int32 — items that overflowed their bucket


def bin_by_dest(dest: torch.Tensor, payload: torch.Tensor,
                valid: torch.Tensor, nbuckets: int, capacity: int) -> Binned:
    """Bin m local items into per-destination buckets of fixed capacity.

    dest: (m,) int32 in [0, nbuckets); payload: (m, *d); valid: (m,)."""
    m = dest.shape[0]
    dev = dest.device
    d_eff = torch.where(valid, dest.to(torch.int32), nbuckets)
    order = torch.sort(d_eff, stable=True).indices
    d_s = d_eff[order].to(torch.int64)
    pay_s = payload[order]
    pos = torch.arange(m, device=dev)
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        d_s[1:] != d_s[:-1]])[:m]
    run_start = torch.cummax(torch.where(starts, pos, 0), 0).values
    rank = pos - run_start
    ok = (rank < capacity) & (d_s < nbuckets)
    slots = nbuckets * capacity
    flat = torch.where(ok, d_s * capacity + rank, slots)
    shape = tuple(payload.shape[1:])
    buf = T.scatter_drop(torch.zeros((slots,) + shape, dtype=payload.dtype,
                                     device=dev), flat, pay_s)
    vbuf = T.scatter_drop(torch.zeros(slots, dtype=torch.bool, device=dev),
                          flat, ok)
    sbuf = T.scatter_drop(torch.full((slots,), m, dtype=torch.int32,
                                     device=dev), flat, order)
    nvalid = (d_s < nbuckets).sum(dtype=torch.int32)
    return Binned(payload=buf.reshape((nbuckets, capacity) + shape),
                  valid=vbuf.reshape(nbuckets, capacity),
                  src_idx=sbuf.reshape(nbuckets, capacity),
                  dropped=nvalid - ok.sum(dtype=torch.int32))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """The all-to-all; its backward is the reverse all-to-all of the
    gradient (the same call: row j of the gradient goes back to rank j)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def exchange(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-to-all the leading (destination) axis of x: (S, C, *d).  After
    the call, row j holds what rank j sent to this rank.  Booleans travel
    as uint8.  Differentiable in a float x (``_Exchange``)."""
    if x.dtype == torch.bool:
        return exchange(x.to(torch.uint8), group).to(torch.bool)
    if x.requires_grad:
        return _Exchange.apply(x, group)
    return _all_to_all(x, group)


def unbin(results: torch.Tensor, src_idx: torch.Tensor,
          m: int) -> torch.Tensor:
    """Scatter per-bucket results back to issue order. results: (S, C, *e)."""
    flat_res = results.reshape((-1,) + tuple(results.shape[2:]))
    out = torch.zeros((m,) + tuple(results.shape[2:]), dtype=results.dtype,
                      device=results.device)
    return T.scatter_drop(out, src_idx.reshape(-1), flat_res)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    total = x.detach().reshape(1).clone()
    dist.all_reduce(total, group=group)
    return total[0]


def bucket_sync_update(dest: torch.Tensor, payload: torch.Tensor,
                       valid: torch.Tensor, group, nshards: int,
                       capacity: int, owner_apply: Callable, owner_state):
    """Delayed *update* sync: route payloads to owners, apply, no reply.

    owner_apply(state, payload (S*C, *d), valid (S*C,)) -> new state.
    Returns (new_state, dropped summed over the group)."""
    binned = bin_by_dest(dest, payload, valid, nshards, capacity)
    recv = exchange(binned.payload, group)
    recv_valid = exchange(binned.valid, group)
    flat = recv.reshape((-1,) + tuple(recv.shape[2:]))
    new_state = owner_apply(owner_state, flat, recv_valid.reshape(-1))
    return new_state, _psum(binned.dropped, group)


def bucket_sync_access(dest: torch.Tensor, payload: torch.Tensor,
                       valid: torch.Tensor, group, nshards: int,
                       capacity: int, owner_fn: Callable):
    """Delayed *access* sync: route to owners, compute, route replies back.

    owner_fn(payload (S, C, *d), valid (S, C)) -> results (S, C, *e).
    Returns (results in issue order (m, *e), valid_out (m,), dropped).
    Differentiable in ``payload`` and in what ``owner_fn`` returns."""
    m = dest.shape[0]
    binned = bin_by_dest(dest, payload, valid, nshards, capacity)
    recv = exchange(binned.payload, group)
    recv_valid = exchange(binned.valid, group)
    results = owner_fn(recv, recv_valid)
    back = exchange(results, group)
    out = unbin(back, binned.src_idx, m)
    ok = unbin(binned.valid.to(torch.int32), binned.src_idx, m) > 0
    return out, ok, _psum(binned.dropped, group)
