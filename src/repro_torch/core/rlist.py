"""RoomyList — capacity-bounded, unordered multiset of fixed-width elements
(port of ``repro/core/rlist.py``).

The paper's RoomyList (Table 1):

  add          delayed   -> ``add`` (batched append: the caller's batch is
                            the delay unit)
  remove       delayed   -> ``remove`` (batched)
  addAll       immediate -> ``add_all``
  removeAll    immediate -> ``remove_all`` (multiset: removes *all*
                            occurrences of every element present in other)
  removeDupes  immediate -> ``remove_dupes``
  size         immediate -> ``.count``
  map / reduce / predicateCount -> ``map_rows`` / ``reduce`` /
                            ``predicate_count``

Representation: ``data`` is (capacity, width) int32 words holding the
reference's uint32 bits (compared as unsigned, ``types``), with the
logical content in rows [0, count); rows beyond are the sentinel, or
garbage that every operation masks.  ``count`` is a 0-d int32 tensor on
the list's device.  The list is unordered, so every operation is free to
permute rows; each is one lexsort (``types.lexsort_rows``) at most, and
the survivors are compacted in sorted order.

User functions are batched over a leading axis (``fn(rows)`` with rows
(m, width)), where the reference ``vmap``s per-row ones.  ``jax.ops.
segment_max`` over the runs of equal rows is ``scatter_reduce(…,
"amax")`` over ``types.run_ids``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import device as _device
from . import types as T


class RoomyList(NamedTuple):
    data: torch.Tensor   # (capacity, width) int32, the reference's uint32 bits
    count: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def as_rows(rows, device=None) -> torch.Tensor:
    """(n, width) rows as an int32 tensor with the same 32 bits on
    ``device`` (default ``"cuda"``): a tensor is converted, anything else
    (numpy uint32 rows, nested lists) goes through numpy as uint32."""
    dev = _device.resolve(device)
    if isinstance(rows, torch.Tensor):
        return rows.to(dev, torch.int32)
    a = np.ascontiguousarray(np.asarray(rows).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(dev)


def segment_any(flags: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """Per row, whether any row of its run is flagged: ``jax.ops.
    segment_max`` of the 0/1 flags over the run ids, read back at each
    row's run.  Run ids are int32, so a sort holds fewer than 2³¹ rows."""
    n = rid.shape[0]
    if n >= 1 << 31:
        raise OverflowError(f"{n} rows overflow the int32 run ids")
    runs = torch.zeros(n, dtype=torch.int32, device=rid.device)
    idx = rid.to(torch.int64)
    runs = runs.scatter_reduce(0, idx, flags.to(torch.int32), "amax",
                               include_self=True)
    return runs[idx] == 1


def make(capacity: int, width: int, device=None) -> RoomyList:
    """An empty list on ``device`` (default ``"cuda"``)."""
    dev = _device.resolve(device)
    return RoomyList(T.sentinel_rows(capacity, width, dev),
                     torch.zeros((), dtype=torch.int32, device=dev))


def from_rows(rows, capacity: int | None = None, device=None) -> RoomyList:
    """A list holding ``rows`` (a tensor or uint32 array-like)."""
    rows = as_rows(rows, device)
    n, w = rows.shape
    rl, _ = add(make(capacity or n, w, rows.device), rows)
    return rl


def valid_mask(rl: RoomyList) -> torch.Tensor:
    return torch.arange(rl.capacity, device=rl.data.device) < rl.count


def add(rl: RoomyList, rows: torch.Tensor, valid: torch.Tensor | None = None):
    """Append a batch of rows. Returns (list, overflow)."""
    if valid is None:
        valid = torch.ones(rows.shape[0], dtype=torch.bool,
                           device=rows.device)
    data, count, overflow = T.append_block(rl.data, rl.count,
                                           rows.to(torch.int32), valid)
    return RoomyList(data, count), overflow


def add_all(dst: RoomyList, src: RoomyList):
    """dst += src (multiset union, keeps duplicates) — paper's addAll."""
    return add(dst, src.data, valid_mask(src))


def remove(rl: RoomyList, rows: torch.Tensor,
           valid: torch.Tensor | None = None) -> RoomyList:
    """Remove all occurrences of each given row — paper's delayed remove."""
    other, _ = add(make(rows.shape[0], rows.shape[1], rl.data.device),
                   rows, valid)
    return remove_all(rl, other)


def remove_all(a: RoomyList, b: RoomyList) -> RoomyList:
    """a -= b: drop every a-row that occurs (at least once) in b.  One
    lexsort; the survivors are compacted in sorted order."""
    na, nb = a.capacity, b.capacity
    dev = a.data.device
    rows = torch.cat([a.data, b.data])
    tag_b = torch.cat([torch.zeros(na, dtype=torch.bool, device=dev),
                       valid_mask(b)])
    from_a = torch.cat([valid_mask(a),
                        torch.zeros(nb, dtype=torch.bool, device=dev)])
    perm = T.lexsort_rows(rows)
    rows_s = rows[perm]
    keep_s = from_a[perm] & ~segment_any(tag_b[perm], T.run_ids(rows_s))
    data, count = T.compact_valid_first(rows_s, keep_s)
    return RoomyList(data[:na], count)


def remove_dupes(rl: RoomyList) -> RoomyList:
    """Collapse the multiset to a set — paper's removeDupes.  Slots past
    count are masked to sentinel first: they may hold garbage."""
    rows = torch.where(valid_mask(rl)[:, None], rl.data, -1)
    rows_s = rows[T.lexsort_rows(rows)]
    keep_s = T.first_of_run(rows_s) & T.rows_valid(rows_s)
    data, count = T.compact_valid_first(rows_s, keep_s)
    return RoomyList(data, count)


def member_mask(rl: RoomyList, queries: torch.Tensor) -> torch.Tensor:
    """(m,) bool — which query rows occur in the list."""
    m = queries.shape[0]
    dev = rl.data.device
    rows = torch.cat([rl.data, queries.to(torch.int32)])
    tag = torch.cat([valid_mask(rl),
                     torch.zeros(m, dtype=torch.bool, device=dev)])
    perm = T.lexsort_rows(rows)
    hit_s = segment_any(tag[perm], T.run_ids(rows[perm]))
    hits = torch.empty(rows.shape[0], dtype=torch.bool, device=dev)
    hits[perm] = hit_s
    return hits[rl.capacity:]


def map_rows(rl: RoomyList, fn: Callable):
    """fn over every slot, batched: ``fn(data)`` with data (capacity,
    width).  Slots past count flow through too; mask with ``valid_mask``
    where it matters."""
    return fn(rl.data)


def reduce(rl: RoomyList, elt_fn: Callable, merge_fn: Callable,
           identity) -> torch.Tensor:
    """Paper's reduce: merge_fn must be associative and commutative with
    ``identity`` as its unit (undefined order, as the paper warns)."""
    vals = elt_fn(rl.data)
    ident = torch.as_tensor(identity, dtype=vals.dtype, device=vals.device)
    mask = valid_mask(rl).reshape((-1,) + (1,) * (vals.ndim - 1))
    return T.tree_reduce(torch.where(mask, vals, ident), merge_fn, identity)


def predicate_count(rl: RoomyList, pred: Callable) -> torch.Tensor:
    return (pred(rl.data) & valid_mask(rl)).sum(dtype=torch.int32)


def to_numpy(rl) -> np.ndarray:
    """The logical content as (count, width) uint32 rows (host side)."""
    data = rl.data.cpu().numpy().view(np.uint32)
    return data[:int(rl.count)].copy()
