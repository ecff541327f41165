"""RoomySet — the native set the paper names as future work, §3 (port of
``repro/core/rset.py``).

Rows are kept **sorted-unique** (sentinel-padded), so every set operation
is ONE lexsort and one merge pass:

  union         merge + dedup          capacity na + nb
  intersection  rows present in both   capacity max(na, nb)
  difference    rows present only in A capacity max(na, nb)
  member_mask   sorted-merge probe

Rows are int32 words holding the reference's uint32 bits, compared as
unsigned; ``count`` is a 0-d int32 tensor on the set's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rlist as RL
from . import types as T


class RoomySet(NamedTuple):
    data: torch.Tensor   # (capacity, width) int32, sorted-unique then sentinel
    count: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def _normalize(rows: torch.Tensor, valid: torch.Tensor) -> RoomySet:
    """Sort, dedup, compact — establish the invariant with ONE lexsort; the
    kept rows are in sorted order already, so the compaction keeps it."""
    rows = torch.where(valid[:, None], rows, -1)
    rows_s = rows[T.lexsort_rows(rows)]
    keep = T.first_of_run(rows_s) & T.rows_valid(rows_s)
    return RoomySet(*T.compact_valid_first(rows_s, keep))


def make(capacity: int, width: int, device=None) -> RoomySet:
    """An empty set on ``device`` (default ``"cuda"``)."""
    return RoomySet(*RL.make(capacity, width, device))


def from_rows(rows, capacity: int | None = None, device=None) -> RoomySet:
    """The set of ``rows`` (a tensor or uint32 array-like)."""
    rows = RL.as_rows(rows, device)
    n, w = rows.shape
    capacity = capacity or n
    rows = torch.cat([rows, T.sentinel_rows(capacity - n, w, rows.device)])
    return _normalize(rows, torch.arange(capacity, device=rows.device) < n)


def from_list(rl: RL.RoomyList) -> RoomySet:
    return _normalize(rl.data, RL.valid_mask(rl))


def _merge(a: RoomySet, b: RoomySet, keep_rule: str) -> RoomySet:
    """One sorted-merge pass implementing union/intersection/difference.

    keep_rule: 'any' (union) | 'both' (intersection) | 'a_only' (difference)
    """
    na, nb = a.capacity, b.capacity
    dev = a.data.device
    rows = torch.cat([a.data, b.data])
    from_a = torch.arange(na + nb, device=dev) < na
    perm = T.lexsort_rows(rows)
    rows_s, from_a_s = rows[perm], from_a[perm]
    valid_s = T.rows_valid(rows_s)
    rid = T.run_ids(rows_s)
    first = T.first_of_run(rows_s) & valid_s
    if keep_rule == "any":
        keep = first
    elif keep_rule == "both":
        keep = (first & RL.segment_any(from_a_s & valid_s, rid)
                & RL.segment_any(~from_a_s & valid_s, rid))
    elif keep_rule == "a_only":
        keep = (first & RL.segment_any(from_a_s & valid_s, rid)
                & ~RL.segment_any(~from_a_s & valid_s, rid))
    else:
        raise ValueError(keep_rule)
    data, count = T.compact_valid_first(rows_s, keep)
    return RoomySet(data[:na + nb if keep_rule == "any" else max(na, nb)],
                    count)


def union(a: RoomySet, b: RoomySet) -> RoomySet:
    """Native |: one pass (capacity grows to na + nb)."""
    return _merge(a, b, "any")


def intersection(a: RoomySet, b: RoomySet) -> RoomySet:
    """Native &: ONE pass — the primitive the paper planned."""
    return _merge(a, b, "both")


def difference(a: RoomySet, b: RoomySet) -> RoomySet:
    """Native −: one pass."""
    return _merge(a, b, "a_only")


def member_mask(s: RoomySet, queries: torch.Tensor) -> torch.Tensor:
    return RL.member_mask(RL.RoomyList(s.data, s.count), queries)


def size(s: RoomySet) -> torch.Tensor:
    return s.count


def to_numpy(s: RoomySet) -> np.ndarray:
    return RL.to_numpy(s)
