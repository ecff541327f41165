"""RoomyHashTable — capacity-bounded key→value map with delayed ops (port of
``repro/core/hashtable.py``).

The table is kept as rows sorted by (hash(key), key): a sync is a sorted
merge of the queued batch against the table — one streaming pass, the
per-bucket merge Roomy performs on disk.

Operations (the paper's Table 1):
  insert/update  delayed   -> queued, executed by ``sync``
  remove         delayed   -> queued with a tombstone flag
  access         delayed   -> ``lookup`` (batched sorted-merge probe)
  sync/size/map/reduce/predicateCount -> immediate

Keys are (key_width,) rows of 32-bit words, int32 tensors holding the
reference's uint32 bits, compared as unsigned; values any dtype and shape.
The all-ones key is reserved (sentinel).  User functions are batched over
a leading axis (``combine(a, b)``, ``apply(old, agg, present)``,
``fn(keys, vals)``, ``pred(keys, vals)``), where the reference ``vmap``s
per-element ones.  Counts are 0-d int32 tensors on the table's device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import device as _device
from . import types as T

_INT64_MIN = -(1 << 63)


class RoomyHashTable(NamedTuple):
    keys: torch.Tensor    # (cap, kw) int32, (hash, key) order, sentinel-padded
    vals: torch.Tensor    # (cap, *vshape)
    count: torch.Tensor   # () int32
    q_keys: torch.Tensor  # (qcap, kw) int32
    q_vals: torch.Tensor  # (qcap, *vshape)
    q_del: torch.Tensor   # (qcap,) bool — tombstone flags
    q_n: torch.Tensor     # () int32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def key_width(self) -> int:
        return self.keys.shape[1]

    @property
    def queue_capacity(self) -> int:
        return self.q_keys.shape[0]


def _sort_key(keys: torch.Tensor) -> torch.Tensor:
    """Stable permutation by (hash(key) unsigned, key words unsigned...);
    sentinel keys take the largest hash so that they sort last."""
    h = torch.where(T.is_sentinel(keys), -1, T.hash_rows(keys))
    return T.lexsort_columns(torch.cat([h[:, None], keys], dim=1))


def _segment_max(vals: torch.Tensor, rid: torch.Tensor,
                 nseg: int) -> torch.Tensor:
    """``jax.ops.segment_max`` of int64 values (empty segments hold the
    int64 minimum; only non-empty ones are read)."""
    out = torch.full((nseg,), _INT64_MIN, dtype=torch.int64,
                     device=vals.device)
    return out.scatter_reduce(0, rid.to(torch.int64), vals.to(torch.int64),
                              "amax", include_self=True)


def _rows_like(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def make(capacity: int, key_width: int, queue_capacity: int,
         val_shape: tuple = (), val_dtype=torch.int32,
         device=None) -> RoomyHashTable:
    """An empty table on ``device`` (default ``"cuda"``)."""
    dev = _device.resolve(device)
    return RoomyHashTable(
        keys=T.sentinel_rows(capacity, key_width, dev),
        vals=torch.zeros((capacity,) + tuple(val_shape), dtype=val_dtype,
                         device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        q_keys=T.sentinel_rows(queue_capacity, key_width, dev),
        q_vals=torch.zeros((queue_capacity,) + tuple(val_shape),
                           dtype=val_dtype, device=dev),
        q_del=torch.zeros(queue_capacity, dtype=torch.bool, device=dev),
        q_n=torch.zeros((), dtype=torch.int32, device=dev))


def _queue(ht: RoomyHashTable, keys, vals, deletes, valid):
    qcap = ht.queue_capacity
    v = valid.to(torch.int32)
    dest = torch.where(valid, ht.q_n + torch.cumsum(v, 0) - 1, qcap)
    q_keys = T.scatter_drop(ht.q_keys, dest, keys.to(torch.int32))
    q_vals = T.scatter_drop(ht.q_vals, dest, vals)
    q_del = T.scatter_drop(ht.q_del, dest, deletes)
    nvalid = v.sum(dtype=torch.int32)
    overflow = ht.q_n + nvalid > qcap
    q_n = torch.clamp(ht.q_n + nvalid, max=qcap).to(torch.int32)
    return ht._replace(q_keys=q_keys, q_vals=q_vals, q_del=q_del,
                       q_n=q_n), overflow


def _valid(keys: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        valid = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    return valid & ~T.is_sentinel(keys)


def insert(ht: RoomyHashTable, keys: torch.Tensor, vals: torch.Tensor,
           valid: Optional[torch.Tensor] = None):
    """Queue delayed inserts/updates for a batch of (key, value) pairs.
    Returns (table, overflow)."""
    valid = _valid(keys, valid)
    return _queue(ht, keys, vals, torch.zeros_like(valid), valid)


def remove(ht: RoomyHashTable, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None):
    """Queue delayed removals. Returns (table, overflow)."""
    valid = _valid(keys, valid)
    vals = torch.zeros((keys.shape[0],) + tuple(ht.q_vals.shape[1:]),
                       dtype=ht.q_vals.dtype, device=keys.device)
    return _queue(ht, keys, vals, torch.ones_like(valid), valid)


def sync(ht: RoomyHashTable, combine: Optional[Callable] = None,
         apply: Optional[Callable] = None):
    """Execute all queued ops as one sorted merge (streaming pass).
    Returns (table, overflow).

    combine(v1, v2): merges two queued payloads for one key, folded in
        ISSUE ORDER (default: last wins).
    apply(old_val, agg, present): present says whether the key already
        existed.  Default: insert/overwrite with agg.

    The op log executes in order per key, as Tier D's ``DiskHashTable.
    sync`` does: a DEL wipes the key and every earlier queued PUT, and the
    PUTs after the last DEL resurrect it — their fold applies against
    ``present=False`` (``old`` reads as zeros).  A key whose last op is DEL
    is removed."""
    if combine is None:
        combine = lambda a, b: b  # noqa: E731
    if apply is None:
        apply = lambda old, agg, present: agg  # noqa: E731

    cap, qcap = ht.capacity, ht.queue_capacity
    dev = ht.keys.device
    in_q = torch.arange(qcap, device=dev) < ht.q_n
    qk = torch.where(in_q[:, None], ht.q_keys, -1)

    all_keys = torch.cat([ht.keys, qk])
    all_vals = torch.cat([ht.vals, ht.q_vals])
    from_tab = torch.cat([torch.arange(cap, device=dev) < ht.count,
                          torch.zeros(qcap, dtype=torch.bool, device=dev)])
    is_del = torch.cat([torch.zeros(cap, dtype=torch.bool, device=dev),
                        ht.q_del & in_q])

    perm = _sort_key(all_keys)
    k_s, v_s = all_keys[perm], all_vals[perm]
    tab_s, del_s = from_tab[perm], is_del[perm]
    valid_s = ~T.is_sentinel(k_s)

    rid = T.run_ids(k_s)
    nseg = cap + qcap
    starts = T.first_of_run(k_s)
    pos = torch.arange(nseg, device=dev)
    qrow = valid_s & ~tab_s

    # Sequential per-key semantics: within a run the stable sort yields
    # [table row?, queue rows in issue order].  Everything at or before a
    # key's LAST DEL is wiped; the PUTs strictly after it are live.
    run_pos = pos - torch.cummax(torch.where(starts, pos, 0), 0).values
    last_del = _segment_max(torch.where(del_s & qrow, run_pos, -1), rid, nseg)
    live_s = qrow & ~del_s & (run_pos > last_del[rid])

    # Combine-fold over the live PUTs only, in issue order: every non-live
    # row restarts a segment, and so does the first live row after one —
    # live rows are a contiguous run suffix, so the run's last row then
    # carries the fold of exactly the live PUTs.
    prev_live = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                           live_s[:-1]])
    agg = T.segmented_reduce_last(v_s, starts | ~live_s | ~prev_live, combine)

    run_has_tab = _segment_max(tab_s, rid, nseg)[rid] == 1
    run_had_del = _segment_max(del_s & qrow, rid, nseg)[rid] == 1
    run_has_live = _segment_max(live_s, rid, nseg)[rid] == 1
    # sorted position of the run's table row, or -1 (the stable sort puts
    # the unique table row first in its run)
    run_tab_idx = _segment_max(torch.where(tab_s, pos, -1), rid, nseg)[rid]

    # A DEL wiped the stored value: resurrecting PUTs apply as inserts.
    present = run_has_tab & ~run_had_del
    deleted = run_had_del & ~run_has_live
    old = torch.where(_rows_like(present, v_s.ndim),
                      v_s[run_tab_idx.clamp(min=0)], torch.zeros_like(v_s))
    new_val = apply(old, agg, present)

    # Survivors: one row per run — the run's last row when it is live (it
    # carries the fold of the live PUTs); pure-table runs keep their table
    # row unless their key was deleted.
    run_last = torch.cat([rid[1:] != rid[:-1],
                          torch.ones(1, dtype=torch.bool, device=dev)])
    keep_tab_row = tab_s & ~run_has_live & ~deleted
    keep_q_row = live_s & run_last
    keep = (keep_tab_row | keep_q_row) & valid_s
    out_val = torch.where(_rows_like(keep_q_row, new_val.ndim), new_val,
                          v_s).to(ht.vals.dtype)

    # Compact survivors (stable: keeps the (hash, key) order).
    cperm = torch.sort((~keep).to(torch.uint8), stable=True).indices
    k_c, v_c, kept = k_s[cperm], out_val[cperm], keep[cperm]
    k_c = torch.where(kept[:, None], k_c, -1)
    count = keep.sum(dtype=torch.int32)
    new_ht = RoomyHashTable(
        keys=k_c[:cap], vals=v_c[:cap],
        count=torch.clamp(count, max=cap).to(torch.int32),
        q_keys=T.sentinel_rows(qcap, ht.key_width, dev),
        q_vals=torch.zeros_like(ht.q_vals),
        q_del=torch.zeros(qcap, dtype=torch.bool, device=dev),
        q_n=torch.zeros((), dtype=torch.int32, device=dev))
    return new_ht, count > cap


def lookup(ht: RoomyHashTable, queries: torch.Tensor):
    """Batched access: returns (vals, found). Streaming sorted-merge probe."""
    m = queries.shape[0]
    cap = ht.capacity
    dev = ht.keys.device
    all_keys = torch.cat([ht.keys, queries.to(torch.int32)])
    from_tab = torch.cat([torch.arange(cap, device=dev) < ht.count,
                          torch.zeros(m, dtype=torch.bool, device=dev)])
    perm = _sort_key(all_keys)
    k_s, tab_s = all_keys[perm], from_tab[perm]
    rid = T.run_ids(k_s)
    nseg = cap + m
    hit_idx_s = _segment_max(torch.where(tab_s, perm, -1), rid, nseg)[rid]
    hit_idx = torch.full((nseg,), -1, dtype=torch.int64, device=dev)
    hit_idx[perm] = hit_idx_s
    hit_idx_q = hit_idx[cap:]
    found = (hit_idx_q >= 0) & ~T.is_sentinel(queries)
    return ht.vals[hit_idx_q.clamp(min=0)], found


def size(ht: RoomyHashTable) -> torch.Tensor:
    return ht.count


def map_items(ht: RoomyHashTable, fn: Callable):
    """fn(keys, vals) over the whole table (empty slots included — mask
    with arange < count on the caller's side)."""
    return fn(ht.keys, ht.vals)


def reduce(ht: RoomyHashTable, elt_fn: Callable, merge_fn: Callable,
           identity):
    vals = elt_fn(ht.keys, ht.vals)
    mask = _rows_like(torch.arange(ht.capacity, device=ht.keys.device)
                      < ht.count, vals.ndim)
    vals = torch.where(mask, vals, torch.as_tensor(identity, dtype=vals.dtype,
                                                   device=vals.device))
    return T.tree_reduce(vals, merge_fn, identity)


def predicate_count(ht: RoomyHashTable, pred: Callable) -> torch.Tensor:
    hits = pred(ht.keys, ht.vals) & (torch.arange(ht.capacity,
                                                  device=ht.keys.device)
                                     < ht.count)
    return hits.sum(dtype=torch.int32)
