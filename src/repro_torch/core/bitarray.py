"""RoomyBitArray — packed 2-bit-element array (port of ``repro/core/bitarray.py``).

16 two-bit elements per 32-bit word (int32 tensors holding the uint32
bits), so N states cost N/8 bytes of device memory.  A permutation's rank
(``ranking.py``) is its index; the element value is a BFS mark.

Two delayed-update routes, as in the reference:

  * one device — ``update`` queues (index, value) ops like ``array.py``;
    ``sync(combine, apply)`` sorts the queue by index, segment-combines,
    and applies through a **disjoint-bit packed scatter**: per touched
    element a clear mask ``3 << shift`` and a value mask ``val << shift``
    are summed per word (distinct elements of one word occupy disjoint
    bits, so add == or), then ``data & ~clr | set``.  No unpacked copy of
    the array is made.

  * sharded — ``sharded_mark_sync`` bins the ops by owner rank and routes
    them through one all-to-all (``delayed.bucket_sync_update``), then
    applies them on the owner with ``mark_packed`` (K2).

``mark_rotate_count`` is the implicit-BFS hot path: the delayed-mark
scatter and the rotate+count LUT pass fused into one kernel launch (K1).
``mark_packed`` / ``rotate_count`` are the unfused halves (K2, K3), kept as
the reference composition.  All dispatch through ``kernels/ops.py``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import device as _device
from ..kernels import ops as K
from . import delayed as D
from . import types as T
from ..kernels.ref import FIELDS_PER_WORD, pack_fields, unpack_fields

# BFS mark values (the port's own copy of repro/core/disk/bitarray.py's);
# UNSEEN is 0 so a fresh array is all-unseen for free.
UNSEEN, CUR, NEXT, DONE = 0, 1, 2, 3

# LUT for the per-level rotate: CUR→DONE, NEXT→CUR, others fixed.
ROTATE_LUT = (UNSEEN << (2 * UNSEEN)) | (DONE << (2 * CUR)) \
    | (CUR << (2 * NEXT)) | (DONE << (2 * DONE))


class RoomyBitArray(NamedTuple):
    data: torch.Tensor    # (nwords,) int32 — packed 2-bit elements
    # The queue of delayed writes (``make(n, queue_capacity)``); an array
    # built from its words alone has none.
    q_idx: Optional[torch.Tensor] = None   # (qcap,) int32; capacity if empty
    q_val: Optional[torch.Tensor] = None   # (qcap,) int32 — values 0..3
    q_n: Optional[torch.Tensor] = None     # () int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0] * FIELDS_PER_WORD

    @property
    def queue_capacity(self) -> int:
        return 0 if self.q_idx is None else self.q_idx.shape[0]


def n_words(n: int) -> int:
    return -(-n // FIELDS_PER_WORD)


def make(n: int, queue_capacity: int = 0, device=None) -> RoomyBitArray:
    """An all-UNSEEN array of n elements with a queue of
    ``queue_capacity`` delayed writes, on ``device`` (default ``"cuda"``)."""
    dev = _device.resolve(device)
    w = n_words(n)
    return RoomyBitArray(
        data=torch.zeros(w, dtype=torch.int32, device=dev),
        q_idx=torch.full((queue_capacity,), w * FIELDS_PER_WORD,
                         dtype=torch.int32, device=dev),
        q_val=torch.zeros(queue_capacity, dtype=torch.int32, device=dev),
        q_n=torch.zeros((), dtype=torch.int32, device=dev))


# ------------------------------------------------------------ pack codec

def pack_values(vals: torch.Tensor) -> torch.Tensor:
    """(k,) values 0..3 → (ceil(k/16),) int32 words (tail fields padded 0)."""
    k = vals.shape[0]
    v = torch.zeros(n_words(k) * FIELDS_PER_WORD, dtype=torch.int32,
                    device=vals.device)
    v[:k] = vals.to(torch.int32)
    return pack_fields(v.view(-1, FIELDS_PER_WORD))


def unpack_values(data: torch.Tensor) -> torch.Tensor:
    """(w,) int32 words → (w·16,) int32 values 0..3."""
    return unpack_fields(data).reshape(-1)


def get(ba: RoomyBitArray, idx: torch.Tensor) -> torch.Tensor:
    """Batched random read of 2-bit elements."""
    return get_packed(ba.data, idx)


def get_packed(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.to(torch.int64)
    word = data[torch.clamp(idx // FIELDS_PER_WORD, 0, data.shape[0] - 1)]
    return (word >> (2 * (idx % FIELDS_PER_WORD))) & 3


# ------------------------------------------------------------ delayed ops

def update(ba: RoomyBitArray, idx: torch.Tensor, vals: torch.Tensor,
           valid: Optional[torch.Tensor] = None):
    """Queue delayed writes vals∈0..3 at idx. Returns (array, overflow)."""
    if valid is None:
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    qcap = ba.queue_capacity
    v = valid.to(torch.int32)
    dest = torch.where(valid, ba.q_n + torch.cumsum(v, 0) - 1, qcap)
    q_idx = T.scatter_drop(ba.q_idx, dest, idx.to(torch.int32))
    q_val = T.scatter_drop(ba.q_val, dest, vals.to(torch.int32) & 3)
    nvalid = v.sum(dtype=torch.int32)
    overflow = ba.q_n + nvalid > qcap
    q_n = torch.clamp(ba.q_n + nvalid, max=qcap).to(torch.int32)
    return ba._replace(q_idx=q_idx, q_val=q_val, q_n=q_n), overflow


def _packed_write(data: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Write 2-bit vals at UNIQUE element indices (>= capacity drops)
    without unpacking: disjoint-bit clear/set masks summed per word, in
    int64 so that ``3 << 30`` stays positive."""
    nw = data.shape[0]
    cap = nw * FIELDS_PER_WORD
    idx = idx.to(torch.int64)
    word = torch.where(idx < cap, idx // FIELDS_PER_WORD, nw)
    word, keep = T.index_drop(word, nw)
    sh = 2 * (idx % FIELDS_PER_WORD)
    clr = torch.zeros(nw, dtype=torch.int64, device=data.device)
    setm = torch.zeros_like(clr)
    clr.index_add_(0, word[keep], (3 << sh)[keep])
    setm.index_add_(0, word[keep], ((vals.to(torch.int64) & 3) << sh)[keep])
    return (data & ~T.to_int32_bits(clr)) | T.to_int32_bits(setm)


def sync(ba: RoomyBitArray, combine: Optional[Callable] = None,
         apply: Optional[Callable] = None) -> RoomyBitArray:
    """Execute queued updates in one batch (``array.sync``'s contract).

    combine(p1, p2): associative merge of values aimed at one index
    (default bitwise OR); apply(old, agg) -> new values at touched indices
    (default overwrite).  The index sort is an integer sort, never a row
    lexsort."""
    if combine is None:
        combine = torch.bitwise_or
    if apply is None:
        apply = lambda old, agg: agg  # noqa: E731
    qcap = ba.queue_capacity
    if qcap == 0:               # nothing can be queued: sync is a no-op
        return ba
    cap = ba.capacity
    dev = ba.data.device
    in_q = torch.arange(qcap, device=dev) < ba.q_n
    idx = torch.where(in_q, ba.q_idx, cap)
    order = torch.sort(idx, stable=True).indices
    idx_s = idx[order]
    val_s = ba.q_val[order]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    starts = torch.cat([one, idx_s[1:] != idx_s[:-1]])
    agg = T.segmented_reduce_last(val_s, starts, combine)
    last = torch.cat([idx_s[1:] != idx_s[:-1], one])
    target = torch.where(last & (idx_s < cap), idx_s, cap)
    old = get_packed(ba.data, torch.clamp(target, max=cap - 1))
    data = _packed_write(ba.data, target, apply(old, agg))
    return RoomyBitArray(data, torch.full((qcap,), cap, dtype=torch.int32,
                                          device=dev),
                         torch.zeros(qcap, dtype=torch.int32, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))


# ------------------------------------------------------- BFS hot paths

def mark_packed(data: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor | None = None, *, mark: int = NEXT,
                only_if: int = UNSEEN, impl: str = "auto") -> torch.Tensor:
    """data[idx] ← mark where the element holds only_if — the delayed-mark
    apply (K2).  Safe under duplicate indices; invalid / out-of-range
    indices drop."""
    cap = data.shape[0] * FIELDS_PER_WORD
    idx = idx.to(torch.int32)
    if valid is not None:
        idx = torch.where(valid, idx, cap)
    return K.bitpack_scatter_mark(data, idx.contiguous(), mark=mark,
                                  only_if=only_if, impl=impl)


def rotate_count(data: torch.Tensor, n: int, *, lut: int = ROTATE_LUT,
                 count_val: int = CUR, impl: str = "auto"):
    """Map every element through the 4-entry lut and count elements that
    map to count_val among the first n (K3).  Returns (new_data, count).

    Arrays with tail padding (n < 16·words) require a zero-preserving lut
    (lut[0] == 0): the tail-count correction assumes padding fields hold
    0, which only a zero-preserving lut keeps true across calls."""
    pad = data.shape[0] * FIELDS_PER_WORD - n
    assert pad == 0 or (lut & 3) == 0, \
        "padded arrays need a zero-preserving lut (lut[0] == 0)"
    new, cnt = K.bitpack_lut_count(data, lut, count_val, impl=impl)
    if pad and (lut & 3) == count_val:  # padding fields hold 0 → lut[0]
        cnt = cnt - pad
    return new, cnt


def mark_rotate_count(data: torch.Tensor, idx: torch.Tensor, n: int, *,
                      lut: int = ROTATE_LUT, count_val: int = CUR,
                      mark: int = NEXT, only_if: int = UNSEEN,
                      impl: str = "auto", inplace: bool = False):
    """Fused per-level pass (K1): ``data[idx] ← mark`` where the element
    holds ``only_if``, THEN map every element through the lut and count
    elements mapping to ``count_val`` among the first n.  With
    ``inplace=True`` the words of ``data`` are overwritten.  Returns
    (new_data, count).

    Arrays with tail padding require a zero-preserving lut and mark
    indices within [0, n) — a mark landing in a padding field would break
    the tail-count correction."""
    pad = data.shape[0] * FIELDS_PER_WORD - n
    assert pad == 0 or (lut & 3) == 0, \
        "padded arrays need a zero-preserving lut (lut[0] == 0)"
    new, cnt = K.bitpack_mark_rotate_count(
        data, idx.to(torch.int32).contiguous(), lut, count_val, mark=mark,
        only_if=only_if, impl=impl, inplace=inplace)
    if pad and (lut & 3) == count_val:  # padding fields hold 0 → lut[0]
        cnt = cnt - pad
    return new, cnt


def count_value(ba: RoomyBitArray, value: int, n: int | None = None) -> int:
    """predicateCount for one 2-bit value over the first n elements."""
    n = ba.capacity if n is None else n
    return int((unpack_values(ba.data)[:n] == value).sum())


# ---------------------------------------------------------- sharded sync

def sharded_mark_sync(data_local: torch.Tensor, idx: torch.Tensor,
                      valid: torch.Tensor, group, nshards: int,
                      capacity: int, *, mark: int = NEXT,
                      only_if: int = UNSEEN, impl: str = "auto"):
    """Delayed mark sync across a process group of ``nshards`` ranks; every
    rank calls it with its own slice and ops.

    Elements are sharded contiguously: rank s owns global indices
    [s·E, (s+1)·E) with E = 16·len(data_local).  Ops are binned by owner
    (``delayed.bin_by_dest``), exchanged with one all-to-all, and applied
    on the owner with ``mark_packed`` (K2).  Returns (new_data_local,
    dropped) — ``dropped`` counts ops that overflowed their bucket, summed
    over the group."""
    elems_local = data_local.shape[0] * FIELDS_PER_WORD
    idx = idx.to(torch.int64)
    dest = torch.div(idx, elems_local, rounding_mode="floor")
    local = (idx - dest * elems_local).to(torch.int32)
    valid = valid & (dest >= 0) & (dest < nshards)

    def owner_apply(state, flat_local, flat_valid):
        return mark_packed(state, flat_local, flat_valid, mark=mark,
                           only_if=only_if, impl=impl)

    return D.bucket_sync_update(dest.to(torch.int32), local, valid, group,
                                nshards, capacity, owner_apply, data_local)
