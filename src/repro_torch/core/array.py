"""RoomyArray — fixed-size indexed array with *delayed* update ops (port of
``repro/core/array.py``).

Random-access ``update(i, payload)`` operations are queued, and ``sync``
executes the whole batch as one streaming pass:

    sort queue by index  →  segment-combine payloads per index
                         →  apply(old, aggregate) at each touched index.

When ``combine`` and ``apply`` are both this module's ``add`` and the data
and payloads are float32, the segment-combine and apply collapse into one
launch of the segment scatter-add kernel (K5, ``kernels/ops.
bucket_scatter_add``) on the sorted queue: each index is one run of the
sorted ops, summed in float32 and added to its row.  That is the
reference's result within float32 rounding (the sum's order differs).
Every other combine, apply or dtype takes the reference's sort →
``segmented_reduce_last`` → scatter path; so does int32 addition, which
K5's float32 sums would round above 2²⁴.

Elements may have any dtype and trailing shape.  User functions are
batched over a leading axis, where the reference ``vmap``s per-element
ones: ``pred(elts) -> (m,) bool``, ``fn(indices, elts)``, ``combine(a,
b)`` and ``apply(old, agg)``.  A function written with ``...`` indexing
(``x[..., 0] > 0``) serves both packages.

Determinism (paper §3 "chain reduction"): sync applies updates against the
*old* array only, so queued updates never observe each other's writes.
Indices follow JAX's scatter rule: [-n, 0) wraps, the rest outside [0, n)
drops.  The predicate count is maintained incrementally during sync:
Σ pred(new) − Σ pred(old) over touched slots.  On the K5 route an op that
drops changes no count; the reference's scatter path also counts a
dropped op below -n, through its clamped read, and the port's scatter
path does the same.

Counts (``q_n``, ``pcount``) are 0-d int32 tensors on the array's device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..kernels import ops as K
from . import types as T


class RoomyArray(NamedTuple):
    data: torch.Tensor      # (n, *elt_shape)
    q_idx: torch.Tensor     # (qcap,) int32 — target index, == n when empty
    q_pay: torch.Tensor     # (qcap, *pay_shape)
    q_n: torch.Tensor       # () int32
    pcount: torch.Tensor    # () int32 — live predicate count (0 if unused)

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def queue_capacity(self) -> int:
        return self.q_idx.shape[0]


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Addition as a combine or apply: ``sync(ra, add, add)`` on float32
    data takes K5."""
    return a + b


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def make(data: torch.Tensor, queue_capacity: int, payload_shape: tuple = (),
         payload_dtype=torch.int32,
         pred: Optional[Callable] = None) -> RoomyArray:
    """A RoomyArray over ``data`` (kept, not copied) on data's device."""
    n, dev = data.shape[0], data.device
    q_idx = torch.full((queue_capacity,), n, dtype=torch.int32, device=dev)
    q_pay = torch.zeros((queue_capacity,) + tuple(payload_shape),
                        dtype=payload_dtype, device=dev)
    if pred is not None:
        pcount = _count(pred(data))
    else:
        pcount = torch.zeros((), dtype=torch.int32, device=dev)
    return RoomyArray(data, q_idx, q_pay,
                      torch.zeros((), dtype=torch.int32, device=dev), pcount)


def update(ra: RoomyArray, idx: torch.Tensor, payload: torch.Tensor,
           valid: Optional[torch.Tensor] = None):
    """Queue a batch of delayed updates. Returns (array, overflow)."""
    if valid is None:
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    qcap = ra.queue_capacity
    v = valid.to(torch.int32)
    dest = torch.where(valid, ra.q_n + torch.cumsum(v, 0) - 1, qcap)
    q_idx = T.scatter_drop(ra.q_idx, dest, idx.to(torch.int32))
    q_pay = T.scatter_drop(ra.q_pay, dest, payload)
    nvalid = _count(valid)
    overflow = ra.q_n + nvalid > qcap
    q_n = torch.clamp(ra.q_n + nvalid, max=qcap).to(torch.int32)
    return ra._replace(q_idx=q_idx, q_pay=q_pay, q_n=q_n), overflow


def access(ra: RoomyArray, idx: torch.Tensor) -> torch.Tensor:
    """Batched random read (the resolved form of delayed access ops), with
    the reference's gather rule for indices outside [0, n)."""
    return ra.data[T.index_clip(idx, ra.size)]


def _takes_k5(ra: RoomyArray, combine: Callable, apply: Callable) -> bool:
    return (combine is add and apply is add
            and ra.data.dtype == torch.float32
            and ra.q_pay.dtype == torch.float32
            and ra.q_pay.shape[1:] == ra.data.shape[1:])


def sync(ra: RoomyArray, combine: Callable, apply: Callable,
         pred: Optional[Callable] = None, impl: str = "auto") -> RoomyArray:
    """Execute all queued updates in one streaming batch.

    combine(p1, p2): associative+commutative merge of two payloads aimed at
        one index (batched over a leading axis).
    apply(old_elt, agg_payload) -> new_elt: applied once per touched index.
    pred: if given, the live predicate count is maintained incrementally.
    impl: K5's dispatch on the ``add``/``add`` float32 route (``"auto"``,
        ``"cuda"`` or ``"ref"``, as ``kernels/ops.py``).
    """
    n = ra.size
    qcap = ra.queue_capacity
    if qcap == 0:               # nothing can be queued: sync is a no-op
        return ra
    dev = ra.data.device
    in_q = torch.arange(qcap, device=dev) < ra.q_n
    idx = torch.where(in_q, ra.q_idx, n)            # park empties at n
    order = torch.sort(idx, stable=True).indices
    idx_s = idx[order].contiguous()
    pay_s = ra.q_pay[order]
    last = torch.cat([idx_s[1:] != idx_s[:-1],
                      torch.ones(1, dtype=torch.bool, device=dev)])
    target = torch.where(last & (idx_s < n), idx_s, n)
    pcount = ra.pcount
    if _takes_k5(ra, combine, apply):
        data = K.bucket_scatter_add(ra.data.reshape(n, -1), idx_s,
                                    pay_s.reshape(qcap, -1), impl=impl)
        data = data.reshape(ra.data.shape)
        if pred is not None:
            rows, touched = T.index_drop(target, n)
            rows = rows.clamp(0, n - 1)
            po = pred(ra.data[rows]) & touched
            pn = pred(data[rows]) & touched
            pcount = pcount + _count(pn) - _count(po)
    else:
        starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            idx_s[1:] != idx_s[:-1]])
        agg = T.segmented_reduce_last(pay_s, starts, combine)
        old = ra.data[T.index_clip(torch.clamp(target, max=n - 1), n)]
        new = apply(old, agg)
        data = T.scatter_drop(ra.data, target, new)
        if pred is not None:
            touched = target < n
            po = pred(old) & touched
            pn = pred(new) & touched
            pcount = pcount + _count(pn) - _count(po)
    q_idx = torch.full((qcap,), n, dtype=torch.int32, device=dev)
    return RoomyArray(data, q_idx, torch.zeros_like(ra.q_pay),
                      torch.zeros((), dtype=torch.int32, device=dev),
                      pcount.to(torch.int32))


def map_elements(ra: RoomyArray, fn: Callable) -> torch.Tensor:
    """The paper's map: fn(indices, elements) over the whole array."""
    return fn(torch.arange(ra.size, device=ra.data.device), ra.data)


def map_update(ra: RoomyArray, fn: Callable) -> RoomyArray:
    """Streaming transform: data[i] = fn(i, data[i]), out of place."""
    new = fn(torch.arange(ra.size, device=ra.data.device), ra.data)
    return ra._replace(data=new.to(ra.data.dtype))


def reduce(ra: RoomyArray, elt_fn: Callable, merge_fn: Callable, identity):
    vals = elt_fn(torch.arange(ra.size, device=ra.data.device), ra.data)
    return T.tree_reduce(vals, merge_fn, identity)


def predicate_count(ra: RoomyArray) -> torch.Tensor:
    """The incrementally-maintained count (see module docstring)."""
    return ra.pcount
