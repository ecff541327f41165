"""Element codecs and low-level helpers shared by the Roomy data structures
(port of ``repro/core/types.py``).

Roomy elements are fixed-width records: a row of ``width`` 32-bit words.
The reference keeps them as uint32; the port keeps the same bits in int32
tensors (torch has no usable uint32 arithmetic on the CPU), so every
comparison that orders words, and every hash, works on the words read as
unsigned.  The all-ones row is reserved as the *sentinel* ("empty slot"),
which as int32 is -1 in every word; read as unsigned it is the largest
row, so sentinel rows sort last, as the reference relies on.

``index_drop`` gives JAX's ``.at[i].set/add(mode="drop")`` indexing to the
ports of ``array``, ``bitarray``, ``delayed`` and ``hashtable``: an index
in [-size, 0) wraps once, any other outside [0, size) drops.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import obs

UINT32_MASK = 0xFFFFFFFF

# The reference counts, when lexsort_rows and append_block are traced, the
# multi-key lexsorts and append-scatters a computation contains; the port
# runs eagerly, so here each call counts once.  The Tier J sorted BFS level
# budget is 1 lexsort + 1 scatter.
SORT_STATS = obs.counters("tierj", {"lexsorts": 0, "scatters": 0})


def reset_sort_stats() -> None:
    for k in SORT_STATS:
        SORT_STATS[k] = 0


def index_drop(idx: torch.Tensor, size: int):
    """JAX's scatter index rule for ``mode="drop"``: returns (int64 index
    with [-size, 0) wrapped, bool mask of the indices that land)."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


def index_clip(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather index rule: [-size, 0) wraps once, then clamps into
    [0, size)."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1)


def scatter_drop(buf: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` out of place: returns a copy
    of ``buf`` with the landing rows written (indices that land are unique
    at every call site).  A dropped value is written to one spare row past
    the end, which the result leaves out: no boolean mask selects the
    rows, so the call reads no data back to the host and its shapes do not
    depend on the data (a fake tensor traces it)."""
    n = buf.shape[0]
    idx, keep = index_drop(idx, n)
    out = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    out = out.index_put((torch.where(keep, idx, n),), vals.to(buf.dtype))
    return out[:n]


def sentinel_rows(n: int, width: int, device=None) -> torch.Tensor:
    """(n, width) block of sentinel (all-ones) rows."""
    return torch.full((n, width), -1, dtype=torch.int32, device=device)


def is_sentinel(rows: torch.Tensor) -> torch.Tensor:
    """(n,) bool — True where the row is the reserved empty marker."""
    return (rows == -1).all(dim=-1)


def rows_valid(rows: torch.Tensor) -> torch.Tensor:
    return ~is_sentinel(rows)


def _unsigned(col: torch.Tensor) -> torch.Tensor:
    return col.to(torch.int64) & UINT32_MASK


def lexsort_columns(rows: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting rows by their words read as unsigned,
    word 0 most significant.  Words go two at a time into one int64 key
    (high word first, shifted so that signed order is unsigned order:
    (hi - 2³¹)·2³² + lo, which cannot overflow), and the keys are
    sorted with stable passes, last key first."""
    n, w = rows.shape
    perm = torch.arange(n, device=rows.device)
    for hi in range(w - 2 + w % 2, -1, -2):
        r = rows[perm]
        if hi + 1 < w:
            key = ((_unsigned(r[:, hi]) - (1 << 31)) * (1 << 32)
                   + _unsigned(r[:, hi + 1]))
        else:
            key = _unsigned(r[:, hi])
        perm = perm[torch.sort(key, stable=True).indices]
    return perm


def lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows lexicographically (word 0 most significant,
    words unsigned).  Stable, so equal rows keep their relative order."""
    SORT_STATS["lexsorts"] += 1
    return lexsort_columns(rows)


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def first_of_run(sorted_rows: torch.Tensor) -> torch.Tensor:
    """(n,) bool — True at the first element of each equal-run."""
    neq = (sorted_rows[1:] != sorted_rows[:-1]).any(dim=-1)
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=sorted_rows.device), neq])


def run_ids(sorted_rows: torch.Tensor) -> torch.Tensor:
    """Segment ids of equal-runs in sorted rows: dense int32 from 0."""
    return (torch.cumsum(first_of_run(sorted_rows).to(torch.int32), 0)
            - 1).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2³² for int64 h in [0, 2³²), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & UINT32_MASK


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def hash_rows(rows: torch.Tensor, seed: int = 0x9E3779B9) -> torch.Tensor:
    """Deterministic 32-bit mix hash of each row, as int32 bits: the
    reference's FNV-ish multiply/xor fold, computed in int64 modulo 2³²."""
    h = torch.full(rows.shape[:-1], seed, dtype=torch.int64,
                   device=rows.device)
    for j in range(rows.shape[-1]):
        h = _mul32(h ^ _unsigned(rows[..., j]), 0x01000193)
        h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return to_int32_bits(h)


def compact_valid_first(rows: torch.Tensor, valid: torch.Tensor):
    """Stable-partition rows so valid ones come first; invalid → sentinel.
    Returns (rows, count) with count a 0-d int32 tensor."""
    perm = torch.sort((~valid).to(torch.uint8), stable=True).indices
    rows = rows[perm]
    valid = valid[perm]
    rows = torch.where(valid[:, None], rows, -1).to(rows.dtype)
    return rows, valid.sum(dtype=torch.int32)


def _expand(flags: torch.Tensor, ndim: int) -> torch.Tensor:
    return flags.reshape(flags.shape + (1,) * (ndim - flags.ndim))


def segmented_reduce_last(vals: torch.Tensor, starts: torch.Tensor,
                          combine: Callable) -> torch.Tensor:
    """Segmented inclusive scan; position i holds the combine of its
    segment prefix, so the *last* position of each segment holds the
    segment total.

    vals: (n, ...) payloads in segment order; starts: (n,) bool, True at
    segment starts; combine(a, b): associative payload combiner, batched
    over a leading axis.  A log-step (Hillis–Steele) scan of the
    reference's flagged operator ``(fl | fr, fr ? vr : combine(vl, vr))``.
    """
    n = vals.shape[0]
    flags = starts.to(torch.bool)
    k = 1
    while k < n:
        fr = flags[k:]
        right = vals[k:]
        step = torch.where(_expand(fr, vals.ndim), right,
                           combine(vals[:-k], right)).to(vals.dtype)
        vals = torch.cat([vals[:k], step])
        flags = torch.cat([flags[:k], flags[:-k] | fr])
        k *= 2
    return vals


def tree_reduce(vals: torch.Tensor, merge: Callable, identity) -> torch.Tensor:
    """Log-depth reduction of vals (leading axis) with a user monoid; pads
    to a power of two with ``identity`` (merge(identity, x) == x)."""
    n = vals.shape[0]
    pow2 = pad_pow2(n)
    if pow2 != n:
        ident = torch.as_tensor(identity, dtype=vals.dtype, device=vals.device)
        pad = ident.expand((pow2 - n,) + tuple(vals.shape[1:]))
        vals = torch.cat([vals, pad])
    x = vals
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = merge(x[:half], x[half:])
    return x[0]


def append_block(buf: torch.Tensor, count: torch.Tensor, block: torch.Tensor,
                 valid: torch.Tensor):
    """Append the valid rows of ``block`` to ``buf`` starting at ``count``.

    Returns (buf, new_count, overflow): valid rows land at [count,
    count + nvalid); writes past capacity drop and ``overflow`` is set so
    callers can re-run with a larger capacity.  Out of place."""
    SORT_STATS["scatters"] += 1
    cap = buf.shape[0]
    v = valid.to(torch.int32)
    nvalid = v.sum(dtype=torch.int32)
    dest = count + torch.cumsum(v, 0) - 1
    dest = torch.where(valid, dest, cap)
    new_buf = scatter_drop(buf, dest, block)
    new_count = torch.clamp(count + nvalid, max=cap).to(torch.int32)
    return new_buf, new_count, count + nvalid > cap


def pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
