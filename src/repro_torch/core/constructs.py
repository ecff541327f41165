"""The paper's §3 programming constructs (port of ``repro/core/constructs.py``):
chain reduction, parallel prefix and pair reduction on a ``RoomyArray``
(``:69-130``), and the implicit BFS over a packed 2-bit array
(``:234-295``).

Chain reduction ``a[i] = f(a[i], a[i-1])`` issues ``update(i+1, a[i])``
for every i and syncs, so every write reads the old array.  Parallel
prefix is ⌈log₂ n⌉ chain reductions with the stride doubling.  Each index
receives at most one update a round, so the sync's combine never runs;
when the user's combine is ``array.add`` the round hands the sync
``combine=add, apply=add``, which on float32 data is one launch of the
segment scatter-add kernel (K5), and the result is the same.

The implicit BFS is the paper's second engine: a state IS its rank, an
index into a ``RoomyBitArray`` of BFS marks, so a level needs no frontier
list, no sort and no duplicate elimination.  Per level:

1. expand: the CUR states' neighbour ranks become one int32 target buffer;
2. mark every target NEXT where it is UNSEEN, rotate CUR→DONE and
   NEXT→CUR, and count the new CUR states.

The JAX level vmaps the neighbour function over every index and sends the
non-CUR rows to a trash target.  Here only the CUR states are expanded
(``torch.nonzero`` over the unpacked fields), in fixed-size chunks, so a
level never holds a permutation tensor for its whole frontier.  The marks
are identical: trash targets are dropped either way.

Pass budget (``docs/architecture.md`` pass-budget contract): step 2 is one
K1 launch per level when fused, or K2 then K3 once each when not.  The
fused path updates the packed words in place.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from . import array as RA
from . import bitarray as BA
from . import obs
from . import types as T

# ------------------------------------------------------- chain reduction

def _chain_round(ra: RA.RoomyArray, combine: Callable, stride: int,
                 impl: str) -> RA.RoomyArray:
    """a[i] = combine(a[i], a[i - stride]) for i >= stride, old values
    throughout: one batch of delayed updates and one sync."""
    n = ra.size
    idx = torch.arange(n, dtype=torch.int32, device=ra.data.device) + stride
    ra, _ = RA.update(ra, idx, ra.data, idx < n)
    if combine is RA.add:
        return RA.sync(ra, RA.add, RA.add, impl=impl)
    return RA.sync(ra, combine=lambda p, q: p,
                   apply=lambda old, pay: combine(old, pay), impl=impl)


def chain_reduce(ra: RA.RoomyArray, combine: Callable,
                 impl: str = "auto") -> RA.RoomyArray:
    """a[i] = combine(a[i], a[i-1]) for i in 1..N-1, old values throughout
    (paper §3: map issues update(i+1, a[i]); sync applies them against the
    old state).  The queue must hold N - 1 payloads of the data's shape."""
    return _chain_round(ra, combine, 1, impl)


def parallel_prefix(ra: RA.RoomyArray, combine: Callable,
                    impl: str = "auto") -> RA.RoomyArray:
    """Inclusive scan via ⌈log₂ N⌉ chain reductions with stride doubling."""
    k = 1
    while k < ra.size:
        ra = _chain_round(ra, combine, k, impl)
        k *= 2
    return ra


# -------------------------------------------------------- pair reduction

def pair_reduce(ra: RA.RoomyArray, pair_fn: Callable, merge_fn: Callable,
                identity, block: int = 256):
    """Fold pair_fn(a[i], a[j]) over all N² ordered pairs, block × block
    at a time (the batched form of the paper's map issuing accesses).
    ``pair_fn(x, y)`` broadcasts: x is (B, 1, *elt), y is (1, B, *elt)."""
    n = ra.size
    dev = ra.data.device
    nblocks = -(-n // block)
    pad = nblocks * block - n
    data = torch.cat([ra.data, torch.zeros((pad,) + tuple(ra.data.shape[1:]),
                                           dtype=ra.data.dtype, device=dev)])
    valid = torch.arange(nblocks * block, device=dev) < n
    data_b = data.reshape((nblocks, block) + tuple(ra.data.shape[1:]))
    valid_b = valid.reshape(nblocks, block)
    acc = torch.as_tensor(identity, device=dev)
    for o_dat, o_val in zip(data_b, valid_b):
        for i_dat, i_val in zip(data_b, valid_b):
            vals = pair_fn(o_dat[:, None], i_dat[None, :])
            mask = o_val[:, None] & i_val[None, :]
            mask = mask.reshape(mask.shape + (1,) * (vals.ndim - 2))
            vals = torch.where(mask, vals, torch.as_tensor(
                identity, dtype=vals.dtype, device=dev))
            flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
            acc = merge_fn(acc, T.tree_reduce(flat, merge_fn, identity))
    return acc


# ----------------------------------------------------------- implicit BFS

#: CUR states expanded per neighbour_fn call, and packed words unpacked per
#: scan step; they bound the level's temporaries, not its result.
EXPAND_BATCH = 1 << 20
SCAN_WORDS = 1 << 22


def frontier_targets(data: torch.Tensor, n_states: int, n_cur: int,
                     neighbor_fn: Callable, *, batch: int = EXPAND_BATCH,
                     scan_words: int = SCAN_WORDS) -> torch.Tensor:
    """Neighbour ranks of the ``n_cur`` CUR states among the first
    ``n_states``, in state order, as one flat int32 tensor (the level's
    delayed marks).  The tensor is allocated once, at its final size."""
    tgt = torch.empty(0, dtype=torch.int32, device=data.device)
    done = 0
    for w0 in range(0, data.shape[0], scan_words):
        fields = BA.unpack_values(data[w0:w0 + scan_words])
        cur = torch.nonzero(fields == BA.CUR).squeeze(1) \
            + w0 * BA.FIELDS_PER_WORD
        cur = cur[cur < n_states]
        for b0 in range(0, cur.shape[0], batch):
            nbr = neighbor_fn(cur[b0:b0 + batch])        # (m, fanout)
            if not done:          # the first batch tells the fanout
                tgt = torch.empty(n_cur * nbr.shape[1], dtype=torch.int32,
                                  device=data.device)
            tgt[done:done + nbr.numel()] = nbr.reshape(-1)
            done += nbr.numel()
    if done != tgt.shape[0]:
        raise RuntimeError(f"frontier holds {done} targets, expected "
                           f"{tgt.shape[0]} from {n_cur} CUR states")
    return tgt


def _implicit_level(data: torch.Tensor, n_cur: int, *, n_states: int,
                    neighbor_fn: Callable, impl: str, fused: bool):
    """One level: mark every neighbour of a CUR state NEXT-if-UNSEEN, then
    rotate CUR→DONE / NEXT→CUR and count the new frontier."""
    with obs.span("bfs.expand", n_cur=n_cur):
        tgt = frontier_targets(data, n_states, n_cur, neighbor_fn)
    if fused:
        return BA.mark_rotate_count(data, tgt, n_states, impl=impl,
                                    inplace=True)
    data = BA.mark_packed(data, tgt, impl=impl)
    return BA.rotate_count(data, n_states, impl=impl)


def implicit_bfs(n_states: int, start_idx, neighbor_fn: Callable,
                 max_levels: int = 1_000, impl: str = "auto",
                 fused: bool = True, device=None):
    """Implicit BFS over a 2-bit ``RoomyBitArray`` indexed by state rank.

    ``neighbor_fn`` maps (m,) int64 states to (m, fanout) int64 neighbour
    ranks on the array's device.  Returns (level_sizes, RoomyBitArray) —
    every reached state ends DONE.  ``fused=False`` runs the two-kernel
    reference composition (mark scatter, then rotate+count).
    """
    ba = BA.make(n_states, device=device)
    start = torch.as_tensor(start_idx, dtype=torch.int64).reshape(-1)
    data = BA.mark_packed(ba.data, start.to(ba.data.device), mark=BA.CUR,
                          only_if=BA.UNSEEN, impl=impl)
    level_sizes: List[int] = [BA.count_value(BA.RoomyBitArray(data), BA.CUR,
                                             n_states)]
    for _ in range(max_levels):
        with obs.span("bfs.level", level=len(level_sizes), tier="torch",
                      engine="implicit"):
            data, cnt = _implicit_level(data, level_sizes[-1],
                                        n_states=n_states,
                                        neighbor_fn=neighbor_fn, impl=impl,
                                        fused=fused)
            c = int(cnt)
        if c == 0:
            break
        level_sizes.append(c)
    return level_sizes, ba._replace(data=data)
