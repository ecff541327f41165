"""The paper's §3 programming constructs (port of ``repro/core/constructs.py``):
the set operations on ``RoomyList`` (``:37-63``), chain reduction,
parallel prefix and pair reduction on a ``RoomyArray`` (``:69-130``), the
sorted-list BFS (``:135-231``, ``:298-354``) and the implicit BFS over a
packed 2-bit array (``:234-295``).

The sorted-list BFS is the paper's first engine: the frontier and the
visited set are ``RoomyList``s of state rows, and a level expands the
frontier through ``gen_next`` then removes duplicates and visited states.
Fused (the default), that is ``dedupe_subtract_fold``: one lexsort over
the tagged concatenation [expansion; visited] and one append scatter
(``types.SORT_STATS``: 1 lexsort + 1 scatter a level); unfused, the
paper's composition add → removeDupes → removeAll → addAll, 2 lexsorts +
2 scatters.  The JAX level expands every slot of the frontier's capacity
and sorts every slot of the visited list's; here only the live rows are
expanded (in batches of ``EXPAND_BATCH`` states) and, fused, only the
live rows sorted.  The next frontier is then padded or cut to
``next_cap`` rows as the reference's is, so the lists are the same bit
for bit, rows past ``count`` included.

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

from .. import device as _device
from . import array as RA
from . import bitarray as BA
from . import obs
from . import rlist as RL
from . import types as T


# ---------------------------------------------------------------- set ops

def set_union(a: RL.RoomyList, b: RL.RoomyList) -> RL.RoomyList:
    """A = A ∪ B   (paper: addAll + removeDupes)."""
    out, _ = RL.add_all(a, b)
    return RL.remove_dupes(out)


def set_difference(a: RL.RoomyList, b: RL.RoomyList) -> RL.RoomyList:
    """A = A − B   (paper: removeAll; assumes a, b are sets)."""
    return RL.remove_all(a, b)


def set_intersection(a: RL.RoomyList, b: RL.RoomyList,
                     capacity: int | None = None) -> RL.RoomyList:
    """C = A ∩ B via the paper's recipe: (A+B) − (A−B) − (B−A)."""
    cap = capacity or (a.capacity + b.capacity)
    dev = a.data.device
    a_and_b = RL.make(cap, a.width, dev)
    a_and_b, _ = RL.add_all(a_and_b, a)
    a_and_b, _ = RL.add_all(a_and_b, b)
    a_and_b = RL.remove_dupes(a_and_b)
    a_minus_b = RL.remove_all(a, b)
    b_minus_a = RL.remove_all(b, a)
    c = RL.make(cap, a.width, dev)
    c, _ = RL.add_all(c, a_and_b)
    c = RL.remove_all(c, a_minus_b)
    return RL.remove_all(c, b_minus_a)


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


# -------------------------------------------------------- sorted-list BFS

class BFSResult:
    def __init__(self):
        self.level_sizes: List[int] = []
        self.all: RL.RoomyList | None = None
        self.levels_run: int = 0


def expand(cur: RL.RoomyList, gen_next: Callable, fanout: int,
           batch: int = EXPAND_BATCH):
    """The neighbours of cur's rows [0, count), in row order: returns
    ((count·fanout, width) int32 rows, (count·fanout,) bool valid).
    ``gen_next`` maps (m, width) int32 rows to ((m, fanout, width) int32
    rows, (m, fanout) bool), called on ``batch`` rows at a time."""
    k, w = int(cur.count), cur.width
    dev = cur.data.device
    rows = torch.empty((k * fanout, w), dtype=torch.int32, device=dev)
    valid = torch.empty(k * fanout, dtype=torch.bool, device=dev)
    for b0 in range(0, k, batch):
        b1 = min(b0 + batch, k)
        nbr, ok = gen_next(cur.data[b0:b1])
        rows[b0 * fanout:b1 * fanout] = nbr.reshape(-1, w)
        valid[b0 * fanout:b1 * fanout] = ok.reshape(-1)
    return rows, valid


def dedupe_subtract_fold(nxt_rows: torch.Tensor, nxt_valid: torch.Tensor,
                         all_lst: RL.RoomyList, next_cap: int):
    """Fused removeDupes ∘ removeAll ∘ addAll — ONE lexsort, ONE scatter.

    One lexsort over the tagged concatenation [valid nxt rows; all's rows
    [0, count)] decides all three at once: within an equal-run, any member
    tagged "old" kills the run (visited-set subtraction), otherwise the
    first member survives (intra-level dedup); the survivors, already in
    sorted order, are compacted and folded into ``all`` with one append.
    Only live rows are sorted (the reference sorts every slot, invalid
    ones as sentinels, which sort last and drop): the survivors are the
    same, and ``nxt`` is padded with sentinels or cut to ``next_cap`` rows
    as the reference's is.

    Returns (nxt, all2, overflow) like the composition it replaces.
    """
    dev = all_lst.data.device
    # Each temporary goes as soon as it is dead, the expansion first (the
    # caller passes it on and keeps no reference): the widest level of
    # pancake n = 11 sorts 172M rows, and these set the peak.
    new = nxt_rows.to(torch.int32)[nxt_valid]
    del nxt_rows, nxt_valid
    n_new = new.shape[0]
    rows = torch.cat([new, all_lst.data[:int(all_lst.count)]])
    del new
    is_old = torch.arange(rows.shape[0], device=dev) >= n_new
    perm = T.lexsort_rows(rows)
    rows_s = rows[perm]
    del rows
    keep = (T.first_of_run(rows_s) & T.rows_valid(rows_s)
            & ~RL.segment_any(is_old[perm], T.run_ids(rows_s)))
    del perm
    rows_c, count = T.compact_valid_first(rows_s, keep)   # stays sorted
    del rows_s, keep
    pad = next_cap - rows_c.shape[0]
    nxt_data = (torch.cat([rows_c, T.sentinel_rows(pad, all_lst.width, dev)])
                if pad > 0 else rows_c[:next_cap])
    nxt = RL.RoomyList(nxt_data, torch.clamp(count, max=next_cap))
    all2, ov2 = RL.add(all_lst, nxt_data,
                       torch.arange(next_cap, device=dev) < count)
    return nxt, all2, (count > next_cap) | ov2


def _traced_expand(cur: RL.RoomyList, gen_next: Callable, fanout: int):
    """``expand`` in a ``bfs.expand`` span; while tracing, the span waits
    for the device, so that it times the expansion and not its enqueue."""
    with obs.span("bfs.expand", n_cur=int(cur.count)):
        rows, valid = expand(cur, gen_next, fanout)
        if obs.ACTIVE and rows.is_cuda:
            torch.cuda.synchronize(rows.device)
    return rows, valid


def _bfs_level(cur: RL.RoomyList, all_lst: RL.RoomyList, gen_next: Callable,
               fanout: int, next_cap: int):
    """One level: expand cur, then one fused dedupe/subtract/fold pass,
    which owns the expansion and drops it once it has the valid rows."""
    return dedupe_subtract_fold(*_traced_expand(cur, gen_next, fanout),
                                all_lst, next_cap)


def _bfs_level_reference(cur: RL.RoomyList, all_lst: RL.RoomyList,
                         gen_next: Callable, fanout: int, next_cap: int):
    """Unfused reference level (2 lexsorts + 2 scatters): the paper's
    add → removeDupes → removeAll → addAll; same lists as _bfs_level."""
    rows, valid = _traced_expand(cur, gen_next, fanout)
    nxt = RL.make(next_cap, cur.width, cur.data.device)
    nxt, overflow = RL.add(nxt, rows, valid)
    del rows, valid
    nxt = RL.remove_dupes(nxt)                 # dedup within level
    nxt = RL.remove_all(nxt, all_lst)          # dedup against previous levels
    all2, ov2 = RL.add_all(all_lst, nxt)       # record new elements
    return nxt, all2, overflow | ov2


def breadth_first_search(start_rows, gen_next: Callable, fanout: int,
                         width: int, all_capacity: int, level_capacity: int,
                         max_levels: int = 1_000, fused: bool = True,
                         device=None) -> BFSResult:
    """Paper §3 BFS over an implicit graph, with capacity growth.

    ``start_rows`` are (m, width) rows (a tensor or uint32 array-like),
    ``gen_next`` as ``expand`` takes it.  A level whose result overflows
    the visited list doubles its capacity and runs once more; a second
    overflow raises ``MemoryError``.  ``fused=False`` runs the unfused
    composition.  Each level is a ``bfs.level`` span (``tier="torch"``,
    ``engine="sorted"``) around a ``bfs.expand`` one.
    """
    dev = _device.resolve(device)
    start_rows = RL.as_rows(start_rows, dev).reshape(-1, width)
    all_lst, _ = RL.add(RL.make(all_capacity, width, dev), start_rows)
    cur, _ = RL.add(RL.make(level_capacity, width, dev), start_rows)
    level_fn = _bfs_level if fused else _bfs_level_reference

    res = BFSResult()
    res.level_sizes.append(int(cur.count))
    for _ in range(max_levels):
        frontier = res.level_sizes[-1]
        if frontier == 0:
            res.level_sizes.pop()              # last level was empty
            break
        with obs.span("bfs.level", level=res.levels_run + 1, tier="torch",
                      engine="sorted", frontier=frontier):
            next_cap = max(level_capacity, frontier * fanout)
            nxt, all2, overflow = level_fn(cur, all_lst, gen_next, fanout,
                                           next_cap)
            if bool(overflow):
                # Grow the visited list and redo the level (the failed
                # attempt changed no state).
                all_capacity *= 2
                all_lst, _ = RL.add_all(RL.make(all_capacity, width, dev),
                                        all_lst)
                nxt, all2, overflow = level_fn(cur, all_lst, gen_next,
                                               fanout, next_cap)
                if bool(overflow):
                    raise MemoryError("BFS capacity growth failed twice")
            cur, all_lst = nxt, all2
            res.levels_run += 1
            res.level_sizes.append(int(cur.count))
        if res.level_sizes[-1] == 0:
            res.level_sizes.pop()
            break
    res.all = all_lst
    return res
