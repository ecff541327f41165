"""Out-of-core breadth-first search (Tier D) — the port of
``repro/core/disk/bfs.py``: the paper's two BFS engines on real disk.

:func:`breadth_first_search` is the sort-once engine over sorted row
runs, on the host in numpy as in the reference (``level_step``: one sort
pass over the raw frontier, a k-way merge with dedupe, the visited runs
subtracted by forward-walking membership probes; the surviving rows are
the new visited run).  ``fused=False`` keeps the reference's unfused
composition (``DiskList``'s removeDupes / removeAll / addAll).

:func:`implicit_bfs` is the rank-indexed engine over a 2-bit
:class:`~.bitarray.DiskBitArray` (UNSEEN/CUR/NEXT/DONE).  Its chunk
passes run on the array's device: a fused level is ONE read-write pass,
each chunk one K1 launch (its queued marks, UNSEEN→NEXT, then the rotate
CUR→DONE, NEXT→CUR, then the count of CUR), and the freshly rotated CUR
fields are expanded on the device with ``gen_neighbors((m,) int64) →
(m, fanout) int64``.  ``fused=False`` keeps the two-pass composition: an
expand read pass, then a pass of K2 (chunks with a log) and K3 (every
chunk).  The seed pass and every expansion run on the generic route.
The workdir, the op logs, the counters and the checkpoints are the
reference's, byte for byte.

A sharded ``cluster=`` (``config.ClusterConfig``) runs either engine on
the shard runtime of ``cluster.py``: :func:`~.cluster.sharded_bfs` and
:func:`~.cluster.sharded_implicit_bfs`, whose level sizes are the
single-process engine's for any number of shards; ``recovery=`` arms
their self-healing and is unused in one process.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, List

import numpy as np
import torch

from .. import bitarray as BA
from .. import obs
from . import checkpoint as ckpt
from . import extsort
from .bitarray import CUR, NEXT, UNSEEN, DiskBitArray
from .checkpoint import SearchCheckpoint
from .config import resolve_configs
from .dlist import DiskList
from .lsm import SortedRunSet
from .passes import PassPlan
from .store import ChunkStore, row_keys


def level_step(raw: ChunkStore, all_runs: List[ChunkStore], out: ChunkStore,
               tmp_dir: str, run_rows: int = 1 << 18,
               probe_rows: int = 1 << 14) -> None:
    """Fused removeDupes → removeAll → addAll: one sort pass over ``raw``.

    raw:      unsorted frontier expansion (consumed read-only).
    all_runs: sorted visited-set runs (read forward once each, with
              chunk-range pruning; never sorted).
    out:      receives the deduped, unvisited frontier — sorted and marked
              so, ready to be add_run() into the visited SortedRunSet.
    """
    runs = extsort.make_runs(raw, tmp_dir, run_rows)
    try:
        _merge_subtract(runs, all_runs, out, probe_rows)
    finally:
        for r in runs:
            r.destroy()


def _merge_subtract(frontier_runs: List[ChunkStore],
                    all_runs: List[ChunkStore], out: ChunkStore,
                    probe_rows: int = 1 << 14) -> None:
    """Merge+dedupe the frontier runs, subtracting the visited runs in
    stream; emits sorted unique unvisited rows into ``out``.  Merged
    blocks gather to ~probe_rows before the probes run, which keeps the
    probes' windows ascending."""
    probes = [extsort.MembershipProbe(r) for r in all_runs]
    batch: List[np.ndarray] = []
    batch_rows = 0

    def subtract_emit():
        nonlocal batch, batch_rows
        if not batch_rows:
            return
        rows = np.concatenate(batch, axis=0) if len(batch) > 1 else batch[0]
        batch, batch_rows = [], 0
        member = np.zeros(rows.shape[0], bool)
        if probes:
            keys = row_keys(rows)
            for p in probes:
                member |= p.contains(keys)
        out.append(rows[~member])

    for block in extsort.iter_merged(frontier_runs, dedupe=True):
        batch.append(block)
        batch_rows += block.shape[0]
        if batch_rows >= probe_rows:
            subtract_emit()
    subtract_emit()
    out.flush(mark_sorted=True)


def _ckpt_sorted(ck: SearchCheckpoint, all_runs: SortedRunSet,
                 cur: ChunkStore, level_sizes: List[int], width: int,
                 prev: dict) -> None:
    """Publish one sorted-engine checkpoint (end of level); ``prev``
    carries {dir, names} of THIS search's previous snapshot so unchanged
    runs hard-link instead of re-copying."""
    version = ck.next_version()
    stage = ck.begin(version)
    state = ckpt.snapshot_sorted_state(stage, all_runs, cur,
                                       prev_dir=prev.get("dir"),
                                       prev_names=prev.get("names"))
    sealed = ck.publish(
        version, {"engine": "sorted", "sharded": False, "nshards": 1,
                  "width": width, "n_states": 0,
                  "level_sizes": list(level_sizes),
                  "golden": ckpt.golden_owner_values(1, width, 0),
                  # absent/None == raw: the reference's format marker
                  "codec": cur.codec,
                  "state": state})
    prev["dir"], prev["names"] = sealed, set(state["runs"])


def _ckpt_implicit(ck: SearchCheckpoint, bits: DiskBitArray,
                   level_sizes: List[int], n_states: int) -> None:
    """Publish one implicit-engine checkpoint: the rotated array plus the
    op logs holding the NEXT level's queued marks."""
    version = ck.next_version()
    stage = ck.begin(version)
    state = ckpt.snapshot_implicit_state(stage, bits)
    ck.publish(version, {"engine": "implicit", "sharded": False,
                         "nshards": 1, "width": 1, "n_states": n_states,
                         "level_sizes": list(level_sizes),
                         "golden": ckpt.golden_owner_values(1, 1, n_states),
                         "codec": "rle2" if bits.compress else None,
                         "state": state})


def breadth_first_search(
    workdir: str,
    start_rows: np.ndarray,
    gen_next: Callable[[np.ndarray], np.ndarray],
    width: int,
    chunk_rows: int = 1 << 16,
    max_levels: int = 10_000,
    fused: bool = True,
    run_rows: int = 1 << 18,
    max_runs: int = 8,
    compaction: str = "full",
    size_ratio: int = 2,
    compress: bool = False,
    cluster=None,
    checkpoint=None,
    recovery=None,
):
    """The sort-once BFS over rows, on the host.  gen_next(chunk (m,
    width) uint32) -> neighbor rows (m*fanout, width).

    Returns (level_sizes, all): ``all`` is the visited SortedRunSet
    (fused) or a DiskList (``fused=False``, the reference composition).
    start_rows are a set on both paths.  ``compaction`` / ``size_ratio``
    pick the visited set's compaction policy (``lsm.py``);
    ``compress=True`` stores every run varint-delta coded (fused only);
    ``checkpoint=CheckpointConfig(dir, every, resume)`` snapshots the
    visited runs and the frontier every ``every`` levels and resumes
    from the last one, across the compressed/uncompressed boundary both
    ways (fused only).  A sharded ``cluster=`` runs
    :func:`~.cluster.sharded_bfs` (``gen_next`` then pickles in spawn
    mode) and returns a ``ShardedVisited`` in place of ``all``."""
    cl, cp, rec = resolve_configs(
        "breadth_first_search", cluster=cluster, checkpoint=checkpoint,
        recovery=recovery, fused=fused)
    checkpoint_dir, checkpoint_every, resume = cp.dir, cp.every, cp.resume
    if cl.sharded:
        from .cluster import sharded_bfs
        rt, own = cl.build_runtime(workdir)
        sizes, handle = sharded_bfs(
            rt, start_rows, gen_next, width, chunk_rows=chunk_rows,
            max_levels=max_levels, run_rows=run_rows, max_runs=max_runs,
            compaction=compaction, size_ratio=size_ratio, compress=compress,
            bucket_capacity=cl.bucket_capacity, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            max_recoveries=rec.max_recoveries)
        handle._own_runtime = own
        return sizes, handle
    if not fused:
        assert not compress, "compress=True requires the fused engine"
        return _breadth_first_search_unfused(
            workdir, start_rows, gen_next, width, chunk_rows, max_levels)

    # One scratch dir for every level's sort runs.
    tmp_dir = os.path.join(workdir, "bfs_tmp")
    codec = "keys" if compress else None
    all_runs = SortedRunSet(workdir, width, chunk_rows, max_runs=max_runs,
                            name="bfs_all", policy=compaction,
                            size_ratio=size_ratio, codec=codec)
    ck = SearchCheckpoint(checkpoint_dir) if checkpoint_dir else None
    ck_prev: dict = {}
    state = ck.latest() if (ck is not None and resume) else None
    if state is not None:
        ckpt.validate_resume(state, "sorted", 1, width, 0, sharded=False)
        cur = ckpt.restore_sorted_state(ck.snapshot_dir(state),
                                        state["state"], all_runs, workdir,
                                        width, chunk_rows)
        assert cur is not None, "single-process checkpoint lost its frontier"
        level_sizes: List[int] = [int(x) for x in state["level_sizes"]]
        start_lev = len(level_sizes)
    else:
        start_rows = np.asarray(start_rows, np.uint32).reshape(-1, width)
        seed = ChunkStore(os.path.join(workdir, "bfs_seed"), width,
                          chunk_rows=chunk_rows, fresh=True)
        seed.append(start_rows)
        seed.flush()
        cur = ChunkStore(os.path.join(workdir, "bfs_lev0"), width,
                         chunk_rows=chunk_rows, fresh=True, codec=codec)
        extsort.external_sort(seed, cur, tmp_dir, run_rows=run_rows,
                              dedupe=True)
        seed.destroy()
        all_runs.add_run(cur)
        level_sizes = [cur.size]
        if cur.size == 0:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            return [], all_runs
        start_lev = 1
        if ck is not None:      # level-0 snapshot: any kill is resumable
            _ckpt_sorted(ck, all_runs, cur, level_sizes, width, ck_prev)
    for lev in range(start_lev, max_levels + 1):
        with obs.span("bfs.level", level=lev, engine="sorted",
                      frontier=cur.size):
            # Expansion streams straight into sorted run construction.
            builder = extsort.RunBuilder(tmp_dir, width,
                                         chunk_rows=chunk_rows,
                                         run_rows=run_rows, codec=codec)
            for chunk in cur.iter_chunks():
                builder.add(gen_next(np.asarray(chunk)))
            runs = builder.finish()
            # cur is fully consumed; compaction may now merge it.
            all_runs.maybe_compact()
            nxt = ChunkStore(os.path.join(workdir, f"bfs_lev{lev}"), width,
                             chunk_rows=chunk_rows, fresh=True, codec=codec)
            try:
                _merge_subtract(runs, all_runs.runs, nxt)
            finally:
                for r in runs:
                    r.destroy()
            if nxt.size == 0:
                nxt.destroy()
                empty = True
            else:
                empty = False
                all_runs.add_run(nxt)
                cur = nxt
                level_sizes.append(cur.size)
                if ck is not None and lev % checkpoint_every == 0:
                    _ckpt_sorted(ck, all_runs, cur, level_sizes, width,
                                 ck_prev)
        if empty:
            break
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return level_sizes, all_runs


def implicit_bfs(
    workdir: str,
    n_states: int,
    start_idx,
    gen_neighbors: Callable[[torch.Tensor], torch.Tensor],
    chunk_elems: int = 1 << 22,
    max_levels: int = 10_000,
    expand_batch: int = 1 << 16,
    log_buf_rows: int = 1 << 20,
    fused: bool = True,
    compress: bool = False,
    cluster=None,
    checkpoint=None,
    recovery=None,
    device=None,
    impl: str = "auto",
):
    """The paper's second BFS engine: implicit search over a 2-bit
    :class:`DiskBitArray` of ``n_states`` elements, its chunk passes on
    ``device`` (default ``"cuda"``; ``impl="ref"`` runs the kernels'
    plain versions there).

    gen_neighbors(idx (m,) int64 on the device) -> (m, fanout) int64
    neighbour indices.  With ``fused=True`` (default) a level is ONE
    read-write pass, one K1 launch a chunk, and the expansion of the
    freshly rotated CUR states rides the same pass; the marks it queues
    are snapshot-isolated to the NEXT pass (binned to owner chunks,
    spilled to disk past ``log_buf_rows``), in batches of
    ``expand_batch`` states.  ``fused=False`` runs the two-pass
    composition (an expand read pass, then K2 + K3).  ``compress=True``
    stores cold chunks rle2-coded.

    ``checkpoint=CheckpointConfig(dir, every, resume)`` snapshots the
    rotated array and the op logs of the next level's marks every
    ``every`` levels (fused only); on resume the snapshot's
    ``chunk_elems`` wins over the argument, and a reference checkpoint
    resumes here as its own does.

    Memory is O(chunk + expand_batch·fanout) on the device, whatever the
    frontier; disk is n_states/4 bytes + queued marks.  Returns
    (level_sizes, bits) — ``bits`` holds the final DONE marks.  A sharded
    ``cluster=`` runs :func:`~.cluster.sharded_implicit_bfs`: each shard's
    block on ``device``, one K1 launch a chunk a level on every shard, and
    ``bits`` a ``ShardedDiskBitArray``.
    """
    cl, cp, rec = resolve_configs(
        "implicit_bfs", cluster=cluster, checkpoint=checkpoint,
        recovery=recovery, fused=fused)
    checkpoint_dir, checkpoint_every, resume = cp.dir, cp.every, cp.resume
    if cl.sharded:
        from .cluster import sharded_implicit_bfs
        rt, own = cl.build_runtime(workdir)
        sizes, handle = sharded_implicit_bfs(
            rt, n_states, start_idx, gen_neighbors, chunk_elems=chunk_elems,
            max_levels=max_levels, expand_batch=expand_batch,
            log_buf_rows=log_buf_rows, compress=compress,
            bucket_capacity=cl.bucket_capacity,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume=resume, max_recoveries=rec.max_recoveries,
            device=device, impl=impl)
        handle._own_runtime = own
        return sizes, handle
    ck = SearchCheckpoint(checkpoint_dir) if checkpoint_dir else None
    state = ck.latest() if (ck is not None and resume) else None
    if state is not None:
        ckpt.validate_resume(state, "implicit", 1, 1, n_states,
                             sharded=False)
        # The snapshot pins the chunk layout: adopt with ITS chunk_elems.
        chunk_elems = int(state["state"]["chunk_elems"])
    # On resume every chunk arrives from the snapshot: skip the zero-fill.
    bits = DiskBitArray(workdir, n_states, chunk_elems=chunk_elems,
                        name="bfs_bits", log_buf_rows=log_buf_rows,
                        init_chunks=state is None, compress=compress,
                        device=device, impl=impl)

    def expand(chunk_start: int, vals: torch.Tensor) -> None:
        cur_pos = torch.nonzero(vals == CUR).flatten()
        for lo in range(0, cur_pos.shape[0], expand_batch):
            idx = chunk_start + cur_pos[lo:lo + expand_batch]
            nbrs = gen_neighbors(idx).reshape(-1)
            bits.update(nbrs, torch.full(nbrs.shape, NEXT, dtype=torch.uint8,
                                         device=nbrs.device))

    def seed(start_idx) -> torch.Tensor:
        start = torch.unique(torch.as_tensor(start_idx, dtype=torch.int64)
                             .reshape(-1))
        assert start.numel() and int(start.min()) >= 0 \
            and int(start.max()) < n_states
        bits.update(start, torch.full(start.shape, CUR, dtype=torch.uint8))
        return start

    nxt_count = 0

    def count_cur(chunk_start: int, n: int) -> None:
        nonlocal nxt_count
        nxt_count += n

    if not fused:
        start = seed(start_idx)
        return _implicit_bfs_unfused(bits, start, expand, max_levels)

    if state is not None:
        ckpt.restore_implicit_state(ck.snapshot_dir(state), bits)
        level_sizes: List[int] = [int(x) for x in state["level_sizes"]]
    else:
        seed(start_idx)
        # Pass 0: apply the seed marks (overwrite), count them, and expand
        # them.  The array is freshly zeroed, so CUR can only exist in the
        # seeds' (dirty) chunks: dirty_only skips the rest.
        bits.run_pass(PassPlan("bfs-seed", dirty_only=True)
                      .counts(CUR, count_cur).reads(expand))
        level_sizes = [nxt_count]
        if ck is not None:      # level-0 snapshot: any kill is resumable
            _ckpt_implicit(ck, bits, level_sizes, n_states)
    lev = len(level_sizes) - 1          # highest level already counted
    while lev < max_levels:
        with obs.span("bfs.level", level=lev + 1, engine="implicit"):
            nxt_count = 0
            # One fused read-write pass, one K1 launch a chunk: marks from
            # the previous expansion apply (UNSEEN→NEXT), the chunk
            # rotates, the new frontier is counted, and its expansion
            # queues marks for the NEXT pass.
            bits.run_pass(
                PassPlan("bfs-level").rotates(BA.ROTATE_LUT)
                .counts(CUR, count_cur).reads(expand),
                mark=(NEXT, UNSEEN))
            if nxt_count:
                level_sizes.append(nxt_count)
                lev += 1
                if ck is not None and lev % checkpoint_every == 0:
                    _ckpt_implicit(ck, bits, level_sizes, n_states)
        if nxt_count == 0:
            break
    return level_sizes, bits


def _implicit_bfs_unfused(bits: DiskBitArray, start: torch.Tensor,
                          expand: Callable, max_levels: int):
    """Reference composition: a separate expand read pass, then a mark /
    rotate read-write pass per level — K2 on each chunk with a log, K3
    on every chunk."""
    bits.sync()                                   # overwrite: seeds → CUR
    level_sizes: List[int] = [int(start.numel())]
    for _ in range(max_levels):
        bits.map_chunks(expand)
        nxt_count = 0

        def count(chunk_start: int, n: int) -> None:
            nonlocal nxt_count
            nxt_count += n

        bits.run_pass(PassPlan("sync").rotates(BA.ROTATE_LUT, CUR, count),
                      mark=(NEXT, UNSEEN), fuse=False)
        if nxt_count == 0:
            break
        level_sizes.append(nxt_count)
    return level_sizes, bits


def _breadth_first_search_unfused(
    workdir: str,
    start_rows: np.ndarray,
    gen_next: Callable[[np.ndarray], np.ndarray],
    width: int,
    chunk_rows: int = 1 << 16,
    max_levels: int = 10_000,
):
    """Reference path: the paper's literal removeDupes/removeAll/addAll
    composition (2 sort passes per level, visited set re-sorted each
    level)."""
    start_rows = np.asarray(start_rows, np.uint32).reshape(-1, width)
    # Seed treated as a set, matching the fused path.
    start_rows = np.unique(start_rows, axis=0)
    all_lst = DiskList(workdir, width, chunk_rows, name="bfs_all")
    cur = DiskList(workdir, width, chunk_rows, name="bfs_lev0")
    all_lst.add(start_rows)
    cur.add(start_rows)

    level_sizes: List[int] = [cur.size()]
    for lev in range(1, max_levels + 1):
        if cur.size() == 0:
            level_sizes.pop()
            break
        nxt = DiskList(workdir, width, chunk_rows, name=f"bfs_lev{lev}")
        cur.map_chunks(lambda chunk: nxt.add(gen_next(chunk)))
        nxt.remove_dupes()
        nxt.remove_all(all_lst)
        all_lst.add_all(nxt)
        cur.destroy()
        cur = nxt
        level_sizes.append(cur.size())
        if cur.size() == 0:
            level_sizes.pop()
            break
    cur.destroy()
    return level_sizes, all_lst
