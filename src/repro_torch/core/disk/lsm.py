"""LSM-style collection of sorted runs — the sort-once visited set: the
port's own copy of ``repro/core/disk/lsm.py``, on the host in numpy.

The naive BFS loop re-sorts the entire visited set ``all`` on every level
(``remove_all`` externally sorts both operands), paying O(levels × |all|)
redundant sort work. A :class:`SortedRunSet` instead keeps ``all`` as a
stack of sorted, mutually disjoint runs — one per BFS level — and only
merges them *geometrically*: when the run count exceeds ``max_runs`` the
runs are k-way merged (a read pass, never a comparison sort) into a single
run. Amortized, each element is merged O(levels / max_runs) times instead
of being re-sorted every level.

Runs are appended via :meth:`add_run` and must individually satisfy the
ChunkStore sortedness invariant (``store.sorted``); ownership transfers to
the run set (compaction and :meth:`destroy` will destroy them).

Compaction policies:

  ``full``    (default) collapse ALL runs into one — every element pays
              one merge per compaction, including the big old runs.
  ``tiered``  size-ratio compaction: merge only the smallest runs — at
              least enough to get back under ``max_runs``, then keep
              absorbing the next-smallest run while it is no bigger than
              ``size_ratio`` × the accumulated merge. Large settled runs
              are left untouched, cutting re-merge write amplification
              from O(levels/max_runs) per element toward O(log levels).
"""
from __future__ import annotations

import os
import uuid
from typing import Iterator, List

import numpy as np

from .. import obs
from . import extsort
from .store import ChunkStore


class SortedRunSet:
    def __init__(self, workdir: str, width: int, chunk_rows: int = 1 << 16,
                 max_runs: int = 8, name: str | None = None,
                 policy: str = "full", size_ratio: int = 2,
                 codec: str | None = None):
        assert policy in ("full", "tiered"), policy
        self.workdir = workdir
        self.width = width
        self.chunk_rows = chunk_rows
        self.max_runs = max_runs
        self.policy = policy
        self.size_ratio = size_ratio
        # Compaction OUTPUT format.  Adopted/added runs keep whatever
        # format their manifest claims (checkpoint-restored runs may
        # differ — mixed run sets are fine, load_chunk decodes), but
        # every merge this set performs re-encodes into ``codec``.
        self.codec = codec
        self.name = name or f"runset_{uuid.uuid4().hex[:8]}"
        self.runs: List[ChunkStore] = []
        self._seq = 0

    # ---------------------------------------------------------- mutation
    def adopt_runs(self, runs: List[ChunkStore], seq: int) -> None:
        """Adopt a restored run stack wholesale (checkpoint/restart path).

        ``seq`` must be the compaction sequence recorded at snapshot time:
        compaction output dirs are named ``{name}.compact{seq}`` with
        ``fresh=True``, so replaying from a smaller seq could wipe a live
        run directory.  Every adopted run must hold the sortedness claim.
        """
        assert not self.runs, "adopt_runs on a non-empty run set"
        for r in runs:
            assert r.sorted, "adopt_runs requires sorted stores"
        self.runs = list(runs)
        self._seq = max(self._seq, int(seq))

    def add_run(self, store: ChunkStore) -> None:
        """Fold a sorted run in (ownership moves here). O(1) — no merge."""
        assert store.sorted, "SortedRunSet.add_run requires a sorted store"
        self.runs.append(store)

    def maybe_compact(self) -> bool:
        """Geometric merge past max_runs, per the configured policy.

        Always a k-way merge pass (dedupe=True — runs are sets), never a
        sort; the invariant tests assert STATS["sort_passes"] stays 0 here.
        Returns True if a compaction happened (callers holding references
        to member runs must re-read self.runs afterwards).
        """
        if len(self.runs) <= self.max_runs:
            return False
        if self.policy == "full":
            victims = list(self.runs)
        else:
            # Tiered: merge the smallest runs — at least enough to drop back
            # to max_runs, then absorb the next while it is ≤ size_ratio ×
            # the accumulated merge (runs of comparable size merge together;
            # settled big runs stay put).
            by_size = sorted(self.runs, key=lambda r: r.size)
            k = len(self.runs) - self.max_runs + 1
            acc = sum(r.size for r in by_size[:k])
            while (k < len(by_size)
                   and by_size[k].size <= self.size_ratio * max(acc, 1)):
                acc += by_size[k].size
                k += 1
            victims = by_size[:k]
        # Parent span over the k-way merge pass: the nested "merge" span
        # (iter_merged) carries the pass itself; this one tags it as
        # compaction work with the victim count and policy.
        with obs.span("merge", kind="compact", policy=self.policy,
                      victims=len(victims)):
            merged = ChunkStore(
                os.path.join(self.workdir, f"{self.name}.compact{self._seq}"),
                self.width, chunk_rows=self.chunk_rows, fresh=True,
                codec=self.codec)
            self._seq += 1
            extsort.merge_runs(victims, merged, dedupe=True)
        victim_ids = {id(r) for r in victims}
        survivors = [r for r in self.runs if id(r) not in victim_ids]
        for r in victims:
            r.destroy()
        self.runs = survivors + [merged]
        return True

    # -------------------------------------------------------------- read
    def size(self) -> int:
        """Total rows across runs (exact when runs are disjoint, as in BFS)."""
        return sum(r.size for r in self.runs)

    def iter_sorted(self) -> Iterator[np.ndarray]:
        """Globally sorted, deduped blocks across all runs (one merge pass)."""
        return extsort.iter_merged(self.runs, dedupe=True)

    def read_all(self) -> np.ndarray:
        """Materialize the merged unique rows (tests/small data only)."""
        blocks = list(self.iter_sorted())
        if not blocks:
            return np.zeros((0, self.width), np.uint32)
        return np.concatenate(blocks, axis=0)

    def destroy(self) -> None:
        for r in self.runs:
            r.destroy()
        self.runs = []
