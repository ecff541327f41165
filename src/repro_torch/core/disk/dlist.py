"""DiskList — the paper's RoomyList, genuinely out-of-core (Tier D): the
port's own copy of ``repro/core/disk/dlist.py``, on the host in numpy.

All operations stream chunk-at-a-time; RAM held at any instant is O(chunk).
Semantics mirror Tier J (``core/rlist.py``) exactly.
"""
from __future__ import annotations

import os
import uuid
from typing import Callable, List

import numpy as np

from . import extsort
from .store import ChunkStore


class DiskList:
    _seq = 0

    def __init__(self, workdir: str, width: int, chunk_rows: int = 1 << 16,
                 name: str | None = None):
        self.workdir = workdir
        self.width = width
        self.chunk_rows = chunk_rows
        name = name or f"dlist_{DiskList._seq}_{uuid.uuid4().hex[:8]}"
        DiskList._seq += 1
        self.name = name
        self.store = ChunkStore(os.path.join(workdir, name), width,
                                chunk_rows=chunk_rows, fresh=True)

    # ------------------------------------------------------------ basics
    def add(self, rows: np.ndarray) -> None:
        """Delayed add — buffered by the store, lands at chunk granularity."""
        self.store.append(rows)

    def add_all(self, other: "DiskList") -> None:
        other.store.flush()
        for chunk in other.store.iter_chunks():
            self.store.append(np.asarray(chunk))

    def size(self) -> int:
        return self.store.size

    def _fresh(self, tag: str) -> ChunkStore:
        return ChunkStore(os.path.join(self.workdir,
                                       f"{self.name}.{tag}.{uuid.uuid4().hex[:8]}"),
                          self.width, chunk_rows=self.chunk_rows, fresh=True)

    def _swap(self, new_store: ChunkStore) -> None:
        self.store.destroy()
        self.store = new_store

    # --------------------------------------------------------- mutators
    #
    # Sort-once: every mutator records sorted output on its result store
    # (via extsort) and consults the invariant on its inputs — a second
    # remove_dupes, or a remove_all after a remove_dupes, performs zero
    # comparison sorts (streaming passes only).

    def remove_dupes(self, run_rows: int = 1 << 18) -> None:
        self.store.flush()
        out = self._fresh("dedup")
        tmp = os.path.join(self.workdir, f"{self.name}.sorttmp")
        # external_sort degrades to a one-pass stream_dedupe when the store
        # already claims sorted.
        extsort.external_sort(self.store, out, tmp, run_rows=run_rows,
                              dedupe=True)
        self._swap(out)

    def remove_all(self, other: "DiskList", run_rows: int = 1 << 18) -> None:
        """Remove every occurrence of each element of other (multiset)."""
        self.store.flush()
        other.store.flush()
        if self.store.sorted:                 # invariant: skip the a-sort
            a_sorted = self.store
        else:
            a_sorted = self._fresh("asort")
            extsort.external_sort(self.store, a_sorted,
                                  os.path.join(self.workdir, f"{self.name}.t1"),
                                  run_rows=run_rows)
        if other.store.sorted:                # invariant: skip the b-sort
            b_sorted = other.store
        else:
            b_sorted = self._fresh("bsort")
            extsort.external_sort(other.store, b_sorted,
                                  os.path.join(self.workdir, f"{self.name}.t2"),
                                  run_rows=run_rows, dedupe=True)
        out = self._fresh("diff")
        extsort.merge_difference(a_sorted, b_sorted, out)
        if a_sorted is not self.store:
            a_sorted.destroy()
        if b_sorted is not other.store:
            b_sorted.destroy()
        self._swap(out)

    def remove(self, rows: np.ndarray) -> None:
        tmp = DiskList(self.workdir, self.width, self.chunk_rows)
        tmp.add(rows)
        self.remove_all(tmp)
        tmp.destroy()

    # -------------------------------------------------------- streaming
    def map_chunks(self, fn: Callable[[np.ndarray], None]) -> None:
        """Paper's map: fn applied to each chunk (vectorized numpy)."""
        self.store.flush()
        for chunk in self.store.iter_chunks():
            fn(np.asarray(chunk))

    def reduce(self, elt_fn: Callable, merge_fn: Callable, init):
        """elt_fn(chunk)->partial, merge_fn(partial, partial)->partial."""
        self.store.flush()
        acc = init
        for chunk in self.store.iter_chunks():
            acc = merge_fn(acc, elt_fn(np.asarray(chunk)))
        return acc

    def predicate_count(self, pred: Callable[[np.ndarray], np.ndarray]) -> int:
        return self.reduce(lambda c: int(pred(c).sum()), lambda a, b: a + b, 0)

    def read_all(self) -> np.ndarray:
        self.store.flush()
        return self.store.read_all()

    def destroy(self) -> None:
        self.store.destroy()
