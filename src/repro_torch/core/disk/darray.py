"""DiskArray — the paper's RoomyArray on real disk (Tier D): the port's
own copy of ``repro/core/disk/darray.py``, on the host in numpy.

The array lives as fixed-size chunks on disk; a delayed ``update(i, pay)``
appends (i, pay) to the *op log of the chunk that owns i* — Roomy's
bucketing trick, so a sync streams each chunk exactly once and never seeks:

    for each chunk:  load chunk,  load its op log,  sort ops by index,
                     segment-combine, apply, write back, clear log.

This is the scatter-gather the paper describes for chain reduction; the
Tier-J twin (array.py) runs the same algorithm on device.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Callable

import numpy as np

from .extsort import segment_combine_ordered


class DiskArray:
    def __init__(self, workdir: str, n: int, width: int = 1,
                 dtype="int64", chunk_rows: int = 1 << 16,
                 name: str | None = None):
        self.n = n
        self.width = width
        self.dtype = np.dtype(dtype)
        self.chunk_rows = chunk_rows
        self.n_chunks = -(-n // chunk_rows)
        name = name or f"darray_{uuid.uuid4().hex[:8]}"
        self.path = os.path.join(workdir, name)
        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
        os.makedirs(self.path)
        for c in range(self.n_chunks):
            rows = min(chunk_rows, n - c * chunk_rows)
            np.save(self._chunk_path(c),
                    np.zeros((rows, width), self.dtype))
        self._log_bufs = [[] for _ in range(self.n_chunks)]

    def _chunk_path(self, c: int) -> str:
        return os.path.join(self.path, f"a{c:06d}.npy")

    def _log_path(self, c: int) -> str:
        return os.path.join(self.path, f"log{c:06d}.npy")

    # ------------------------------------------------------ delayed ops
    def update(self, idx: np.ndarray, payload: np.ndarray) -> None:
        """Queue delayed updates (bucketed to owner chunks immediately)."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        payload = np.asarray(payload, self.dtype).reshape(idx.shape[0], -1)
        chunk_of = idx // self.chunk_rows
        order = np.argsort(chunk_of, kind="stable")
        idx, payload, chunk_of = idx[order], payload[order], chunk_of[order]
        bounds = np.searchsorted(chunk_of, np.arange(self.n_chunks + 1))
        for c in range(self.n_chunks):
            lo, hi = bounds[c], bounds[c + 1]
            if hi > lo:
                rec = np.concatenate(
                    [idx[lo:hi, None].astype(np.int64),
                     payload[lo:hi].astype(np.int64)], axis=1)
                self._log_bufs[c].append(rec)

    def _flush_logs(self) -> None:
        for c, buf in enumerate(self._log_bufs):
            if not buf:
                continue
            rec = np.concatenate(buf, axis=0)
            if os.path.exists(self._log_path(c)):
                old = np.load(self._log_path(c))
                rec = np.concatenate([old, rec], axis=0)
            np.save(self._log_path(c), rec)
            self._log_bufs[c] = []

    def sync(self, combine: Callable, apply: Callable) -> None:
        """Execute all queued updates; one streaming pass over the array.

        combine(p1, p2): associative merge of payloads for one index.
        apply(old_rows, agg_rows) -> new_rows (vectorized).
        """
        self._flush_logs()
        for c in range(self.n_chunks):
            lp = self._log_path(c)
            if not os.path.exists(lp):
                continue
            log = np.load(lp)
            os.remove(lp)
            if not log.shape[0]:
                continue
            chunk = np.load(self._chunk_path(c))
            local = (log[:, 0] - c * self.chunk_rows).astype(np.int64)
            pay = log[:, 1:].astype(self.dtype)
            order = np.argsort(local, kind="stable")
            uniq, agg = segment_combine_ordered(local[order], pay[order],
                                                combine)
            chunk[uniq] = apply(chunk[uniq], agg)
            np.save(self._chunk_path(c), chunk)

    # -------------------------------------------------------- streaming
    def map_chunks(self, fn: Callable[[int, np.ndarray], None]) -> None:
        for c in range(self.n_chunks):
            fn(c * self.chunk_rows, np.load(self._chunk_path(c),
                                            mmap_mode="r"))

    def map_update(self, fn: Callable[[int, np.ndarray], np.ndarray]) -> None:
        for c in range(self.n_chunks):
            chunk = np.load(self._chunk_path(c))
            np.save(self._chunk_path(c), fn(c * self.chunk_rows, chunk))

    def reduce(self, elt_fn: Callable, merge_fn: Callable, init):
        acc = init
        for c in range(self.n_chunks):
            acc = merge_fn(acc, elt_fn(np.load(self._chunk_path(c),
                                               mmap_mode="r")))
        return acc

    def read_all(self) -> np.ndarray:
        return np.concatenate([np.load(self._chunk_path(c))
                               for c in range(self.n_chunks)], axis=0)

    def write_all(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, self.dtype).reshape(self.n, self.width)
        for c in range(self.n_chunks):
            lo = c * self.chunk_rows
            np.save(self._chunk_path(c), rows[lo:lo + self.chunk_rows])

    def destroy(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)
