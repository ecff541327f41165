"""Disk-backed delayed-op buckets — the paper's per-(src, dst) bucket
files — and the owner maps of Tier D: the port's own copy of
``repro/core/disk/buckets.py``, with the same bytes on the wire.

Invariant: readers only ever see *sealed* (atomically renamed) bucket
files — a writer killed mid-epoch leaves nothing but ignorable ``.tmp``
strays — and the numpy owner maps are bit for bit the reference's (the
checkpoints pin them as golden values), since an ownership disagreement
silently corrupts a sharded structure.  Overflow past a bucket's
per-epoch capacity is dropped AND counted exactly, never silently.

Roomy ships every delayed operation to the disk that owns its target in
fixed-capacity bucket files, one per (source, destination) pair, and
applies them in a streaming batch at sync (paper §2–3):

  * a bucket holds at most ``capacity`` rows per exchange epoch; overflow
    rows are *dropped and counted* (``ShardRuntime.sync()`` surfaces the
    exact totals),
  * rows are fixed-width records of one numpy dtype, appended raw (no
    header) so spills cost O(spill) bytes; rows stay on the host,
  * a writer accumulates into ``*.tmp`` files during the epoch and
    *seals* them (atomic rename) at sync: a worker killed mid-epoch
    leaves only ``.tmp`` strays, which readers ignore and
    :func:`cleanup_strays` removes.  A sealed file is immutable; the
    destination deletes it after applying.

Besides the reference's numpy owner maps, :func:`block_owner` gives the
block owner on torch tensors, by which the sharded implicit BFS routes
its device-side expansion and the distance oracle's sharded front routes
queries.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from . import faults

__all__ = [
    "hash_rows_np", "hash_owner_np", "block_owner_np", "block_owner",
    "block_size",
    "BucketSender", "BucketWriter", "iter_incoming", "incoming_files",
    "cleanup_strays",
]


# The per-backend bytes-on-wire ledger (docs/observability.md).  One flat
# namespace, keys prefixed by backend kind: a sharded run reports exactly
# which wire its buckets rode and how many bytes crossed it.  Registered
# eagerly so scopes/snapshots always see every key.
TRANSPORT_STATS = obs.counters("transport", {
    f"{kind}_{which}": 0
    for kind in ("fs", "tcp", "loopback")
    for which in ("bytes_out", "bytes_in", "buckets_out", "buckets_in")
})


# ------------------------------------------------------------- owner maps

def hash_rows_np(rows: np.ndarray, seed: int = 0x9E3779B9) -> np.ndarray:
    """Numpy mirror of ``types.hash_rows`` — same FNV-ish mix, bit for bit."""
    rows = np.asarray(rows)
    h = np.full(rows.shape[:-1], np.uint32(seed), np.uint32)
    with np.errstate(over="ignore"):
        for j in range(rows.shape[-1]):
            w = rows[..., j].astype(np.uint32)
            h = (h ^ w) * np.uint32(0x01000193)
            h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x85EBCA6B)
    return h ^ (h >> np.uint32(13))


def hash_owner_np(rows: np.ndarray, nshards: int) -> np.ndarray:
    """Owner shard of an element/key row under hash distribution."""
    return (hash_rows_np(rows) % np.uint32(nshards)).astype(np.int32)


def block_size(n: int, nshards: int) -> int:
    """Rows per shard under block distribution (ceil — last shard short)."""
    return -(-n // nshards)


def block_owner_np(idx: np.ndarray, n: int, nshards: int) -> np.ndarray:
    """Owner shard of array index idx under block distribution."""
    per = block_size(n, nshards)
    return (np.asarray(idx, np.int64) // per).astype(np.int32)


def block_owner(idx, n: int, nshards: int) -> torch.Tensor:
    """Owner shard of each array index under block distribution, as int32
    on the indices' device (array-likes land on the CPU)."""
    per = block_size(n, nshards)
    return (torch.as_tensor(idx, dtype=torch.int64) // per).to(torch.int32)


# ---------------------------------------------------------- file protocol
#
# Final (sealed) bucket: e{epoch:06d}_s{src:03d}_d{dst:03d}.bin
# In-flight bucket:      the same + ".tmp"  (ignorable garbage if orphaned)
# Seal marker:           e{epoch:06d}_s{src:03d}_d{dst:03d}.done
#                        (pipelined exchange only — written AFTER the data
#                        rename, so a marker guarantees the bucket, if any,
#                        is already published; absence of a marker in
#                        barrier mode keeps the on-disk layout byte
#                        identical to the pre-transport protocol)

def _bucket_name(epoch: int, src: int, dst: int) -> str:
    return f"e{epoch:06d}_s{src:03d}_d{dst:03d}.bin"


def _done_name(epoch: int, src: int, dst: int) -> str:
    return f"e{epoch:06d}_s{src:03d}_d{dst:03d}.done"


class BucketSender:
    """Backend-independent half of the bucket protocol: routing rows to
    destinations, per-epoch capacity enforcement with EXACT dropped
    counts, and RAM-bounded buffering.  This is the interface contract
    every transport backend must preserve (docs/transports.md):

      * ``put(dest, rows)`` buffers rows toward their destination shard,
        spilling through ``_append`` past ``buf_rows`` buffered rows so
        an epoch's traffic never outgrows RAM.  Rows past a destination's
        per-epoch ``capacity`` are dropped AND counted, never silently.
      * ``seal(epoch)`` flushes, atomically publishes every destination's
        bucket through ``_publish`` and returns the exact per-destination
        dropped counts.  Until seal, a reader must see NOTHING of the
        epoch's traffic; a sender killed mid-epoch leaves only ignorable
        strays.

    Subclasses supply the wire: ``_append(dst, data)`` persists one spill
    (idempotent under the transient-retry discipline — ``faults``' torn/
    retry semantics) and ``_publish(epoch, publish_done)`` makes every
    non-empty destination bucket visible atomically.  ``kind`` names the
    backend in the ``transport`` counter namespace."""

    kind = "abstract"

    def __init__(self, src: int, nshards: int, width: int,
                 dtype="int64", capacity: Optional[int] = None,
                 buf_rows: int = 1 << 15):
        self.src = int(src)
        self.nshards = int(nshards)
        self.width = int(width)
        self.dtype = np.dtype(dtype)
        self.capacity = None if capacity is None else int(capacity)
        self.buf_rows = int(buf_rows)
        self._bufs: List[List[np.ndarray]] = [[] for _ in range(nshards)]
        self._nbuf = 0
        # Rows accepted / dropped / bytes appended per destination THIS
        # epoch (bytes feed the per-backend bytes-on-wire counters).
        self._accepted = np.zeros(nshards, np.int64)
        self._dropped = np.zeros(nshards, np.int64)
        self._bytes = np.zeros(nshards, np.int64)

    def put(self, dest: np.ndarray, rows: np.ndarray) -> None:
        """Route rows to their destination buckets.  dest: (m,) shard ids in
        [0, nshards); rows: (m, width).  Rows past a destination's epoch
        capacity are dropped and counted (the bin_by_dest convention)."""
        dest = np.asarray(dest, np.int64).reshape(-1)
        rows = np.ascontiguousarray(rows, self.dtype).reshape(-1, self.width)
        assert dest.shape[0] == rows.shape[0]
        if not dest.shape[0]:
            return
        order = np.argsort(dest, kind="stable")
        dest, rows = dest[order], rows[order]
        bounds = np.searchsorted(dest, np.arange(self.nshards + 1))
        for d in range(self.nshards):
            lo, hi = bounds[d], bounds[d + 1]
            if hi <= lo:
                continue
            take = hi - lo
            if self.capacity is not None:
                room = max(0, self.capacity - int(self._accepted[d]))
                if take > room:
                    self._dropped[d] += take - room
                    take = room
            if take:
                self._bufs[d].append(rows[lo:lo + take])
                self._accepted[d] += take
                self._nbuf += take
        if self._nbuf >= self.buf_rows:
            self._spill()

    def _spill(self) -> None:
        for d, buf in enumerate(self._bufs):
            if not buf:
                continue
            rec = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            data = np.ascontiguousarray(rec, self.dtype).tobytes()
            self._append(d, data)
            self._bytes[d] += len(data)
            self._bufs[d] = []
        self._nbuf = 0

    def seal(self, epoch: int, publish_done: bool = False) -> np.ndarray:
        """Publish this epoch's buckets atomically and reset.

        Returns the (nshards,) per-destination dropped counts for the
        epoch.  Destinations that received no rows publish no bucket — the
        reader treats absence as an empty bucket.  With ``publish_done``
        (the pipelined exchange) every destination additionally gets a
        completion marker AFTER its data is published, so a receiver can
        consume this source incrementally without waiting for the level
        barrier."""
        with obs.span("bucket.seal", epoch=epoch, src=self.src,
                      rows=int(self._accepted.sum())):
            self._spill()
            with obs.span("bucket.send", epoch=epoch, src=self.src,
                          transport=self.kind, bytes=int(self._bytes.sum())):
                self._publish(epoch, publish_done)
            obs.add(TRANSPORT_STATS, f"{self.kind}_bytes_out",
                    int(self._bytes.sum()))
            obs.add(TRANSPORT_STATS, f"{self.kind}_buckets_out",
                    int(np.count_nonzero(self._bytes)))
            dropped = self._dropped.copy()
            self._accepted[:] = 0
            self._dropped[:] = 0
            self._bytes[:] = 0
            return dropped

    # ------------------------------------------------ backend hooks
    def _append(self, dst: int, data: bytes) -> None:
        raise NotImplementedError

    def _publish(self, epoch: int, publish_done: bool) -> None:
        raise NotImplementedError


class BucketWriter(BucketSender):
    """The shared-filesystem bucket backend — the paper's original shape.

    One source's outgoing per-destination buckets accumulate in ``.tmp``
    files under the structure's exchange directory; ``seal(epoch)``
    renames every ``.tmp`` to its final epoch-stamped name (the atomic
    publish the destination's reader looks for).  The on-disk layout in
    barrier mode is byte-identical to the pre-transport protocol."""

    kind = "fs"

    def __init__(self, root: str, src: int, nshards: int, width: int,
                 dtype="int64", capacity: Optional[int] = None,
                 buf_rows: int = 1 << 15):
        os.makedirs(root, exist_ok=True)
        self.root = root
        super().__init__(src, nshards, width, dtype=dtype,
                         capacity=capacity, buf_rows=buf_rows)

    def _tmp_path(self, dst: int) -> str:
        # The epoch is stamped at seal time; one in-flight file per dst.
        return os.path.join(self.root, f"s{self.src:03d}_d{dst:03d}.bin.tmp")

    def _append(self, dst: int, data: bytes) -> None:
        # Positioned, truncate-on-retry append: a torn or transiently
        # failed spill can never leave partial records in the bucket.
        faults.append_bytes("bucket_spill", self._tmp_path(dst), data,
                            shard=self.src, dst=dst)

    def _publish(self, epoch: int, publish_done: bool) -> None:
        for d in range(self.nshards):
            tmp = self._tmp_path(d)
            if os.path.exists(tmp):
                final = os.path.join(
                    self.root, _bucket_name(epoch, self.src, d))
                faults.retry_io("bucket_seal",
                                lambda t=tmp, f=final: os.replace(t, f),
                                shard=self.src, dst=d)
        if publish_done:
            # Markers land strictly after the data renames: a marker's
            # existence means this source's bucket for that destination
            # (if any) is already readable.
            for d in range(self.nshards):
                marker = os.path.join(
                    self.root, _done_name(epoch, self.src, d))
                faults.retry_io("bucket_seal",
                                lambda m=marker: open(m, "wb").close(),
                                shard=self.src, dst=d)


# ----------------------------------------------------------------- reader

def incoming_files(root: str, dst: int, epoch: int) -> List[Tuple[int, str]]:
    """Sealed bucket files destined to ``dst`` for ``epoch``, as sorted
    (src, path) pairs — ascending src, the deterministic apply order the
    sharded hash table's per-key sequencing relies on."""
    if not os.path.isdir(root):
        return []
    suffix = f"_d{dst:03d}.bin"
    prefix = f"e{epoch:06d}_s"
    out = []
    for fn in os.listdir(root):
        if fn.startswith(prefix) and fn.endswith(suffix):
            out.append((int(fn[len(prefix):len(prefix) + 3]),
                        os.path.join(root, fn)))
    return sorted(out)


def iter_incoming(root: str, dst: int, epoch: int, width: int,
                  dtype="int64", consume: bool = True
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """Stream (src, rows) for every sealed bucket aimed at ``dst`` this
    epoch, ascending src.  With ``consume=True`` each file is deleted
    after it is yielded (the destination owns sealed files)."""
    # Generator span: opens at first advance, closes when the stream is
    # exhausted or the consumer abandons it (GeneratorExit unwinds the
    # ``with``; obs tolerates the out-of-LIFO end).
    with obs.span("bucket.apply", epoch=epoch, dst=dst):
        dt = np.dtype(dtype)
        for src, path in incoming_files(root, dst, epoch):
            rows = np.fromfile(path, dtype=dt)
            assert rows.size % width == 0, f"torn bucket file {path}"
            yield src, rows.reshape(-1, width)
            if consume:
                os.remove(path)


# ---------------------------------------------------------------- cleanup

def cleanup_strays(root: str) -> List[str]:
    """Remove in-flight strays orphaned by a killed worker: ``.tmp``
    buckets, plus any foreign ``.pass`` files (op-log pass snapshots
    belong under structure dirs, never in an exchange dir — one here is
    wreckage).  What gets swept is booked, not silently discarded:
    ``extsort.STATS['stray_files_swept'/'stray_bytes_swept']`` report the
    count and bytes so a fresh=False startup says what it cleaned.

    Sealed files are NOT touched — an epoch sealed but not yet applied is
    real queued data; only the runtime's ``fresh`` wipe discards those.
    Returns the removed paths (tests assert on them)."""
    from . import extsort          # lazy: extsort is downstream of us
    removed = []
    if not os.path.isdir(root):
        return removed
    for fn in sorted(os.listdir(root)):
        if fn.endswith(".tmp") or fn.endswith(".pass"):
            path = os.path.join(root, fn)
            try:
                obs.add(extsort.STATS, "stray_bytes_swept",
                        os.path.getsize(path))
            except OSError:
                pass
            os.remove(path)
            obs.add(extsort.STATS, "stray_files_swept", 1)
            removed.append(path)
    return removed
