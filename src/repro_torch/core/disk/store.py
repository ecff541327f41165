"""Chunked on-disk row store — Tier D's backing file format: the port's
own copy of ``repro/core/disk/store.py``.  Each package reopens the
other's stores: the chunk files and ``meta.json`` are the same bytes.

A store is a directory of fixed-size ``.npy`` chunks plus a small JSON
manifest. Appends are RAM-buffered up to one chunk (Roomy's write buffer);
reads are streaming, chunk at a time. Rows are (width,) unsigned words,
matching Tier J's element codec, but any numpy dtype works.

Sortedness invariant (the sort-once engine's contract)
------------------------------------------------------
A store may claim ``sorted == True`` only when the concatenation of its
chunks, in chunk order, is lexicographically non-decreasing row-wise.  The
flag is never inferred: a producer that emitted sorted output (external
sort, merge pass, streaming dedupe) asserts it via :meth:`mark_sorted`,
which validates chunk-boundary monotonicity against the recorded per-chunk
key ranges and persists the claim in the manifest.  Any subsequent
:meth:`append` clears the flag — unsorted data may then follow.

For 4-byte unsigned stores the manifest also records each chunk's
``[min, max]`` row key (big-endian byte key, see :func:`row_keys`), whether
or not the store is sorted.  Consumers use the ranges to prune chunks that
cannot intersect a query window (the reference's ``MembershipProbe`` in
``extsort.py``), so a BFS level never reads visited-set chunks outside the
frontier's key range.

The manifest is written only on :meth:`flush` — in-memory state is
authoritative between flushes. A crash between flushes therefore loses
*everything appended since the last flush()*, not just the RAM buffer:
chunk files past the manifest's ``n_chunks`` are invisible on reopen and
will be overwritten. Producers call flush() at their durability points
(end of an operation); mid-stream crash-recovery is explicitly not a
goal of this scratch tier.

Compressed stores (docs/compression.md)
---------------------------------------
``codec="keys"`` stores chunks varint-delta-compressed (disk/codec.py)
instead of raw ``.npy`` — each chunk's rows must be internally sorted
(run producers guarantee this; the encoder raises ``CodecError``
otherwise).  The codec is a *store* property persisted in the manifest,
so a reopened or checkpoint-restored store keeps its own format and a
run set may mix compressed and uncompressed runs freely — ``load_chunk``
decodes transparently.  Rows without a lossless uint64 key packing
(width > 2, or non-4-byte-unsigned dtypes) silently degrade to raw —
the when-not-to-compress rule.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import codec as _codec
from . import faults


def _write_bytes(path: str, buf: bytes) -> None:
    with open(path, "wb") as f:
        f.write(buf)


def _lex_extreme_key(rows: np.ndarray, mode: str) -> bytes:
    """Byte key of the lexicographic min/max row — O(width) column passes
    (numpy can't reduce min/max over 'S' dtype directly)."""
    sel = np.arange(rows.shape[0])
    for j in range(rows.shape[1]):
        col = np.asarray(rows[sel, j])
        ext = col.min() if mode == "min" else col.max()
        sel = sel[col == ext]
        if sel.size == 1:
            break
    return bytes(row_keys(np.asarray(rows[sel[:1]]))[0])


def row_keys(rows: np.ndarray) -> np.ndarray:
    """(n,) fixed-length byte keys whose order == lexicographic row order.

    Big-endian unsigned words compared bytewise == numeric lexicographic
    order; numpy's 'S' dtype is ordered and searchsorted/isin-compatible.
    """
    w = rows.shape[1]
    be = np.ascontiguousarray(rows, dtype=">u4")
    return be.view(np.dtype(("S", 4 * w))).reshape(-1)


class ChunkStore:
    def __init__(self, path: str, width: int, dtype="uint32",
                 chunk_rows: int = 1 << 16, fresh: bool = False,
                 codec: Optional[str] = None):
        self.path = path
        self.width = width
        self.dtype = np.dtype(dtype)
        self.chunk_rows = int(chunk_rows)
        if fresh and os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        self._meta_path = os.path.join(path, "meta.json")
        self.sorted = False
        assert codec in (None, "keys"), f"unknown store codec {codec!r}"
        if codec == "keys" and not (
                self.dtype.kind == "u" and self.dtype.itemsize == 4
                and width <= _codec.max_packable_width()):
            codec = None               # no lossless packing: raw fallback
        self.codec = codec
        # Per-chunk (min_key, max_key) byte pairs; None entries for dtypes
        # without a defined byte-key order (anything but 4-byte unsigned).
        self._chunk_ranges: List[Optional[Tuple[bytes, bytes]]] = []
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            assert meta["width"] == width, "store width mismatch"
            self.n_chunks = meta["n_chunks"]
            self.total_rows = meta["total_rows"]
            self.chunk_rows = meta["chunk_rows"]
            self.sorted = bool(meta.get("sorted", False))
            # The manifest's codec is authoritative for existing chunks
            # (a checkpoint-restored run keeps its own format regardless
            # of what the resuming search would create fresh).  An
            # unknown name is a format-version mismatch — fail loudly
            # before a chunk is misread, not with a numpy parse error.
            self.codec = meta.get("codec")
            if self.codec not in (None, "keys"):
                raise _codec.CodecError(
                    f"store manifest {self._meta_path} names chunk codec "
                    f"{self.codec!r}; this build only decodes 'keys' — "
                    "artifact written by a newer format version?")
            self._chunk_ranges = [
                (bytes.fromhex(r[0]), bytes.fromhex(r[1])) if r else None
                for r in meta.get("chunk_ranges", [None] * self.n_chunks)]
        else:
            # Meta is written lazily (first flush): store directories live on
            # scratch filesystems where every extra file op costs real time.
            self.n_chunks = 0
            self.total_rows = 0
        self._buf: List[np.ndarray] = []
        self._buf_rows = 0
        # True whenever the on-disk manifest lags the in-memory state
        # (chunks flushed since the last _write_meta).
        self._meta_dirty = not os.path.exists(self._meta_path)

    # ------------------------------------------------------------- write
    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=self.dtype).reshape(-1, self.width)
        self.sorted = False            # producers re-assert via mark_sorted()
        self._buf.append(rows)
        self._buf_rows += rows.shape[0]
        while self._buf_rows >= self.chunk_rows:
            self._flush_chunk(self.chunk_rows)

    def flush(self, mark_sorted: bool = False) -> None:
        """Persist buffered rows + manifest. mark_sorted=True additionally
        claims the sortedness invariant in the same (single) meta write —
        the common producer epilogue ``flush(); mark_sorted()`` would pay
        two manifest writes."""
        while self._buf_rows > 0:
            self._flush_chunk(min(self._buf_rows, self.chunk_rows))
        if mark_sorted:
            self._validate_sorted_ranges()
            self.sorted = True
        self._write_meta()

    def _keyed(self) -> bool:
        return self.dtype.kind == "u" and self.dtype.itemsize == 4

    def _flush_chunk(self, nrows: int) -> None:
        buf = np.concatenate(self._buf, axis=0) if len(self._buf) > 1 else self._buf[0]
        chunk, rest = buf[:nrows], buf[nrows:]
        # Whole-file rewrite → idempotent → safe under transient retry.
        if self.codec == "keys":
            enc = _codec.encode_keys(np.asarray(chunk), tag="extsort")
            faults.retry_io(
                "chunk_flush",
                lambda: _write_bytes(self._chunk_path(self.n_chunks), enc))
        else:
            faults.retry_io(
                "chunk_flush",
                lambda: np.save(self._chunk_path(self.n_chunks), chunk))
        if self._keyed():
            self._chunk_ranges.append((_lex_extreme_key(chunk, "min"),
                                       _lex_extreme_key(chunk, "max")))
        else:
            self._chunk_ranges.append(None)
        self.n_chunks += 1
        self.total_rows += chunk.shape[0]
        self._meta_dirty = True
        self._buf = [rest] if rest.shape[0] else []
        self._buf_rows = rest.shape[0]
        # Meta is deliberately NOT rewritten here: one JSON serialization +
        # atomic rename per chunk turns long append streams into O(n_chunks)
        # meta churn. flush() persists; in-memory state rules in between.

    def _write_meta(self) -> None:
        def _do() -> None:
            tmp = self._meta_path + ".tmp"
            with open(tmp, "w") as f:
                meta = {"width": self.width, "dtype": self.dtype.name,
                        "chunk_rows": self.chunk_rows,
                        "n_chunks": self.n_chunks,
                        "total_rows": self.total_rows,
                        "sorted": self.sorted,
                        "chunk_ranges": [
                            [r[0].hex(), r[1].hex()] if r else None
                            for r in self._chunk_ranges]}
                if self.codec:      # absent == raw: old manifests unchanged
                    meta["codec"] = self.codec
                json.dump(meta, f)
            os.replace(tmp, self._meta_path)       # atomic
        faults.retry_io("meta_write", _do)
        self._meta_dirty = False

    def _validate_sorted_ranges(self) -> None:
        for i in range(1, self.n_chunks):
            cur, prev = self._chunk_ranges[i], self._chunk_ranges[i - 1]
            if cur is not None and prev is not None and cur[0] < prev[1]:
                raise ValueError(
                    f"mark_sorted: chunk {i} starts below chunk {i-1}'s max")

    def mark_sorted(self) -> None:
        """Producer's claim that rows (in chunk order) are globally sorted.

        Requires a flushed store; validates chunk-boundary monotonicity
        against recorded key ranges and persists the flag.  (Producers that
        are about to flush anyway should use ``flush(mark_sorted=True)`` —
        one manifest write instead of two.)
        """
        assert self._buf_rows == 0, "flush() before mark_sorted()"
        self._validate_sorted_ranges()
        self.sorted = True
        self._write_meta()

    # ------------------------------------------------------------ export
    def export_to(self, dst: str) -> int:
        """Copy this store (chunks + manifest) to ``dst``, byte-identical.

        Requires a flushed store — the manifest is the durable contract,
        and exporting unflushed RAM state would seal a store whose manifest
        disagrees with its chunk files.  A store whose chunks auto-flushed
        without a manifest write (append of an exact chunk multiple) gets
        its manifest synced here first, so the export can never undercount
        chunks.  Used by the checkpoint layer (``checkpoint.py``), which
        books the returned byte count under the ``ckpt_*`` counters.
        Returns bytes copied.
        """
        assert self._buf_rows == 0, "flush() before export_to()"
        if self._meta_dirty:
            self._write_meta()
        os.makedirs(dst, exist_ok=True)
        total = 0
        for fn in sorted(os.listdir(self.path)):
            p = os.path.join(self.path, fn)
            if os.path.isfile(p):
                shutil.copyfile(p, os.path.join(dst, fn))
                total += os.path.getsize(p)
        return total

    # -------------------------------------------------------------- read
    def _chunk_path(self, i: int) -> str:
        ext = "rmz" if self.codec else "npy"
        return os.path.join(self.path, f"c{i:06d}.{ext}")

    def load_chunk(self, i: int) -> np.ndarray:
        if self.codec == "keys":
            with open(self._chunk_path(i), "rb") as f:
                return _codec.decode_keys(f.read(), tag="extsort")
        return np.load(self._chunk_path(i), mmap_mode="r")

    def key_reader(self, i: int) -> Optional["_codec.CompressedKeyReader"]:
        """Skip-indexed lazy reader for a compressed chunk (None for raw
        stores — callers fall back to :meth:`load_chunk`).  Lets probes
        decode only the blocks a query window intersects."""
        if self.codec != "keys":
            return None
        with open(self._chunk_path(i), "rb") as f:
            return _codec.CompressedKeyReader(f.read(), tag="extsort")

    def chunk_range(self, i: int) -> Optional[Tuple[bytes, bytes]]:
        """(min_key, max_key) of chunk i, or None if the dtype is unkeyed."""
        return self._chunk_ranges[i]

    def iter_chunks(self) -> Iterator[np.ndarray]:
        """Stream chunks (memory-mapped — only touched pages load)."""
        for i in range(self.n_chunks):
            yield self.load_chunk(i)
        if self._buf_rows:
            yield (np.concatenate(self._buf, axis=0)
                   if len(self._buf) > 1 else self._buf[0])

    def read_all(self) -> np.ndarray:
        """Materialize everything (tests/small data only)."""
        parts = list(self.iter_chunks())
        if not parts:
            return np.zeros((0, self.width), self.dtype)
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    @property
    def size(self) -> int:
        return self.total_rows + self._buf_rows

    def destroy(self) -> None:
        self._buf, self._buf_rows = [], 0
        shutil.rmtree(self.path, ignore_errors=True)
