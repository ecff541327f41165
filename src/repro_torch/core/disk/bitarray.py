"""DiskBitArray — the paper's 2-bit RoomyArray on real disk (Tier D), with
each chunk's in-memory pass on the card: the port of
``repro/core/disk/bitarray.py``.

A packed array of 2-bit elements indexed by permutation rank, with
*delayed* random-access updates batched into streaming passes.  What lies
on disk is the reference's, byte for byte, and each package reads the
other's:

  * chunk ``c`` is ``b%06d.npy`` (``np.save`` of its ``ceil(rows/4)``
    bytes, four fields a byte at bits 2j, tail fields 0) or, with
    ``compress=True``, ``b%06d.rmz`` (the rle2 codec); the loader
    detects the format per file;
  * ``update(idx, vals)`` bins ops to their owner chunk's op log,
    ``log%06d.bin``: raw int64 (idx, val) pairs, spilled from RAM past
    ``log_buf_rows`` ops through ``faults.append_bytes``
    (``oplog_append``);
  * a pass promotes every ``.bin`` to ``.pass`` when it opens, so marks
    queued during it land in fresh logs it never reads, and consumes a
    chunk's ``.pass`` only after the chunk is written back: a pass that
    raises leaves its ``.pass`` files to be adopted again;
  * ``STATS`` (the ``bits`` namespace) and the pass ledger
    (``extsort.STATS``) book the reference's values.

What moves to the card is a chunk's pass.  A chunk that a pass visits is
loaded from disk as its bytes, padded to whole words and sent to the
array's device as int32 words with the same bits (16 fields a word at
bits 2j is 4 fields a byte at bits 2j); it is written back as exactly
``ceil(rows/4)`` bytes.  Two routes:

  * **generic** (``run_pass`` / ``sync`` with ``combine`` / ``apply``,
    ``map_chunks``, ``map_update``, ``get``, ``count_values``,
    ``read_all``): the words unpack to (rows,) uint8 on the device; the
    log is sorted and segment-combined there; user functions take and
    return torch tensors on the device;
  * **packed** (``run_pass(plan, mark=(value, only_if))``, the implicit
    BFS's level passes): a chunk's log holds marks, every payload
    ``value``, and goes to the kernels as int32 local offsets.  A plan
    that opens with a ``rotates`` stage (and the ``counts`` stage after
    it) runs fused as one K1 launch a chunk — mark ``value`` where the
    field holds ``only_if``, map through the lut, count — or, with
    ``fuse=False``, as K2 (chunks with a log) then K3 (every chunk).  The
    stages after it see the unpacked result.

``update`` bins ops on the device by a stable sort of their owner chunk
and sends each chunk's records to its host log in the reference's order.
Element indices are int64 everywhere outside a chunk; only a chunk's
local offsets reach the kernels as int32.
"""
from __future__ import annotations

import os
import shutil
import uuid
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ... import device as _device
from .. import bitarray as BA
from .. import obs
from . import codec as _codec
from . import faults
from .passes import PassPlan, record_pass
from .store import _write_bytes

VALS_PER_BYTE = 4
BYTES_PER_WORD = 4

# The 2-bit BFS mark encoding (the reference's; UNSEEN must be 0 so a
# fresh zeroed array is all-unseen for free).
UNSEEN, CUR, NEXT, DONE = BA.UNSEEN, BA.CUR, BA.NEXT, BA.DONE

# Pass/byte accounting, the reference's names and values.  bytes_read /
# bytes_written are totals; log_bytes_read / log_bytes_written are the
# op-log subset, so packed-ARRAY traversal bytes are exactly bytes_read -
# log_bytes_read (ditto written).
STATS = obs.counters("bits", {
    "bytes_read": 0, "bytes_written": 0, "log_bytes_read": 0,
    "log_bytes_written": 0, "sync_passes": 0, "scan_passes": 0,
    "ops_applied": 0})


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def bytes_to_words(packed: np.ndarray, device) -> torch.Tensor:
    """A chunk's packed bytes, zero-padded to whole words, as int32 words
    with the same bits on ``device``."""
    nb = packed.shape[0]
    buf = np.zeros(-(-nb // BYTES_PER_WORD) * BYTES_PER_WORD, np.uint8)
    buf[:nb] = packed
    return torch.from_numpy(buf.view("<i4")).to(device)


def words_to_bytes(words: torch.Tensor, nbytes: int) -> np.ndarray:
    """The first ``nbytes`` bytes of int32 words, as a host uint8 array."""
    return words.cpu().numpy().view(np.uint8)[:nbytes]


def segment_combine(ids: torch.Tensor, vals: torch.Tensor, combine):
    """Ordered combine-fold over runs of equal ids (ids non-decreasing):
    returns (uniq_ids, agg) with agg[j] the in-row-order fold of the vals
    whose id is uniq_ids[j] — ``extsort.segment_combine_ordered`` on
    device tensors."""
    n = ids.shape[0]
    if n == 0:
        return ids[:0], vals[:0]
    starts = torch.ones(n, dtype=torch.bool, device=ids.device)
    starts[1:] = ids[1:] != ids[:-1]
    seg = torch.cumsum(starts, 0) - 1
    uniq = ids[starts]
    agg = vals[starts].clone()
    pos = torch.arange(n, device=ids.device)
    run_pos = pos - torch.cummax(torch.where(starts, pos, 0), 0).values
    for k in range(1, int(run_pos.max()) + 1):
        sel = run_pos == k
        if not bool(sel.any()):   # no gaps: run lengths only shrink with k
            break
        agg[seg[sel]] = torch.as_tensor(combine(agg[seg[sel]], vals[sel]),
                                        dtype=agg.dtype, device=agg.device)
    return uniq, agg


class DiskBitArray:
    """Chunked packed 2-bit array with per-chunk delayed-update op logs,
    each chunk's pass on ``device`` (default ``"cuda"``)."""

    def __init__(self, workdir: str, n: int, chunk_elems: int = 1 << 22,
                 name: str | None = None, log_buf_rows: int = 1 << 20,
                 init_chunks: bool = True, compress: bool = False,
                 device=None, impl: str = "auto"):
        """``init_chunks=False`` skips writing the zeroed chunk files —
        ONLY for a caller about to :meth:`adopt_snapshot` (which supplies
        every chunk).  ``impl`` is the bit-pack kernels' (``"auto"``: the
        kernels on a CUDA device; ``"ref"``: their plain versions)."""
        assert chunk_elems % VALS_PER_BYTE == 0
        self.device = _device.resolve(device)
        self.impl = impl
        self.n = int(n)
        self.chunk_elems = int(chunk_elems)
        self.n_chunks = -(-self.n // self.chunk_elems)
        self.log_buf_rows = int(log_buf_rows)
        self.compress = bool(compress)
        name = name or f"dbits_{uuid.uuid4().hex[:8]}"
        self.path = os.path.join(workdir, name)
        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
        os.makedirs(self.path)
        if init_chunks:
            for c in range(self.n_chunks):
                rows = self._chunk_rows(c)
                self._store_packed(
                    c, np.zeros(-(-rows // VALS_PER_BYTE), np.uint8),
                    book=False, retry=False)
        self._log_bufs: List[List[np.ndarray]] = [[] for _ in
                                                  range(self.n_chunks)]
        self._log_buffered = 0

    # ----------------------------------------------------------- layout
    def _chunk_rows(self, c: int) -> int:
        return min(self.chunk_elems, self.n - c * self.chunk_elems)

    def _chunk_path(self, c: int, rmz: bool = False) -> str:
        return os.path.join(self.path,
                            f"b{c:06d}.{'rmz' if rmz else 'npy'}")

    def _log_path(self, c: int) -> str:
        # Raw append-mode int64 (idx, val) pairs — NOT .npy: spills append
        # O(spill) bytes instead of rewriting the whole accumulated log.
        return os.path.join(self.path, f"log{c:06d}.bin")

    @property
    def nbytes(self) -> int:
        """Total packed bytes on disk (the 2·N-bit budget)."""
        return sum(-(-self._chunk_rows(c) // VALS_PER_BYTE)
                   for c in range(self.n_chunks))

    # -------------------------------------------------- chunk file codec
    def _load_packed(self, c: int, book: bool = True) -> np.ndarray:
        """Load chunk ``c``'s packed bytes, detecting the file's own format
        (an adopted snapshot may carry the other side of the compressed /
        uncompressed boundary).  Books STORED bytes read."""
        pz = self._chunk_path(c, rmz=True)
        if os.path.exists(pz):
            with open(pz, "rb") as f:
                buf = f.read()
            if book:
                obs.add(STATS, "bytes_read", len(buf))
            return _codec.decode_rle2(buf, tag="bits")
        packed = np.load(self._chunk_path(c))
        if book:
            obs.add(STATS, "bytes_read", packed.nbytes)
        return packed

    def _store_packed(self, c: int, packed: np.ndarray, book: bool = True,
                      retry: bool = True) -> None:
        """Write chunk ``c`` in the LOCAL format (transcoding away any
        other-format file a snapshot adoption left), booking stored bytes
        written."""
        if self.compress:
            enc = _codec.encode_rle2(packed, tag="bits")
            path, stale = (self._chunk_path(c, rmz=True),
                           self._chunk_path(c))
            write = lambda: _write_bytes(path, enc)        # noqa: E731
            stored = len(enc)
        else:
            path, stale = (self._chunk_path(c),
                           self._chunk_path(c, rmz=True))
            write = lambda: np.save(path, packed)           # noqa: E731
            stored = packed.nbytes
        if retry:
            faults.retry_io("chunk_flush", write, chunk=c)
        else:
            write()
        if os.path.exists(stale):
            os.remove(stale)
        if book:
            obs.add(STATS, "bytes_written", stored)

    def _load_words(self, c: int, book: bool = True) -> torch.Tensor:
        return bytes_to_words(self._load_packed(c, book=book), self.device)

    def _store_words(self, c: int, words: torch.Tensor, **kw) -> None:
        self._store_packed(c, words_to_bytes(
            words, -(-self._chunk_rows(c) // VALS_PER_BYTE)), **kw)

    def _unpack(self, words: torch.Tensor, rows: int) -> torch.Tensor:
        return BA.unpack_values(words)[:rows].to(torch.uint8)

    @staticmethod
    def _read_log(path: str) -> np.ndarray:
        """A chunk's op log as (m, 2) int64 (idx, val) records, booked."""
        log = np.fromfile(path, dtype=np.int64).reshape(-1, 2)
        obs.add(STATS, "bytes_read", log.nbytes)
        obs.add(STATS, "log_bytes_read", log.nbytes)
        return log

    # ------------------------------------------------------ delayed ops
    def update(self, idx, vals) -> None:
        """Queue delayed writes vals∈0..3 at idx (bucketed to owner chunks).

        ``idx`` and ``vals`` are tensors (or array-likes) of one shape;
        they are binned on the array's device by a stable sort of the owner
        chunk, and each chunk's (idx, val) records go to its in-RAM log in
        issue order.  Out-of-range indices drop.  Once ``log_buf_rows``
        ops are buffered they spill to the per-chunk log files."""
        dev = self.device
        idx = torch.as_tensor(idx, device=dev).reshape(-1).to(torch.int64)
        vals = torch.as_tensor(vals, device=dev).reshape(-1).to(torch.uint8)
        assert idx.shape == vals.shape
        ok = (idx >= 0) & (idx < self.n)
        idx, vals = idx[ok], vals[ok]      # drop out-of-range, like Tier J
        m = idx.shape[0]
        if not m:
            return
        chunk_of = idx // self.chunk_elems
        order = torch.sort(chunk_of, stable=True).indices
        rec = torch.stack([idx[order], vals[order].to(torch.int64)], dim=1)
        counts = torch.bincount(chunk_of, minlength=self.n_chunks)
        rec = rec.cpu().numpy()
        bounds = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
        for c in np.flatnonzero(bounds[1:] > bounds[:-1]).tolist():
            self._log_bufs[c].append(rec[bounds[c]:bounds[c + 1]])
        self._log_buffered += m
        if self._log_buffered >= self.log_buf_rows:
            self._flush_logs()

    def _flush_logs(self) -> None:
        for c, buf in enumerate(self._log_bufs):
            if not buf:
                continue
            rec = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            # Positioned truncate-on-retry append: a torn spill attempt can
            # never leave a partial (idx, val) record in the op log.  The
            # records go as a flat byte view, not a copy.
            faults.append_bytes(
                "oplog_append", self._log_path(c),
                np.ascontiguousarray(rec, np.int64).view(np.uint8).reshape(-1),
                chunk=c)
            obs.add(STATS, "bytes_written", rec.nbytes)
            obs.add(STATS, "log_bytes_written", rec.nbytes)
            self._log_bufs[c] = []
        self._log_buffered = 0

    # -------------------------------------------------------------- sync
    def sync(self, combine: Optional[Callable] = None,
             apply: Optional[Callable] = None,
             transform: Optional[Callable] = None) -> None:
        """Execute all queued updates in one streaming pass (generic route).

        combine(p1, p2): associative merge of two values aimed at one index
            (default: bitwise OR).
        apply(old_vals, agg_vals) -> new_vals at the touched indices
            (default: overwrite with the aggregate).
        transform(start, vals) -> vals: if given, runs on EVERY chunk after
            its updates apply.

        Sugar over :meth:`run_pass` with a single-producer plan."""
        plan = PassPlan("sync")
        if transform is not None:
            plan.writes(transform)
        self.run_pass(plan, combine=combine, apply=apply)

    def _promote_logs(self) -> None:
        """Promote current logs to a read-only snapshot (.pass); a leftover
        snapshot of an aborted pass is re-adopted in front of the newer
        records so no queued op is ever lost."""
        for c in range(self.n_chunks):
            lp, sp = self._log_path(c), self._log_path(c) + ".pass"
            if os.path.exists(sp):
                if os.path.exists(lp):
                    with open(sp, "ab") as dst, open(lp, "rb") as src:
                        dst.write(src.read())
                    os.remove(lp)
            elif os.path.exists(lp):
                os.replace(lp, sp)

    def run_pass(self, plan: PassPlan, combine: Optional[Callable] = None,
                 apply: Optional[Callable] = None,
                 mark: Optional[Tuple[int, int]] = None,
                 fuse: bool = True) -> None:
        """Apply all queued updates AND the plan's stages in ONE traversal.

        Each chunk is loaded once, its snapshot ops applied, then threaded
        through the plan's stages in order, and written back only if it
        was dirtied (ops applied or a write stage ran).  Updates queued by
        stages during the traversal accumulate in fresh logs for the NEXT
        pass.

        ``mark=(value, only_if)`` takes the packed route: every queued op
        must carry ``value``, and applies as "field ← value where it holds
        ``only_if``" — the reference's ``combine=first``, ``apply=where(old
        == only_if, agg, old)`` — through K1 fused with the plan's leading
        ``rotates`` stage (``fuse=True``), or K2 then that stage as K3.
        Otherwise ``combine`` / ``apply`` run on the device (generic).
        """
        if mark is not None and (combine is not None or apply is not None):
            raise ValueError("run_pass: mark= replaces combine= and apply=")
        if combine is None:
            combine = torch.bitwise_or
        if apply is None:
            apply = lambda old, agg: agg                   # noqa: E731
        any_log = any(
            bool(self._log_bufs[c]) or os.path.exists(self._log_path(c))
            or os.path.exists(self._log_path(c) + ".pass")
            for c in range(self.n_chunks))
        writes = plan.writes_chunks or any_log
        # The span opens BEFORE the log flush/promotion so the queued-op
        # spill bytes land in this pass's metrics.
        with obs.span("pass.rw" if writes else "pass.read", plan=plan.name,
                      chunks=self.n_chunks):
            self._flush_logs()
            self._promote_logs()
            obs.add(STATS, "sync_passes", 1)
            record_pass(plan.n_stages + (1 if any_log else 0), writes=writes)
            for c in range(self.n_chunks):
                sp = self._log_path(c) + ".pass"
                has_log = os.path.exists(sp)
                if not has_log and not plan.forces_full_traversal:
                    continue
                words = self._load_words(c)
                log = self._read_log(sp) if has_log else None
                if log is not None and log.shape[0]:
                    obs.add(STATS, "ops_applied", int(log.shape[0]))
                if mark is None:
                    words = self._generic_chunk(c, words, log, plan,
                                                combine, apply)
                else:
                    words = self._packed_chunk(c, words, log, plan, mark,
                                               fuse)
                if has_log or plan.writes_chunks:
                    self._store_words(c, words)
                if has_log:
                    # Consumed only after the chunk lands: a stage raising
                    # mid-pass leaves the snapshot for the next pass to
                    # re-adopt instead of silently dropping this chunk's
                    # queued ops.
                    os.remove(sp)

    def _local(self, c: int, log: np.ndarray) -> torch.Tensor:
        """A log's records on the device, as (m, 2) int64 with the indices
        made local to chunk ``c``."""
        rec = torch.from_numpy(log).to(self.device)
        return rec - torch.tensor([c * self.chunk_elems, 0],
                                  dtype=torch.int64, device=self.device)

    def _generic_chunk(self, c, words, log, plan, combine, apply):
        rows = self._chunk_rows(c)
        vals = self._unpack(words, rows)
        if log is not None and log.shape[0]:
            rec = self._local(c, log)
            local, pay = rec[:, 0], rec[:, 1].to(torch.uint8)
            order = torch.sort(local, stable=True).indices
            uniq, agg = segment_combine(local[order], pay[order], combine)
            vals[uniq] = torch.as_tensor(apply(vals[uniq], agg),
                                         device=vals.device).to(torch.uint8)
        vals = plan.apply_chunk(c * self.chunk_elems, vals)
        assert vals.shape[0] == rows
        return BA.pack_values(vals)

    def _packed_chunk(self, c, words, log, plan, mark, fuse):
        rows = self._chunk_rows(c)
        start = c * self.chunk_elems
        value, only_if = mark
        idx = None
        if log is not None and log.shape[0]:
            rec = self._local(c, log)
            if bool((rec[:, 1] != value).any()):
                raise ValueError(f"run_pass(mark={mark}): chunk {c}'s log "
                                 f"holds payloads other than {value}")
            idx = rec[:, 0].to(torch.int32)
            del rec
        head, used, counted = plan.packed_head()
        kw = dict(mark=value, only_if=only_if, impl=self.impl)
        cnt = None
        if head is not None and fuse:
            if idx is None:
                idx = torch.empty(0, dtype=torch.int32, device=self.device)
            cv = counted.count if counted is not None else 0
            words, cnt = BA.mark_rotate_count(words, idx, rows, lut=head.lut,
                                              count_val=cv, inplace=True,
                                              **kw)
        else:
            if idx is not None:
                words = BA.mark_packed(words, idx, **kw)
            if head is not None:
                cv = counted.count if counted is not None else 0
                words, cnt = BA.rotate_count(words, rows, lut=head.lut,
                                             count_val=cv, impl=self.impl)
        del idx                 # the marks are in: free them before
        if counted is not None:  # the stages (an expansion) run
            counted.into(start, int(cnt))
        if used < plan.n_stages:
            vals = plan.apply_chunk(start, self._unpack(words, rows),
                                    first=used)
            if any(s.writes for s in plan.stages[used:]):
                words = BA.pack_values(vals)
        return words

    # ------------------------------------------------------- checkpoint
    def snapshot_to(self, dst: str) -> int:
        """Copy the array's durable state — packed chunks, spilled op logs,
        and any ``.pass`` snapshot an aborted pass left behind — into
        ``dst``, RAM-buffered ops flushed first.  Bytes are booked under
        ``extsort.STATS['ckpt_bytes_written']``.  Returns bytes copied."""
        from .checkpoint import copy_dir_booked
        self._flush_logs()
        return copy_dir_booked(self.path, dst, "ckpt_bytes_written")

    def adopt_snapshot(self, src: str) -> int:
        """Replace this array's on-disk state with a snapshot taken by
        :meth:`snapshot_to` (same ``n`` / ``chunk_elems`` layout), clearing
        RAM log buffers and every local file first.  Returns bytes copied
        (booked under ``ckpt_bytes_read``)."""
        from .checkpoint import copy_dir_booked
        self._log_bufs = [[] for _ in range(self.n_chunks)]
        self._log_buffered = 0
        for fn in os.listdir(self.path):
            p = os.path.join(self.path, fn)
            if os.path.isfile(p):
                # A pre-adopt chunk in the OTHER codec format would shadow
                # the adopted one (the loader prefers compressed).
                os.remove(p)
        total = copy_dir_booked(src, self.path, "ckpt_bytes_read")
        for c in range(self.n_chunks):
            assert (os.path.isfile(self._chunk_path(c))
                    or os.path.isfile(self._chunk_path(c, rmz=True))), \
                f"snapshot is missing chunk {c} — torn checkpoint payload"
        return total

    # -------------------------------------------------------- streaming
    def map_chunks(self, fn: Callable[[int, torch.Tensor], None]) -> None:
        """Read-only streaming scan: fn(start_index, values on the
        device)."""
        obs.add(STATS, "scan_passes", 1)
        for c in range(self.n_chunks):
            fn(c * self.chunk_elems,
               self._unpack(self._load_words(c), self._chunk_rows(c)))

    def map_update(self, fn: Callable[[int, torch.Tensor], torch.Tensor]
                   ) -> None:
        """In-place streaming transform: vals = fn(start, vals)."""
        obs.add(STATS, "scan_passes", 1)
        for c in range(self.n_chunks):
            rows = self._chunk_rows(c)
            vals = fn(c * self.chunk_elems,
                      self._unpack(self._load_words(c), rows))
            vals = torch.as_tensor(vals, device=self.device).to(torch.uint8)
            assert vals.shape[0] == rows
            self._store_words(c, BA.pack_values(vals), retry=False)

    def count_values(self) -> torch.Tensor:
        """(4,) int64 histogram of element values on the device."""
        counts = torch.zeros(4, dtype=torch.int64, device=self.device)
        for c in range(self.n_chunks):
            vals = self._unpack(self._load_words(c), self._chunk_rows(c))
            counts += torch.bincount(vals, minlength=4)
        return counts

    # ------------------------------------------------------------- read
    def get(self, idx) -> torch.Tensor:
        """Random read (tests/debug — production access is via sync/map):
        (m,) uint8 on the device."""
        idx = torch.as_tensor(idx, device=self.device).reshape(-1).to(
            torch.int64)
        out = torch.empty(idx.shape[0], dtype=torch.uint8,
                          device=self.device)
        chunk_of = idx // self.chunk_elems
        for c in torch.unique(chunk_of).tolist():
            sel = chunk_of == c
            words = self._load_words(c, book=False)
            out[sel] = BA.get_packed(words, idx[sel] - c * self.chunk_elems
                                     ).to(torch.uint8)
        return out

    def read_all(self) -> torch.Tensor:
        """(n,) uint8 values on the device — tests/small data only."""
        parts = [self._unpack(self._load_words(c, book=False),
                              self._chunk_rows(c))
                 for c in range(self.n_chunks)]
        return (torch.cat(parts) if parts else
                torch.zeros(0, dtype=torch.uint8, device=self.device))

    def destroy(self) -> None:
        self._log_bufs = [[] for _ in range(self.n_chunks)]
        shutil.rmtree(self.path, ignore_errors=True)
