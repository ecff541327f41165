"""Compressed chunk codecs — varint-delta sorted keys, RLE 2-bit bytes:
the port's own copy of ``repro/core/disk/codec.py``, byte for byte the
same formats, refusals and ``codec`` counters.  Host I/O, so numpy.

Roomy's binding resource is disk bandwidth (paper §2): both engines are
I/O-bound at the sizes that matter, so bytes saved on scratch are passes
saved on the wall clock.  This module is the one home for the on-disk
compressed formats and their integrity rules:

* ``keys`` codec (id 1) — sorted-run rows.  Ranks within a sorted run
  are non-decreasing integers; the encoder packs each row into a uint64
  key (width ≤ 2 uint32 words — big-endian lexicographic row order ==
  numeric key order), delta-encodes within fixed-size blocks, and
  LEB128-varints the deltas.  A **skip index** of
  ``(first_key, last_key, byte_offset, n_rows)`` per block lets
  ``MembershipProbe`` range-pruning and ``PassPlan`` chunk traversal
  decode only the blocks a query window touches
  (:class:`CompressedKeyReader`).  Width > 2 has no lossless uint64
  packing — stores silently fall back to raw ``.npy`` (the
  when-not-to-compress rule, docs/compression.md).

* ``rle2`` codec (id 2) — the 2-bit array's packed bytes.  A BFS
  array is dominated by long ``UNSEEN`` (0x00) then ``DONE`` (0xFF)
  stretches; runs are stored columnar (values, then varint lengths) so
  both encode and decode are single vectorized numpy passes.

* ``wire`` framing — optional zlib compression of transport bucket
  payloads (docs/transports.md).  Bucket bytes carry *ordered* op logs
  (per-key op order is a correctness contract), so the wire codec is a
  byte-transparent wrapper, never a re-sort.

Integrity is loud by construction: every container ends in a crc32 of
everything before it, varint streams reject truncation / overlong /
overflowing encodings, and block payloads must reproduce their skip
index exactly.  Corrupt data raises :class:`CodecError` — wrong bytes
are never returned.

Accounting: raw vs stored byte counts book into the ``codec`` obs
namespace per caller tag (``{tag}_raw_bytes`` / ``{tag}_stored_bytes``
on encode, ``*_read`` on decode) plus skip-index effectiveness
(``blocks_decoded`` / ``blocks_skipped``).  Codec I/O is segregated
from the sort/merge/pass ledgers the CI gate pins — same discipline as
the ``ckpt_*`` counters — so compressed ≡ uncompressed holds for every
pass budget, by the byte.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs

__all__ = [
    "CodecError", "STATS", "MAGIC", "CODEC_KEYS", "CODEC_RLE2",
    "encode_keys", "decode_keys", "CompressedKeyReader",
    "encode_rle2", "decode_rle2", "sniff",
    "wire_encode", "wire_decode",
    "rows_to_u64", "u64_to_rows", "max_packable_width",
]

MAGIC = b"RMZ1"
WIRE_MAGIC = b"RMZW"
CODEC_KEYS = 1
CODEC_RLE2 = 2

#: Rows wider than this have no lossless uint64 key packing → raw fallback.
_MAX_KEY_WIDTH = 2

#: Rows per skip-index block (last block may be short).  Small enough
#: that a narrow probe window decodes a fraction of a chunk, large
#: enough that the 28-byte index entry amortizes to < 0.1 bit/row.
BLOCK_ROWS = 4096

_VARINT_MAX_LEN = 10          # ceil(64 / 7)

# Raw-vs-stored byte ledgers, keyed by caller tag at runtime
# (``extsort_raw_bytes``, ``bits_stored_bytes``, ...).  Lives in its own
# namespace so the sort/merge/pass budgets stay codec-blind.
STATS = obs.counters("codec", {
    "blocks_decoded": 0, "blocks_skipped": 0, "codec_errors": 0})


class CodecError(Exception):
    """Compressed data failed validation (truncated, corrupt, overlong,
    unknown codec/version).  Loud by contract: decoders raise this and
    never return wrong data."""


def _err(msg: str) -> "CodecError":
    obs.add(STATS, "codec_errors", 1)
    return CodecError(msg)


def book(tag: str, raw: int, stored: int, read: bool = False) -> None:
    """Book one encode (or decode, ``read=True``) into the codec ledger."""
    sfx = "_read" if read else ""
    for key, n in ((f"{tag}_raw_bytes{sfx}", raw),
                   (f"{tag}_stored_bytes{sfx}", stored)):
        obs.add(STATS, key, int(n))


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


# ------------------------------------------------------------------ varints

def _varint_encode(vals: np.ndarray) -> bytes:
    """LEB128-encode a uint64 array (vectorized, ≤ 10 byte-lane passes)."""
    vals = np.ascontiguousarray(vals, np.uint64)
    n = vals.shape[0]
    if n == 0:
        return b""
    nb = np.ones(n, np.int64)
    rem = vals >> np.uint64(7)
    while rem.any():
        nb[rem > 0] += 1
        rem >>= np.uint64(7)
    offs = np.zeros(n, np.int64)
    np.cumsum(nb[:-1], out=offs[1:])
    out = np.zeros(int(offs[-1] + nb[-1]), np.uint8)
    for k in range(int(nb.max())):
        sel = nb > k
        byte = ((vals[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        byte[nb[sel] > k + 1] |= 0x80          # continuation bit
        out[offs[sel] + k] = byte
    return out.tobytes()


def _varint_decode(buf: np.ndarray) -> np.ndarray:
    """Decode a whole LEB128 stream to uint64 (vectorized).

    Rejects truncation (trailing continuation bit), overlong encodings
    (> 10 bytes, or a redundant 0x00 terminal byte), and 64-bit overflow.
    """
    if buf.shape[0] == 0:
        return np.zeros(0, np.uint64)
    cont = (buf & 0x80) != 0
    ends = np.flatnonzero(~cont)
    if ends.size == 0 or ends[-1] != buf.shape[0] - 1:
        raise _err("varint stream truncated mid-value")
    starts = np.empty(ends.shape[0], np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    maxlen = int(lens.max())
    if maxlen > _VARINT_MAX_LEN:
        raise _err(f"overlong varint ({maxlen} bytes > {_VARINT_MAX_LEN})")
    long10 = lens == _VARINT_MAX_LEN
    if long10.any() and (buf[starts[long10] + 9] > 1).any():
        raise _err("varint overflows uint64")
    if ((lens > 1) & (buf[ends] == 0)).any():
        raise _err("overlong varint (redundant zero terminal byte)")
    vals = np.zeros(ends.shape[0], np.uint64)
    for k in range(maxlen):
        sel = lens > k
        vals[sel] |= ((buf[starts[sel] + k] & np.uint64(0x7F)).astype(np.uint64)
                      << np.uint64(7 * k))
    return vals


# --------------------------------------------------------- key <-> row pack

def max_packable_width() -> int:
    return _MAX_KEY_WIDTH


def rows_to_u64(rows: np.ndarray) -> np.ndarray:
    """(n, w≤2) uint32 rows → (n,) uint64 keys; numeric key order ==
    lexicographic row order (== the store's big-endian byte-key order)."""
    rows = np.ascontiguousarray(rows, np.uint32)
    w = rows.shape[1]
    if w == 1:
        return rows[:, 0].astype(np.uint64)
    if w == 2:
        return ((rows[:, 0].astype(np.uint64) << np.uint64(32))
                | rows[:, 1].astype(np.uint64))
    raise _err(f"keys codec packs width <= {_MAX_KEY_WIDTH}, got {w}")


def u64_to_rows(keys: np.ndarray, width: int) -> np.ndarray:
    if width == 1:
        return keys.astype(np.uint32).reshape(-1, 1)
    if width == 2:
        return np.stack(
            [(keys >> np.uint64(32)).astype(np.uint32),
             (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)
    raise _err(f"keys codec packs width <= {_MAX_KEY_WIDTH}, got {width}")


# ------------------------------------------------------------- keys codec

_KEYS_HDR = struct.Struct("<BIII")       # width, n_rows, n_blocks, block_rows
_SKIP_ENT = struct.Struct("<QQQI")       # first_key, last_key, offset, n_rows


def encode_keys(rows: np.ndarray, tag: str = "codec",
                block_rows: int = BLOCK_ROWS) -> bytes:
    """Compress one sorted chunk of (n, w≤2) uint32 rows.

    Layout: MAGIC, codec id, header, skip index, per-block varint
    payload (absolute first key + deltas), crc32 trailer.  Raises
    CodecError if the rows are not non-decreasing — compression never
    silently reorders.
    """
    rows = np.ascontiguousarray(rows, np.uint32).reshape(-1, rows.shape[-1])
    keys = rows_to_u64(rows)
    n = keys.shape[0]
    if n > 1 and (keys[1:] < keys[:-1]).any():
        raise _err("encode_keys: rows are not sorted (delta would wrap)")
    nblocks = -(-n // block_rows) if n else 0
    index: List[bytes] = []
    payload: List[bytes] = []
    off = 0
    for b in range(nblocks):
        blk = keys[b * block_rows:(b + 1) * block_rows]
        deltas = blk.copy()
        deltas[1:] = blk[1:] - blk[:-1]
        enc = _varint_encode(deltas)
        index.append(_SKIP_ENT.pack(int(blk[0]), int(blk[-1]), off,
                                    blk.shape[0]))
        payload.append(enc)
        off += len(enc)
    body = (MAGIC + bytes([CODEC_KEYS])
            + _KEYS_HDR.pack(rows.shape[1], n, nblocks, block_rows)
            + b"".join(index) + b"".join(payload))
    out = body + struct.pack("<I", zlib.crc32(body))
    book(tag, rows.nbytes, len(out))
    return out


def _check_container(buf: bytes, want_codec: int) -> memoryview:
    """Common magic/codec/crc validation; returns the view after the id
    byte (header onward)."""
    if len(buf) < len(MAGIC) + 1 + 4:
        raise _err("compressed chunk truncated (shorter than any header)")
    if bytes(buf[:4]) != MAGIC:
        raise _err(f"bad magic {bytes(buf[:4])!r} (not a compressed chunk)")
    if buf[4] != want_codec:
        raise _err(f"codec id {buf[4]} != expected {want_codec}")
    (crc,) = struct.unpack("<I", buf[-4:])
    if zlib.crc32(memoryview(buf)[:-4]) != crc:
        raise _err("crc32 mismatch: compressed chunk corrupt")
    return memoryview(buf)[5:-4]


class CompressedKeyReader:
    """Skip-indexed view over one ``keys``-codec chunk.

    Decodes blocks lazily and caches them, so a probe whose query window
    touches a fraction of the chunk pays a fraction of the decode —
    the compressed analogue of manifest-range chunk pruning, one level
    finer.  ``keys_between`` returns the (sorted, contiguous) keys of
    every block intersecting ``[lo, hi]``; membership searchsorted over
    that span is exact for any query inside the window.
    """

    def __init__(self, buf: bytes, tag: str = "codec"):
        body = _check_container(buf, CODEC_KEYS)
        self._tag = tag
        self.width, self.n_rows, self.n_blocks, self.block_rows = \
            _KEYS_HDR.unpack_from(body, 0)
        isz = self.n_blocks * _SKIP_ENT.size
        if len(body) < _KEYS_HDR.size + isz:
            raise _err("skip index truncated")
        self.first = np.empty(self.n_blocks, np.uint64)
        self.last = np.empty(self.n_blocks, np.uint64)
        self._offs = np.empty(self.n_blocks + 1, np.int64)
        self._rows = np.empty(self.n_blocks, np.int64)
        for b in range(self.n_blocks):
            fk, lk, off, nr = _SKIP_ENT.unpack_from(
                body, _KEYS_HDR.size + b * _SKIP_ENT.size)
            self.first[b], self.last[b], self._offs[b], self._rows[b] = \
                fk, lk, off, nr
        self._payload = np.frombuffer(
            body, np.uint8, offset=_KEYS_HDR.size + isz)
        self._offs[-1] = self._payload.shape[0]
        if int(self._rows.sum()) != self.n_rows or (self._rows <= 0).any():
            raise _err("skip index row counts disagree with header")
        if self.n_blocks and ((self.first[1:] < self.last[:-1]).any()
                              or (self.last < self.first).any()):
            raise _err("skip index not sorted")
        self._cache: Dict[int, np.ndarray] = {}

    def _decode_block(self, b: int) -> np.ndarray:
        blk = self._cache.get(b)
        if blk is not None:
            return blk
        lo, hi = int(self._offs[b]), int(self._offs[b + 1])
        if hi > self._payload.shape[0] or lo > hi:
            raise _err("block payload truncated")
        deltas = _varint_decode(self._payload[lo:hi])
        if deltas.shape[0] != self._rows[b]:
            raise _err(f"block {b}: {deltas.shape[0]} values, "
                       f"skip index says {self._rows[b]}")
        keys = np.cumsum(deltas, dtype=np.uint64)
        if keys[0] != self.first[b] or keys[-1] != self.last[b]:
            raise _err(f"block {b}: decoded ends disagree with skip index")
        self._cache[b] = keys
        obs.add(STATS, "blocks_decoded", 1)
        book(self._tag, keys.nbytes // 2 * self.width, hi - lo, read=True)
        return keys

    def block_span(self, lo: int, hi: int) -> Tuple[int, int]:
        """[b0, b1) of blocks whose key range intersects [lo, hi] —
        binary search over the skip index, no payload touched."""
        b0 = int(np.searchsorted(self.last, np.uint64(lo), side="left"))
        b1 = int(np.searchsorted(self.first, np.uint64(hi), side="right"))
        return b0, max(b0, b1)

    def keys_between(self, lo: int, hi: int) -> np.ndarray:
        b0, b1 = self.block_span(lo, hi)
        obs.add(STATS, "blocks_skipped", self.n_blocks - (b1 - b0))
        parts = [self._decode_block(b) for b in range(b0, b1)]
        if not parts:
            return np.zeros(0, np.uint64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def all_keys(self) -> np.ndarray:
        parts = [self._decode_block(b) for b in range(self.n_blocks)]
        if not parts:
            return np.zeros(0, np.uint64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def all_rows(self) -> np.ndarray:
        return u64_to_rows(self.all_keys(), self.width)


def decode_keys(buf: bytes, tag: str = "codec") -> np.ndarray:
    """Full decode: compressed chunk → (n, w) uint32 rows."""
    return CompressedKeyReader(buf, tag=tag).all_rows()


# -------------------------------------------------------------- rle2 codec

_RLE_HDR = struct.Struct("<QI")          # n_bytes, n_runs


def encode_rle2(packed: np.ndarray, tag: str = "codec") -> bytes:
    """RLE a packed 2-bit chunk (uint8 bytes, 4 elements each).

    Columnar layout — run values as raw bytes, run lengths as one varint
    stream — so decode is a single np.repeat.  Long UNSEEN/DONE
    stretches (0x00 / 0xFF) collapse to a few bytes each.
    """
    packed = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    n = packed.shape[0]
    if n == 0:
        starts = np.zeros(0, np.int64)
    else:
        starts = np.flatnonzero(np.concatenate(
            [[True], packed[1:] != packed[:-1]]))
    lens = np.diff(np.concatenate([starts, [n]])).astype(np.uint64)
    body = (MAGIC + bytes([CODEC_RLE2])
            + _RLE_HDR.pack(n, starts.shape[0])
            + packed[starts].tobytes() + _varint_encode(lens))
    out = body + struct.pack("<I", zlib.crc32(body))
    book(tag, n, len(out))
    return out


def decode_rle2(buf: bytes, tag: str = "codec") -> np.ndarray:
    """Compressed 2-bit chunk → packed uint8 array, validated end to end."""
    body = _check_container(buf, CODEC_RLE2)
    n_bytes, n_runs = _RLE_HDR.unpack_from(body, 0)
    if len(body) < _RLE_HDR.size + n_runs:
        raise _err("rle2 values truncated")
    vals = np.frombuffer(body, np.uint8, count=n_runs,
                         offset=_RLE_HDR.size)
    lens = _varint_decode(np.frombuffer(
        body, np.uint8, offset=_RLE_HDR.size + n_runs))
    if lens.shape[0] != n_runs:
        raise _err(f"rle2: {lens.shape[0]} run lengths for {n_runs} runs")
    if n_runs and ((lens == 0).any() or (vals[1:] == vals[:-1]).any()):
        raise _err("rle2: zero-length or unmerged runs (non-canonical)")
    if int(lens.sum()) != n_bytes:
        raise _err("rle2: run lengths do not sum to the declared size")
    out = np.repeat(vals, lens.astype(np.int64))
    book(tag, n_bytes, len(buf), read=True)
    return out


# ----------------------------------------------------------------- sniffing

def sniff(buf: bytes) -> Optional[int]:
    """Codec id of a compressed chunk, or None for anything else (e.g. a
    raw ``.npy``).  Only looks at the magic — validation happens on
    decode."""
    if len(buf) >= 5 and bytes(buf[:4]) == MAGIC:
        return buf[4]
    return None


# ------------------------------------------------------------- wire framing

def wire_encode(payload: bytes, tag: str = "transport") -> bytes:
    """zlib-frame one transport bucket payload (order-preserving: bucket
    bytes are ordered op logs, so the wire codec never re-sorts)."""
    out = WIRE_MAGIC + zlib.compress(payload, 6)
    book(tag, len(payload), len(out))
    return out


def wire_decode(buf: bytes, tag: str = "transport") -> bytes:
    """Inverse of :func:`wire_encode`; plain payloads pass through, so a
    compressing sender interoperates with an agnostic receiver."""
    if buf[:4] != WIRE_MAGIC:
        return buf
    try:
        payload = zlib.decompress(bytes(buf[4:]))
    except zlib.error as e:
        raise _err(f"wire payload corrupt: {e}") from None
    book(tag, len(payload), len(buf), read=True)
    return payload
