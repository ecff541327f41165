"""The ``rle2`` chunk codec of the distance oracle's compressed artifacts
(the port's copy of the parts of ``repro/core/disk/codec.py`` it needs:
``:80-163``, ``:234-246`` and ``:341-384``).

A packed 2-bit chunk (uint8 bytes, 4 fields each) is dominated by long
runs of one byte, so it is stored as a container: ``MAGIC``, the codec id,
a header of (n_bytes, n_runs), the run values as raw bytes, the run
lengths as one LEB128 varint stream, and a crc32 of everything before it.
Corrupt data raises :class:`CodecError`: truncation, bit flips, overlong
or overflowing varints, non-canonical runs and wrong codec ids are all
refused, never decoded into wrong bytes.

This is host I/O, so it stays numpy.  Raw and stored byte counts book
into the ``codec`` counter namespace per caller tag
(``{tag}_raw_bytes`` / ``{tag}_stored_bytes`` on encode, ``*_read`` on
decode), as in the reference.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import obs

MAGIC = b"RMZ1"
CODEC_RLE2 = 2

_VARINT_MAX_LEN = 10          # ceil(64 / 7)

STATS = obs.counters("codec", {"codec_errors": 0})


class CodecError(Exception):
    """Compressed data failed validation (truncated, corrupt, overlong,
    unknown codec/version).  Loud by contract: decoders raise this and
    never return wrong data."""


def _err(msg: str) -> CodecError:
    STATS["codec_errors"] += 1
    return CodecError(msg)


def book(tag: str, raw: int, stored: int, read: bool = False) -> None:
    """Book one encode (or decode, ``read=True``) into the codec ledger."""
    sfx = "_read" if read else ""
    for key, n in ((f"{tag}_raw_bytes{sfx}", raw),
                   (f"{tag}_stored_bytes{sfx}", stored)):
        STATS[key] = STATS.get(key, 0) + int(n)


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
        byte = ((vals[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)
                ).astype(np.uint8)
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
        vals[sel] |= ((buf[starts[sel] + k] & np.uint64(0x7F))
                      .astype(np.uint64) << np.uint64(7 * k))
    return vals


# ------------------------------------------------------------- container

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
