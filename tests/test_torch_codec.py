"""Port parity: the rle2 chunk codec of ``repro_torch.core.disk.codec``
against ``repro.core.disk.codec``.

Tolerance: none — the codec moves bytes.  The port's encoder must give the
reference's bytes, each decoder must decode the other's output, and every
malformed input that makes the reference raise ``CodecError`` (the rle2
and varint cases of ``tests/test_codec.py``) must make the port raise its
own ``CodecError`` too.  Inputs come from ``np.random.default_rng``.
"""
import struct
import zlib

import numpy as np
import pytest

from repro.core.disk import codec as jcodec
from repro_torch.core.disk import codec as tcodec

PACKED = [
    np.zeros(0, np.uint8),
    np.zeros(1, np.uint8),
    np.full(10_000, 0xFF, np.uint8),
    np.arange(256, dtype=np.uint8),
    np.repeat(np.array([0, 0xFF, 0, 0x55], np.uint8), [5000, 3, 1, 900]),
    np.random.default_rng(0).integers(0, 4, 3000).astype(np.uint8),
    np.random.default_rng(1).integers(0, 256, 777).astype(np.uint8),
]


def _container(body_after_id: bytes, codec_id=tcodec.CODEC_RLE2) -> bytes:
    """A well-formed container (magic, id, crc) around any body, so that
    the checks past the crc are reached."""
    body = tcodec.MAGIC + bytes([codec_id]) + body_after_id
    return body + struct.pack("<I", zlib.crc32(body))


@pytest.mark.parametrize("i", range(len(PACKED)))
def test_encode_gives_the_reference_bytes(i):
    packed = PACKED[i]
    assert tcodec.encode_rle2(packed) == jcodec.encode_rle2(packed)


@pytest.mark.parametrize("i", range(len(PACKED)))
def test_each_decodes_the_other(i):
    packed = PACKED[i]
    got = tcodec.decode_rle2(jcodec.encode_rle2(packed))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, packed)
    np.testing.assert_array_equal(
        jcodec.decode_rle2(tcodec.encode_rle2(packed)), packed)


def test_varints_match_the_reference():
    rng = np.random.default_rng(2)
    vals = np.concatenate([
        rng.integers(0, 1 << 63, 500, dtype=np.uint64),
        np.asarray([0, 1, 127, 128, 16383, 16384, (1 << 64) - 1,
                    1 << 63], np.uint64)])
    enc = tcodec._varint_encode(vals)
    assert enc == jcodec._varint_encode(vals)
    np.testing.assert_array_equal(
        tcodec._varint_decode(np.frombuffer(enc, np.uint8)), vals)
    assert tcodec._varint_encode(np.zeros(0, np.uint64)) == b""
    assert tcodec._varint_decode(np.zeros(0, np.uint8)).shape == (0,)


def test_the_ledger_books_as_the_reference():
    packed = PACKED[4]
    tcodec.reset_stats()
    jcodec.reset_stats()
    for mod in (tcodec, jcodec):
        buf = mod.encode_rle2(packed, tag="oracle")
        mod.decode_rle2(buf, tag="oracle")
    keys = ("oracle_raw_bytes", "oracle_stored_bytes",
            "oracle_raw_bytes_read", "oracle_stored_bytes_read")
    assert [tcodec.STATS[k] for k in keys] == [jcodec.STATS[k] for k in keys]
    assert tcodec.STATS["oracle_raw_bytes"] == packed.size


# ------------------------------------------------------- malformed input

VARINT_CASES = [  # tests/test_codec.py:178-196
    (np.array([0x80] * 11 + [0x01], np.uint8), "[Oo]verlong"),
    (np.array([0x80, 0x00], np.uint8), "overlong"),
    (np.array([0xFF] * 9 + [0x02], np.uint8), "overflow"),
    (np.array([0x80], np.uint8), "truncated"),
]


@pytest.mark.parametrize("stream,match", VARINT_CASES)
def test_bad_varints_raise_in_both(stream, match):
    with pytest.raises(jcodec.CodecError, match=match) as want:
        jcodec._varint_decode(stream)
    before = tcodec.STATS["codec_errors"]
    with pytest.raises(tcodec.CodecError, match=match) as got:
        tcodec._varint_decode(stream)
    assert str(got.value) == str(want.value)
    assert tcodec.STATS["codec_errors"] == before + 1


def _bad_rle2_buffers():
    """(name, buffer) pairs that every rle2 decoder must refuse."""
    good = jcodec.encode_rle2(np.full(4096, 0xFF, np.uint8))
    flip = bytearray(good)
    flip[len(flip) // 2] ^= 0x04                      # test_rle2_bit_flip
    keys = jcodec.encode_keys(np.arange(16, dtype=np.uint32).reshape(-1, 1))
    hdr = struct.Struct("<QI")
    out = [("bit flip", bytes(flip)),
           ("wrong codec id", keys),                  # test_wrong_codec_id
           ("bad magic", b"XXXX" + good[4:]),
           ("shorter than a header", good[:8])]
    out += [(f"cut at {c}", good[:c]) for c in (3, 8, len(good) // 2,
                                                len(good) - 1)]
    # past the crc: each structural refusal of decode_rle2
    out += [
        ("values truncated", _container(hdr.pack(10, 5) + b"\x01\x02")),
        ("run count", _container(hdr.pack(4, 2) + b"\x01\x02" + b"\x04")),
        ("zero-length run", _container(hdr.pack(4, 2) + b"\x01\x02"
                                       + b"\x00\x04")),
        ("unmerged runs", _container(hdr.pack(4, 2) + b"\x01\x01"
                                     + b"\x02\x02")),
        ("sizes disagree", _container(hdr.pack(9, 1) + b"\x01" + b"\x04")),
        ("truncated varint", _container(hdr.pack(4, 1) + b"\x01" + b"\x84")),
    ]
    return out


@pytest.mark.parametrize("name,buf", _bad_rle2_buffers(),
                         ids=[n for n, _ in _bad_rle2_buffers()])
def test_malformed_rle2_raises_in_both(name, buf):
    """Each raises, and for the same reason (the same message)."""
    with pytest.raises(jcodec.CodecError) as want:
        jcodec.decode_rle2(buf)
    with pytest.raises(tcodec.CodecError) as got:
        tcodec.decode_rle2(buf)
    assert str(got.value) == str(want.value)


def test_garbage_never_decodes_silently():
    rng = np.random.default_rng(3)
    for size in (0, 1, 5, 9, 40, 300):
        blob = rng.integers(0, 256, size).astype(np.uint8).tobytes()
        for dec, err in ((jcodec.decode_rle2, jcodec.CodecError),
                         (tcodec.decode_rle2, tcodec.CodecError)):
            with pytest.raises(err):
                dec(blob)


# ------------------------------------------------ the keys codec and wire

KEY_ROWS = [  # (rows, block_rows)
    (np.zeros((0, 1), np.uint32), 4096),
    (np.zeros((1, 2), np.uint32), 4096),
    (np.sort(np.random.default_rng(3).integers(
        0, 1 << 32, (10_000, 1), dtype=np.uint64).astype(np.uint32), 0), 4096),
    (np.full((5000, 1), 7, np.uint32), 1000),           # equal keys: delta 0
    (np.random.default_rng(4).integers(0, 50, (3000, 2)).astype(np.uint32),
     333),
    (np.array([[0, 0], [0, 0xFFFFFFFF], [1, 0], [0xFFFFFFFF, 0xFFFFFFFF]],
              np.uint32), 2),
]


def _keys_case(i):
    rows, block = KEY_ROWS[i]
    if rows.shape[1] == 2:
        rows = rows[np.lexsort(rows.T[::-1])]
    return rows, block


@pytest.mark.parametrize("i", range(len(KEY_ROWS)))
def test_encode_keys_gives_the_reference_bytes(i):
    rows, block = _keys_case(i)
    got = tcodec.encode_keys(rows, block_rows=block)
    assert got == jcodec.encode_keys(rows, block_rows=block)
    assert tcodec.sniff(got) == jcodec.sniff(got) == tcodec.CODEC_KEYS
    np.testing.assert_array_equal(tcodec.decode_keys(
        jcodec.encode_keys(rows, block_rows=block)), rows)
    np.testing.assert_array_equal(jcodec.decode_keys(got), rows)


@pytest.mark.parametrize("i", [2, 4, 5])
def test_key_readers_skip_the_same_blocks(i):
    rows, block = _keys_case(i)
    buf = tcodec.encode_keys(rows, block_rows=block)
    mine, theirs = tcodec.CompressedKeyReader(buf), jcodec.CompressedKeyReader(
        buf)
    assert (mine.width, mine.n_rows, mine.n_blocks, mine.block_rows) == (
        theirs.width, theirs.n_rows, theirs.n_blocks, theirs.block_rows)
    np.testing.assert_array_equal(mine.first, theirs.first)
    np.testing.assert_array_equal(mine.last, theirs.last)
    keys = tcodec.rows_to_u64(rows)
    rng = np.random.default_rng(i)
    for lo, hi in [(0, 0), (int(keys[len(keys) // 3]),
                            int(keys[len(keys) // 2])),
                   (int(keys[-1]), (1 << 64) - 1)] + [
            tuple(sorted(rng.choice(keys, 2).tolist())) for _ in range(5)]:
        assert mine.block_span(lo, hi) == theirs.block_span(lo, hi)
        np.testing.assert_array_equal(mine.keys_between(lo, hi),
                                      theirs.keys_between(lo, hi))
    np.testing.assert_array_equal(mine.all_rows(), rows)


def test_row_packing_matches_the_reference():
    rng = np.random.default_rng(6)
    assert tcodec.max_packable_width() == jcodec.max_packable_width() == 2
    for w in (1, 2):
        rows = rng.integers(0, 1 << 32, (100, w), dtype=np.uint64).astype(
            np.uint32)
        keys = tcodec.rows_to_u64(rows)
        np.testing.assert_array_equal(keys, jcodec.rows_to_u64(rows))
        np.testing.assert_array_equal(tcodec.u64_to_rows(keys, w), rows)
    for mod in (tcodec, jcodec):
        with pytest.raises(mod.CodecError, match="width"):
            mod.rows_to_u64(np.zeros((2, 3), np.uint32))
        with pytest.raises(mod.CodecError, match="width"):
            mod.u64_to_rows(np.zeros(2, np.uint64), 3)


def _corrupt_keys():
    rows, _ = _keys_case(4)
    good = jcodec.encode_keys(rows, block_rows=333)
    flip = bytearray(good)
    flip[40] ^= 1
    body = jcodec.MAGIC + bytes([jcodec.CODEC_KEYS]) + struct.pack(
        "<BIII", 2, 5, 1, 4096) + struct.pack("<QQQI", 3, 1, 0, 5)
    return {
        "truncated": good[:-9],
        "bit flip": bytes(flip),
        "bad magic": b"XXXX" + good[4:],
        "rle2 id": good[:4] + bytes([jcodec.CODEC_RLE2]) + good[5:],
        "skip index unsorted": body + struct.pack("<I", zlib.crc32(body)),
        "too short": good[:6],
    }


@pytest.mark.parametrize("case", sorted(_corrupt_keys()))
def test_keys_decoders_refuse_the_same_corruptions(case):
    buf = _corrupt_keys()[case]
    with pytest.raises(jcodec.CodecError):
        jcodec.decode_keys(buf)
    with pytest.raises(tcodec.CodecError):
        tcodec.decode_keys(buf)


def test_encode_keys_refuses_unsorted_rows():
    rows = np.array([[3], [1]], np.uint32)
    for mod in (tcodec, jcodec):
        with pytest.raises(mod.CodecError, match="not sorted"):
            mod.encode_keys(rows)


@pytest.mark.parametrize("payload", [b"", b"x", bytes(range(256)) * 40,
                                     np.random.default_rng(8).bytes(5000)])
def test_wire_framing_matches_the_reference(payload):
    enc = tcodec.wire_encode(payload)
    assert enc == jcodec.wire_encode(payload)
    assert tcodec.wire_decode(jcodec.wire_encode(payload)) == payload
    assert jcodec.wire_decode(enc) == payload
    assert tcodec.wire_decode(payload[:0] + b"plain") == b"plain"
    assert tcodec.sniff(enc) is None and tcodec.sniff(b"RMZ") is None
    bad = enc[:4] + b"\x00" + enc[5:]
    if len(enc) > 5:
        for mod in (tcodec, jcodec):
            with pytest.raises(mod.CodecError, match="wire"):
                mod.wire_decode(bad)


def test_codec_counters_book_like_the_reference():
    rows, block = _keys_case(2)
    for mod in (tcodec, jcodec):
        mod.reset_stats()
        buf = mod.encode_keys(rows, tag="t", block_rows=block)
        r = mod.CompressedKeyReader(buf, tag="t")
        r.keys_between(0, int(tcodec.rows_to_u64(rows)[100]))
        mod.wire_decode(mod.wire_encode(b"abc" * 100))
    got = {k: v for k, v in tcodec.STATS.items() if v}
    want = {k: v for k, v in jcodec.STATS.items() if v}
    assert got == want
    assert got["blocks_decoded"] == 1 and got["blocks_skipped"] == 2
