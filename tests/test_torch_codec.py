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
