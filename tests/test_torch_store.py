"""Port parity: Tier D's chunked row store, ``repro_torch.core.disk.store``
against ``repro.core.disk.store``.

Tolerance: none — the store moves bytes.  The same appends, flushes and
claims through both packages must leave the same files: every chunk file
(``.npy`` through ``np.save``, or ``.rmz`` through the ``keys`` codec) and
``meta.json``, byte for byte.  The two are compared in one process, since
``np.save``'s header depends on the numpy that writes it.  Each package
reopens the other's store and reads the same rows, key ranges and flags;
both refuse the same bad claims.  Rows come from ``np.random.default_rng``.
"""
import errno
import json
import os

import numpy as np
import pytest

from repro.core.disk import codec as jcodec
from repro.core.disk import faults as jfaults
from repro.core.disk import store as jstore
from repro_torch.core.disk import codec as tcodec
from repro_torch.core.disk import faults as tfaults
from repro_torch.core.disk import store as tstore

PKGS = {"ref": jstore, "port": tstore}


def _files(path):
    return {fn: open(os.path.join(path, fn), "rb").read()
            for fn in sorted(os.listdir(path))}


def _sorted_rows(rng, n, width, hi=1 << 32):
    rows = rng.integers(0, hi, (n, width), dtype=np.uint64).astype(np.uint32)
    return rows[np.lexsort(rows.T[::-1])]


def _drive(mod, path, rows, width, codec, chunk_rows, pieces, claim):
    """The same calls through one package: appends in ``pieces``, a flush
    (claiming the sortedness invariant if ``claim``)."""
    st = mod.ChunkStore(path, width=width, chunk_rows=chunk_rows, fresh=True,
                        codec=codec)
    for part in np.array_split(rows, pieces):
        st.append(part)
    st.flush(mark_sorted=claim)
    return st


CASES = [  # n rows, width, codec, chunk rows, pieces, sorted claim
    (1000, 1, None, 128, 7, True),
    (1000, 2, None, 300, 3, True),
    (777, 3, None, 100, 5, True),
    (5000, 1, "keys", 1024, 4, True),
    (5000, 2, "keys", 4096 + 17, 2, True),
    (300, 3, "keys", 64, 2, True),            # no uint64 packing: raw
    (999, 2, None, 250, 9, False),
    (0, 2, None, 64, 1, False),
    (512, 1, None, 128, 1, False),            # an exact chunk multiple
]


@pytest.mark.parametrize("case", CASES)
def test_files_are_byte_identical(tmp_path, case):
    n, width, codec, chunk, pieces, claim = case
    rng = np.random.default_rng(n + width)
    rows = (_sorted_rows(rng, n, width) if claim else
            rng.integers(0, 1 << 32, (n, width), dtype=np.uint64).astype(
                np.uint32))
    stores = {k: _drive(m, str(tmp_path / k), rows, width, codec, chunk,
                        pieces, claim) for k, m in PKGS.items()}
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(got) == sorted(want)
    for fn in want:
        assert got[fn] == want[fn], fn
    assert "meta.json" in got
    meta = json.loads(got["meta.json"])
    assert meta["n_chunks"] == -(-n // chunk) and meta["total_rows"] == n
    assert meta["sorted"] == claim
    ref, port = stores["ref"], stores["port"]
    assert port.codec == ref.codec == (codec if width <= 2 else None)
    np.testing.assert_array_equal(port.read_all(), rows)
    for i in range(port.n_chunks):
        assert port.chunk_range(i) == ref.chunk_range(i)
        np.testing.assert_array_equal(np.asarray(port.load_chunk(i)),
                                      np.asarray(ref.load_chunk(i)))


@pytest.mark.parametrize("codec", [None, "keys"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_reopens_the_others_store(tmp_path, writer, codec):
    rows = _sorted_rows(np.random.default_rng(3), 3000, 2)
    _drive(PKGS[writer], str(tmp_path / "s"), rows, 2, codec, 512, 5, True)
    reader = PKGS["port" if writer == "ref" else "ref"]
    st = reader.ChunkStore(str(tmp_path / "s"), width=2)
    assert (st.n_chunks, st.total_rows, st.sorted, st.codec) == (
        6, 3000, True, codec)
    np.testing.assert_array_equal(st.read_all(), rows)
    kr = st.key_reader(2)
    if codec is None:
        assert kr is None
    else:
        np.testing.assert_array_equal(kr.all_rows(), rows[1024:1536])
    # appending clears the claim, and the reopened store keeps writing
    st.append(rows[:10])
    assert not st.sorted
    st.flush()
    again = PKGS[writer].ChunkStore(str(tmp_path / "s"), width=2)
    assert again.n_chunks == 7 and not again.sorted
    np.testing.assert_array_equal(again.load_chunk(6), rows[:10])


def test_mark_sorted_refuses_the_same_boundaries(tmp_path):
    """A chunk that starts below the previous chunk's max: both refuse the
    claim at flush and at ``mark_sorted``; chunks that only touch at a
    boundary (equal rows) are sorted for both."""
    rng = np.random.default_rng(4)
    a, b = _sorted_rows(rng, 100, 2), _sorted_rows(rng, 100, 2)
    bad = np.concatenate([a, b])              # two sorted runs, not one
    touching = np.concatenate([a, np.repeat(a[-1:], 100, axis=0)])
    for k, m in PKGS.items():
        with pytest.raises(ValueError, match="chunk 1 starts below"):
            _drive(m, str(tmp_path / f"{k}1"), bad, 2, None, 100, 1, True)
        st = _drive(m, str(tmp_path / f"{k}2"), bad, 2, None, 100, 1, False)
        with pytest.raises(ValueError, match="chunk 1 starts below"):
            st.mark_sorted()
        st = _drive(m, str(tmp_path / f"{k}3"), touching, 2, None, 100, 1,
                    False)
        st.mark_sorted()
        assert m.ChunkStore(str(tmp_path / f"{k}3"), width=2).sorted
        st.append(a[:3])                      # buffered, not flushed
        with pytest.raises(AssertionError, match="flush"):
            st.mark_sorted()
    for i in (2, 3):
        assert _files(tmp_path / f"port{i}") == _files(tmp_path / f"ref{i}")


def test_keys_codec_refuses_unsorted_chunks(tmp_path):
    rows = np.random.default_rng(5).integers(0, 100, (50, 1)).astype(
        np.uint32)
    for k, m in PKGS.items():
        with pytest.raises((jcodec.CodecError, tcodec.CodecError),
                           match="not sorted"):
            _drive(m, str(tmp_path / k), rows, 1, "keys", 64, 1, False)


def test_unknown_manifest_codec_and_width_are_refused(tmp_path):
    rows = _sorted_rows(np.random.default_rng(6), 10, 1)
    path = str(tmp_path / "s")
    _drive(tstore, path, rows, 1, None, 8, 1, True)
    meta = json.load(open(os.path.join(path, "meta.json")))
    with pytest.raises(AssertionError, match="width"):
        tstore.ChunkStore(path, width=2)
    json.dump({**meta, "codec": "zstd"}, open(os.path.join(path, "meta.json"),
                                              "w"))
    with pytest.raises(tcodec.CodecError, match="zstd"):
        tstore.ChunkStore(path, width=1)
    with pytest.raises(jcodec.CodecError, match="zstd"):
        jstore.ChunkStore(path, width=1)


def test_export_to_copies_the_flushed_store(tmp_path):
    """An exact chunk multiple flushes its chunks on append with no
    manifest write; ``export_to`` writes it first, in both packages, and
    copies the same bytes."""
    rows = _sorted_rows(np.random.default_rng(7), 256, 1)
    out = {}
    for k, m in PKGS.items():
        st = m.ChunkStore(str(tmp_path / k), width=1, chunk_rows=64,
                          fresh=True)
        st.append(rows)
        assert st.n_chunks == 4 and st._meta_dirty
        out[k] = st.export_to(str(tmp_path / f"{k}_copy"))
        assert not st._meta_dirty
    assert out["port"] == out["ref"] > 4 * 64 * 4
    assert _files(tmp_path / "port_copy") == _files(tmp_path / "ref_copy")
    assert _files(tmp_path / "port_copy") == _files(tmp_path / "port")


@pytest.mark.parametrize("width", [1, 2, 3])
def test_row_keys_and_extreme_keys_match(width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, 4, (200, width)).astype(np.uint32)   # many ties
    np.testing.assert_array_equal(tstore.row_keys(rows),
                                  jstore.row_keys(rows))
    for mode in ("min", "max"):
        assert tstore._lex_extreme_key(rows, mode) == \
            jstore._lex_extreme_key(rows, mode)
    keys = tstore.row_keys(rows).tolist()
    assert tstore._lex_extreme_key(rows, "min") == min(keys)
    assert tstore._lex_extreme_key(rows, "max") == max(keys)


def test_unkeyed_dtypes_carry_no_ranges(tmp_path):
    rows = np.arange(40, dtype=np.int64).reshape(-1, 2)
    for k, m in PKGS.items():
        st = m.ChunkStore(str(tmp_path / k), width=2, dtype="int64",
                          chunk_rows=8, fresh=True)
        st.append(rows)
        st.flush(mark_sorted=True)
        assert st.chunk_range(0) is None
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("codec", [None, "keys"])
def test_fault_sites_retry_to_the_same_bytes(tmp_path, codec):
    """A transient burst at ``chunk_flush`` and at ``meta_write`` is retried
    to the bytes of a run with no faults, with the same retries booked in
    both packages; a fatal fault raises ``OSError`` and is booked as a
    give-up."""
    rows = _sorted_rows(np.random.default_rng(8), 700, 2)
    spec = ("seed=3;chunk_flush:transient:every=2:times=2:once=0;"
            "meta_write:transient:at=1:times=3")
    counts = {}
    for k, m, f in (("ref", jstore, jfaults), ("port", tstore, tfaults)):
        stats = (jfaults._stats() if f is jfaults else f.STATS)
        before = dict(stats)
        f.install(f.parse(spec).bind())
        try:
            _drive(m, str(tmp_path / k), rows, 2, codec, 100, 3, True)
        finally:
            f.uninstall()
        counts[k] = {n: stats[n] - before[n]
                     for n in ("io_retries", "io_giveups")}
        _drive(m, str(tmp_path / f"{k}_clean"), rows, 2, codec, 100, 3, True)
        assert _files(tmp_path / k) == _files(tmp_path / f"{k}_clean")
    assert counts["port"] == counts["ref"]
    # chunks 2-7 fail at an even hit and once more in the burst; the
    # manifest three times
    assert counts["port"] == {"io_retries": 2 * 6 + 3, "io_giveups": 0}
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    for k, m, f in (("ref", jstore, jfaults), ("port", tstore, tfaults)):
        f.install(f.parse("chunk_flush:fatal:at=2").bind())
        try:
            with pytest.raises(OSError) as e:
                _drive(m, str(tmp_path / f"{k}_fatal"), rows, 2, codec, 100,
                       1, False)
            assert e.value.errno == errno.ENOSPC
        finally:
            f.uninstall()
        assert sorted(os.listdir(tmp_path / f"{k}_fatal")) == [
            "c000000." + ("rmz" if codec else "npy")]
