"""Port parity: the bucket files of Tier D's sharded runtime,
``repro_torch.core.disk.buckets`` against ``repro.core.disk.buckets``.

Tolerance: none.  The same ``put`` / ``seal`` sequence goes through the
reference's ``BucketWriter`` and the port's, each in its own directory:
the sealed files are the same names and bytes, and the dropped counts,
the ``transport`` counters and what ``iter_incoming`` yields are equal.
Epochs stay apart, overflow past a bucket's capacity drops exactly (a
capacity of 0 drops everything; the capacity resets each epoch), and an
unsealed ``.tmp`` is invisible and swept, as in the reference.
"""
import os

import numpy as np
import pytest

from repro.core.disk import buckets as JB
from repro.core.disk import extsort as jx
from repro_torch.core.disk import buckets as TB
from repro_torch.core.disk import extsort as tx

PKGS = {"ref": (JB, jx), "port": (TB, tx)}


def files(path):
    out = {}
    for root, _, names in os.walk(path):
        for fn in names:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def drive(B, root, seed, nshards, width, dtype, capacity, buf_rows):
    """A random put/seal sequence over three epochs and two sources;
    returns the dropped counts of every seal."""
    rng = np.random.default_rng(seed)
    ws = [B.BucketWriter(root, src=s, nshards=nshards, width=width,
                         dtype=dtype, capacity=capacity, buf_rows=buf_rows)
          for s in range(2)]
    drops = []
    for epoch in range(3):
        for _ in range(4):
            for w in ws:
                m = int(rng.integers(0, 20))
                dest = rng.integers(0, nshards, m)
                rows = rng.integers(0, 1 << 30, (m, width))
                w.put(dest, rows.astype(dtype))
        for w in ws:
            drops.append(w.seal(epoch=epoch,
                                publish_done=epoch == 1).tolist())
    return drops


@pytest.mark.parametrize("case", [
    (0, 3, 2, "int64", None, 1 << 15),
    (1, 4, 1, "uint32", 5, 4),
    (2, 2, 3, "int64", 0, 7),
    (3, 1, 2, "int64", 3, 1),
])
def test_bucket_files_are_the_references(tmp_path, case):
    seed, nshards, width, dtype, capacity, buf_rows = case
    got = {}
    for key, (B, _) in PKGS.items():
        before = dict(B.TRANSPORT_STATS)
        drops = drive(B, str(tmp_path / key), seed, nshards, width, dtype,
                      capacity, buf_rows)
        stats = {k: B.TRANSPORT_STATS[k] - before[k]
                 for k in B.TRANSPORT_STATS}
        got[key] = (drops, stats, files(tmp_path / key))
    assert got["ref"] == got["port"]
    assert any(".done" in f for f in got["port"][2])
    # what each reader yields from the other's files
    for dst in range(nshards):
        for epoch in range(3):
            a = [(s, r.tolist()) for s, r in TB.iter_incoming(
                str(tmp_path / "ref"), dst, epoch, width, dtype)]
            b = [(s, r.tolist()) for s, r in JB.iter_incoming(
                str(tmp_path / "port"), dst, epoch, width, dtype)]
            assert a == b
    assert not any(f.endswith(".bin") for f in files(tmp_path / "ref"))


def test_owner_maps_are_the_references():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 1 << 32, (500, 3), dtype=np.uint64).astype(
        np.uint32)
    idx = rng.integers(0, 10_007, 500)
    for ns in (1, 2, 3, 4, 8):
        assert np.array_equal(TB.hash_owner_np(rows, ns),
                              JB.hash_owner_np(rows, ns))
        assert np.array_equal(TB.block_owner_np(idx, 10_007, ns),
                              JB.block_owner_np(idx, 10_007, ns))
        assert TB.block_owner(idx, 10_007, ns).tolist() == \
            JB.block_owner_np(idx, 10_007, ns).tolist()
        assert TB.block_size(10_007, ns) == JB.block_size(10_007, ns)
    assert TB._bucket_name(3, 1, 2) == JB._bucket_name(3, 1, 2)
    assert TB._done_name(3, 1, 2) == JB._done_name(3, 1, 2)


@pytest.mark.parametrize("pkg", PKGS)
def test_roundtrip_source_order_and_epochs(tmp_path, pkg):
    B, _ = PKGS[pkg]
    wd = str(tmp_path)
    w0 = B.BucketWriter(wd, src=0, nshards=2, width=2)
    w1 = B.BucketWriter(wd, src=1, nshards=2, width=2)
    w1.put([0, 0], np.array([[10, 11], [12, 13]], np.int64))
    w0.put([0, 1], np.array([[1, 2], [3, 4]], np.int64))
    assert w0.seal(epoch=5).sum() == 0
    assert w1.seal(epoch=5).sum() == 0
    w1.put([0], np.array([[7, 7]], np.int64))
    w1.seal(epoch=6)
    got = list(B.iter_incoming(wd, dst=0, epoch=5, width=2))
    assert [src for src, _ in got] == [0, 1]          # ascending src
    assert got[1][1].tolist() == [[10, 11], [12, 13]]
    assert list(B.iter_incoming(wd, dst=0, epoch=5, width=2)) == []
    (src, rows), = B.iter_incoming(wd, dst=1, epoch=5, width=2)
    assert src == 0 and rows.tolist() == [[3, 4]]
    (src, rows), = B.iter_incoming(wd, dst=0, epoch=6, width=2)
    assert src == 1 and rows.tolist() == [[7, 7]]


@pytest.mark.parametrize("pkg", PKGS)
def test_overflow_drops_exactly(tmp_path, pkg):
    B, _ = PKGS[pkg]
    rng = np.random.default_rng(2)
    for case in range(8):
        ns = int(rng.integers(1, 5))
        cap = int(rng.integers(0, 6))
        m = int(rng.integers(1, 50))
        dest = rng.integers(0, ns, m)
        root = str(tmp_path / f"c{case}")
        w = B.BucketWriter(root, src=0, nshards=ns, width=1, capacity=cap,
                           buf_rows=4)
        for lo in range(0, m, 7):
            sl = dest[lo:lo + 7]
            w.put(sl, np.arange(lo, lo + sl.shape[0], dtype=np.int64
                                ).reshape(-1, 1))
        dropped = w.seal(epoch=0)
        want = [max(0, int(np.sum(dest == d)) - cap) for d in range(ns)]
        assert dropped.tolist() == want
        kept = sum(r.shape[0] for d in range(ns)
                   for _s, r in B.iter_incoming(root, d, 0, 1))
        assert kept + sum(want) == m


@pytest.mark.parametrize("pkg", PKGS)
def test_zero_capacity_and_reset_per_epoch(tmp_path, pkg):
    B, _ = PKGS[pkg]
    w = B.BucketWriter(str(tmp_path / "a"), src=0, nshards=2, width=1,
                       capacity=0)
    w.put([0, 1, 1], np.zeros((3, 1), np.int64))
    assert w.seal(epoch=0).tolist() == [1, 2]
    assert list(B.iter_incoming(str(tmp_path / "a"), 0, 0, 1)) == []
    w = B.BucketWriter(str(tmp_path / "b"), src=0, nshards=1, width=1,
                       capacity=2)
    w.put([0, 0, 0], np.zeros((3, 1), np.int64))
    assert w.seal(epoch=0).tolist() == [1]
    w.put([0, 0], np.zeros((2, 1), np.int64))
    assert w.seal(epoch=1).tolist() == [0]


@pytest.mark.parametrize("pkg", PKGS)
def test_unsealed_tmp_is_invisible_and_swept(tmp_path, pkg):
    B, x = PKGS[pkg]
    wd = str(tmp_path)
    x.reset_stats()
    w = B.BucketWriter(wd, src=0, nshards=1, width=1, buf_rows=1)
    w.put([0], [[1]])                       # buf_rows=1: spilled to .tmp
    assert any(f.endswith(".tmp") for f in os.listdir(wd))
    assert list(B.iter_incoming(wd, 0, 0, 1)) == []
    w2 = B.BucketWriter(wd, src=1, nshards=1, width=1)
    w2.put([0], [[2]])
    w2.seal(epoch=0)
    open(os.path.join(wd, "log000000.bin.pass"), "wb").write(b"\0" * 16)
    removed = B.cleanup_strays(wd)
    assert sorted(os.path.basename(p) for p in removed) == [
        "log000000.bin.pass", "s000_d000.bin.tmp"]
    assert x.STATS["stray_files_swept"] == 2
    assert x.STATS["stray_bytes_swept"] == 8 + 16
    (src, rows), = B.iter_incoming(wd, 0, 0, 1)
    assert src == 1 and rows.tolist() == [[2]]
    assert B.cleanup_strays(str(tmp_path / "absent")) == []
