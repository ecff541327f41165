"""Port parity: Tier D's 2-bit array, ``repro_torch.core.disk.bitarray``
against ``repro.core.disk.bitarray``.

Tolerance: none.  The same seeded updates and passes go through both
packages, each in its own directory: every chunk file (``.npy`` or
``.rmz``), op log (``.bin`` / ``.pass``) and snapshot is the same bytes
after every pass, and the ``bits``, ``extsort`` and ``codec`` counters
are equal.  The port's passes run on the CPU here (``device="cpu"``:
the bit-pack kernels' plain versions): the generic route with torch
user functions, and the packed route (``mark=``; K1 fused, K2 + K3
unfused) against the reference's generic pass with the same semantics.
Chunks of 36 and 1000 fields are no multiple of 16, so a chunk's bytes
end inside a word.  Also: snapshot isolation and the re-adoption of an
aborted pass (``tests/test_passes.py:99-129``), snapshots across the two
packages, the fault sites, and the default device with no card.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.disk import bitarray as JB
from repro.core.disk import codec as jcodec
from repro.core.disk import extsort as jx
from repro.core.disk import faults as jfaults
from repro.core.disk import passes as jpasses
from repro_torch.core import bitarray as BA
from repro_torch.core.disk import bitarray as TB
from repro_torch.core.disk import codec as tcodec
from repro_torch.core.disk import extsort as tx
from repro_torch.core.disk import faults as tfaults
from repro_torch.core.disk import passes as tpasses

UNSEEN, CUR, NEXT, DONE = 0, 1, 2, 3
LAYOUTS = [(100, 36), (1000, 1000), (2500, 1000), (64, 16), (777, 64)]


def files(path):
    out = {}
    for root, _, names in os.walk(path):
        for fn in names:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def reset():
    for m in (JB, jx, jcodec, TB, tx, tcodec):
        m.reset_stats()


def counters():
    """(reference, port): the bits, extsort and codec counters that are
    not 0 (other modules of a package may register more keys in a
    namespace)."""
    def nonzero(*mods):
        return tuple({k: v for k, v in m.STATS.items() if v} for m in mods)
    return nonzero(JB, jx, jcodec), nonzero(TB, tx, tcodec)


class Pair:
    """One array of each package over the same layout, in sibling dirs."""

    def __init__(self, tmp_path, n, ce, **kw):
        self.j = JB.DiskBitArray(str(tmp_path / "ref"), n, chunk_elems=ce,
                                 name="a", **kw)
        self.t = TB.DiskBitArray(str(tmp_path / "port"), n, chunk_elems=ce,
                                 name="a", device="cpu", **kw)

    def update(self, idx, vals):
        self.j.update(np.asarray(idx), np.asarray(vals))
        self.t.update(torch.as_tensor(np.asarray(idx)),
                      torch.as_tensor(np.asarray(vals)))

    def same(self):
        fj, ft = files(self.j.path), files(self.t.path)
        assert sorted(fj) == sorted(ft)
        for k in fj:
            assert fj[k] == ft[k], k
        assert np.array_equal(self.t.read_all().numpy(), self.j.read_all())


def rand_ops(rng, n, m, lo=-5):
    return (rng.integers(lo, n + 5, m), rng.integers(0, 4, m))


def test_words_carry_the_reference_bytes():
    """A chunk's bytes (the reference's ``pack2``) as int32 words: the same
    fields in the same order, and back to the same bytes."""
    rng = np.random.default_rng(0)
    for k in (0, 1, 3, 4, 17, 1000):
        v = rng.integers(0, 4, k).astype(np.uint8)
        p = JB.pack2(v)
        w = TB.bytes_to_words(p, "cpu")
        assert w.dtype == torch.int32 and w.shape[0] == -(-p.shape[0] // 4)
        assert np.array_equal(TB.words_to_bytes(w, p.shape[0]), p)
        assert BA.unpack_values(w)[:k].tolist() == v.tolist()


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_generic_syncs_and_streams(tmp_path, layout, compress):
    """Random updates (spilling past log_buf_rows), syncs with each
    combine / apply, the transform hook, the streaming scans: the trees
    and counters equal after every step."""
    n, ce = layout
    rng = np.random.default_rng(n + ce)
    reset()
    p = Pair(tmp_path, n, ce, log_buf_rows=50, compress=compress)
    p.same()
    combos = [
        (None, None, None),
        ((np.bitwise_or, torch.bitwise_or),
         (lambda o, a: np.maximum(o, a), lambda o, a: torch.maximum(o, a)),
         None),
        ((lambda x, y: x, lambda x, y: x),
         (lambda o, a: np.where(o == 0, a, o),
          lambda o, a: torch.where(o == 0, a, o)),
         (lambda s, v: np.where(v == 1, np.uint8(3), v),
          lambda s, v: torch.where(v == 1, 3, v))),
    ]
    for rnd in range(6):
        for _ in range(3):
            p.update(*rand_ops(rng, n, int(rng.integers(0, 80))))
        comb, app, tr = combos[rnd % 3]
        p.j.sync(combine=comb and comb[0], apply=app and app[0],
                 transform=tr and tr[0])
        p.t.sync(combine=comb and comb[1], apply=app and app[1],
                 transform=tr and tr[1])
        p.same()
        want, got = counters()
        assert want == got
    p.j.map_update(lambda s, v: (v + (s // ce) % 4) % 4)
    p.t.map_update(lambda s, v: (v + (s // ce) % 4) % 4)
    seen_j, seen_t = [], []
    p.j.map_chunks(lambda s, v: seen_j.append((s, v.tolist())))
    p.t.map_chunks(lambda s, v: seen_t.append((s, v.tolist())))
    assert seen_j == seen_t
    assert p.t.count_values().tolist() == p.j.count_values().tolist()
    q = rng.integers(0, n, 300)
    assert p.t.get(q).tolist() == p.j.get(q).tolist()
    assert p.t.nbytes == p.j.nbytes
    p.same()
    assert counters()[0] == counters()[1]


def bfs_like_ops(rng, n, m):
    return rng.integers(0, n, m), np.full(m, NEXT)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_packed_route_is_the_reference_pass(tmp_path, layout, fused):
    """run_pass(mark=(NEXT, UNSEEN)) with rotates / counts / a reader on
    the port against the reference's generic pass of the same meaning
    (combine first, apply only-if-UNSEEN, a rotate stage, a count stage)
    — the implicit BFS's fused level and its unfused sync."""
    n, ce = layout
    rng = np.random.default_rng(3 * n + ce)
    reset()
    p = Pair(tmp_path, n, ce, log_buf_rows=40)
    p.update(rng.integers(0, n, n // 3), rng.integers(0, 4, n // 3))
    p.j.sync()
    p.t.sync()

    def rotate_np(s, v):
        v = np.where(v == CUR, np.uint8(DONE), v)
        return np.where(v == NEXT, np.uint8(CUR), v)

    for rnd in range(4):
        if rnd != 2:                                 # a pass with no marks
            p.update(*bfs_like_ops(rng, n, int(rng.integers(1, 120))))
        counts = {"j": [], "t": []}
        reads = {"j": [], "t": []}
        if fused:
            jp = (jpasses.PassPlan("bfs-level").writes(rotate_np)
                  .reads(lambda s, v: counts["j"].append(
                      int(np.count_nonzero(v == CUR))))
                  .reads(lambda s, v: reads["j"].append(v.tolist())))
            tp = (tpasses.PassPlan("bfs-level").rotates(BA.ROTATE_LUT)
                  .counts(CUR, lambda s, c: counts["t"].append(c))
                  .reads(lambda s, v: reads["t"].append(v.tolist())))
        else:
            def mark_rotate(s, v):
                v = rotate_np(s, v)
                counts["j"].append(int(np.count_nonzero(v == CUR)))
                return v
            jp = jpasses.PassPlan("sync").writes(mark_rotate)
            tp = tpasses.PassPlan("sync").rotates(
                BA.ROTATE_LUT, CUR, lambda s, c: counts["t"].append(c))
        p.j.run_pass(jp, combine=lambda a, b: a,
                     apply=lambda o, a: np.where(o == UNSEEN, a, o))
        p.t.run_pass(tp, mark=(NEXT, UNSEEN), fuse=fused)
        assert counts["j"] == counts["t"]
        assert reads["j"] == reads["t"]
        p.same()
        assert counters()[0] == counters()[1]


def test_packed_route_refuses_other_payloads(tmp_path):
    ba = TB.DiskBitArray(str(tmp_path), 64, chunk_elems=16, device="cpu")
    ba.update([3, 5], [NEXT, CUR])
    plan = tpasses.PassPlan().rotates(BA.ROTATE_LUT)
    with pytest.raises(ValueError, match="payloads"):
        ba.run_pass(plan, mark=(NEXT, UNSEEN))
    with pytest.raises(ValueError, match="mark="):
        ba.run_pass(plan, combine=torch.bitwise_or, mark=(NEXT, UNSEEN))
    ba.sync()                         # the aborted pass's ops re-adopt
    assert ba.get([3, 5]).tolist() == [NEXT, CUR]


def test_dirty_only_plan_visits_only_logged_chunks(tmp_path):
    ba = TB.DiskBitArray(str(tmp_path), 64, chunk_elems=16, device="cpu")
    ba.update([17], [1])
    seen = []
    TB.reset_stats()
    ba.run_pass(tpasses.PassPlan("seed", dirty_only=True)
                .reads(lambda s, v: seen.append(s)))
    assert seen == [16]
    assert TB.STATS["bytes_read"] - TB.STATS["log_bytes_read"] == 4
    assert ba.get([17]).tolist() == [1]


class TestSnapshotIsolation:
    """``tests/test_passes.py``'s pins, on the port."""

    def test_mid_pass_updates_defer_to_next_pass(self, tmp_path):
        ba = TB.DiskBitArray(str(tmp_path), 64, chunk_elems=16, device="cpu")
        ba.update([0], [1])

        def echo_mark(start, vals):
            if start == 0:
                ba.update([60], [3])

        ba.run_pass(tpasses.PassPlan("iso").reads(echo_mark))
        assert ba.get([0, 60]).tolist() == [1, 0]
        ba.sync()
        assert ba.get([60]).tolist() == [3]

    def test_mid_pass_update_to_earlier_chunk_defers_too(self, tmp_path):
        ba = TB.DiskBitArray(str(tmp_path), 64, chunk_elems=16, device="cpu")

        def mark_back(start, vals):
            if start == 48:
                ba.update([1], [2])

        ba.run_pass(tpasses.PassPlan().reads(mark_back))
        assert ba.get([1]).tolist() == [0]
        ba.sync()
        assert ba.get([1]).tolist() == [2]

    @pytest.mark.parametrize("packed", [False, True])
    def test_aborted_pass_snapshot_is_readopted(self, tmp_path, packed):
        ba = TB.DiskBitArray(str(tmp_path), 32, chunk_elems=16, device="cpu")
        ba.update([2], [NEXT])

        class Boom(Exception):
            pass

        def blow_up(start, vals):
            raise Boom

        with pytest.raises(Boom):
            if packed:
                ba.run_pass(tpasses.PassPlan().rotates(BA.ROTATE_LUT)
                            .reads(blow_up), mark=(NEXT, UNSEEN))
            else:
                ba.run_pass(tpasses.PassPlan().reads(blow_up))
        assert os.path.exists(os.path.join(ba.path, "log000000.bin.pass"))
        ba.update([3], [DONE])
        ba.sync()
        assert ba.get([2, 3]).tolist() == [NEXT, DONE]


@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
@pytest.mark.parametrize("compress", [(False, False), (True, False),
                                      (False, True)])
def test_snapshots_cross_packages(tmp_path, direction, compress):
    """A snapshot (chunks, spilled logs, a leftover ``.pass``) taken by one
    package is adopted by the other, across the codec boundary; the next
    sync gives the same bytes as the writer's own."""
    rng = np.random.default_rng(9)
    n, ce = 1000, 36
    src_pkg, dst_pkg = ((JB, TB) if direction == "ref->port" else (TB, JB))

    def make(pkg, where, comp):
        kw = {"device": "cpu"} if pkg is TB else {}
        return pkg.DiskBitArray(str(tmp_path / where), n, chunk_elems=ce,
                                name="a", log_buf_rows=30, compress=comp,
                                **kw)

    src = make(src_pkg, "src", compress[0])
    ops = rand_ops(rng, n, 200, lo=0)
    src.update(*ops)
    src.sync()
    src.update(*rand_ops(rng, n, 90, lo=0))
    snap = str(tmp_path / "snap")
    got_bytes = src.snapshot_to(snap)
    assert got_bytes == sum(len(b) for b in files(snap).values())
    dst = make(dst_pkg, "dst", compress[1])
    dst.update([1, 2, 3], [3, 3, 3])          # pre-adopt state is dropped
    dst.adopt_snapshot(snap)
    src.sync()
    dst.sync()
    want = src.read_all()
    got = dst.read_all()
    assert np.array_equal(np.asarray(got), np.asarray(want))
    mine = make(dst_pkg, "mine", compress[1])
    mine.adopt_snapshot(snap)
    mine.sync()
    assert files(mine.path) == files(dst.path)


def _fault_run(pkg, faults, wd, spec):
    """Spilled updates and two syncs under ``spec``; returns the tree,
    the counters and the retry ledger."""
    faults.install(faults.parse(spec).bind(state_dir=None))
    pkg.reset_stats()
    (jx if pkg is JB else tx).reset_stats()
    try:
        kw = {"device": "cpu"} if pkg is TB else {}
        ba = pkg.DiskBitArray(wd, 300, chunk_elems=36, name="a",
                              log_buf_rows=20, **kw)
        rng = np.random.default_rng(1)
        for _ in range(6):
            ba.update(*rand_ops(rng, 300, 30, lo=0))
        ba.sync()
        ba.update(*rand_ops(rng, 300, 30, lo=0))
        ba.sync(transform=lambda s, v: v ^ 1)
        x = jx if pkg is JB else tx
        return (files(ba.path), {k: v for k, v in pkg.STATS.items() if v},
                (x.STATS["io_retries"], x.STATS["io_giveups"]))
    finally:
        faults.uninstall()


@pytest.mark.parametrize("spec", [
    "seed=1;oplog_append:torn:every=3:once=0;chunk_flush:transient:"
    "every=4:once=0",
    "seed=2;chunk_flush:transient:p=0.5:once=0;oplog_append:transient:"
    "every=2:times=2:once=0",
    jfaults.default_chaos_spec(5),
])
def test_fault_sites_fire_and_heal_to_the_same_bytes(tmp_path, spec):
    clean = _fault_run(TB, tfaults, str(tmp_path / "clean"), "")
    want = _fault_run(JB, jfaults, str(tmp_path / "ref"), spec)
    got = _fault_run(TB, tfaults, str(tmp_path / "port"), spec)
    assert got == want
    assert got[2][0] > 0 and got[2][1] == 0    # retried, never gave up
    assert got[0] == clean[0] and got[1] == clean[1]


def test_fatal_fault_raises_like_the_reference(tmp_path):
    for pkg, faults, where in ((JB, jfaults, "ref"), (TB, tfaults, "port")):
        faults.install(faults.parse("chunk_flush:fatal:at=2").bind())
        try:
            kw = {"device": "cpu"} if pkg is TB else {}
            ba = pkg.DiskBitArray(str(tmp_path / where), 64, chunk_elems=16,
                                  name="a", **kw)
            ba.update([1, 40], [1, 2])
            with pytest.raises(OSError) as ei:
                ba.sync()
            assert ei.value.errno not in tfaults.TRANSIENT_ERRNOS
        finally:
            faults.uninstall()
    assert files(tmp_path / "ref") == files(tmp_path / "port")


def test_default_device_is_the_card(tmp_path):
    """The default device is "cuda": with no card it raises before a
    file is written, and never moves to the CPU by itself."""
    if torch.cuda.is_available():
        ba = TB.DiskBitArray(str(tmp_path), 64, chunk_elems=16)
        assert ba.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.DiskBitArray(str(tmp_path), 64, chunk_elems=16)
    assert not os.listdir(tmp_path)            # nothing written first
