"""Port parity: the bucket wires of Tier D's sharded runtime,
``repro_torch.core.disk.transport`` against ``repro.core.disk.transport``.

Tolerance: none.  The conformance suite of the reference runs over the
port's three wires (fs, tcp, loopback): sealed buckets arrive whole and
in ascending source order, in barrier and live mode; a drained epoch
redrains empty; unsealed traffic stays invisible; epochs stay apart;
overflow drops exactly; a killed writer's strays are swept while sealed
traffic survives; a wipe discards one structure's traffic only; and the
``transport`` byte counters are symmetric.  Across the packages: the fs
wire's files (barrier layout, pipelined ``.done`` markers after their
data) are the reference's names and bytes, and each package's TCP
receiver takes the other's frames, torn and garbage frames dropped
whole.  ``make_transport``'s errors and the per-key DEL/PUT order through
a pipelined exchange are the reference's.  Every TCP socket binds an
ephemeral port on 127.0.0.1.
"""
import os
import socket

import numpy as np
import pytest

from repro.core.disk import transport as JT
from repro_torch.core.disk import buckets as B
from repro_torch.core.disk import transport as TT
from repro_torch.core.disk.buckets import TRANSPORT_STATS
from repro_torch.core.disk.cluster import ShardedDiskHashTable, ShardRuntime
from repro_torch.core.disk.transport import (TRANSPORT_KINDS, LoopbackStore,
                                             make_transport)


def _spec(**kw):
    spec = {"name": "x", "rec_width": 1, "rec_dtype": "int64"}
    spec.update(kw)
    return spec


def _rows(*vals):
    return np.asarray(vals, np.int64).reshape(-1, 1)


def files(path):
    out = {}
    for root, _, names in os.walk(path):
        for fn in names:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def _build_wire(kind, root, nshards=2, mod=TT):
    """One transport per shard, fully wired (tcp handshake included)."""
    store = mod.LoopbackStore() if kind == "loopback" else None
    ts = [mod.make_transport({"kind": kind, "host": "127.0.0.1"}, s,
                             nshards, root, store=store)
          for s in range(nshards)]
    if kind == "tcp":
        peers = {s: t.handshake() for s, t in enumerate(ts)}
        for t in ts:
            t.connect(peers)
    return ts


@pytest.fixture(params=TRANSPORT_KINDS)
def wire(request, tmp_path):
    ts = _build_wire(request.param, str(tmp_path))
    yield request.param, ts
    for t in ts:
        t.close()


# ============================================================ conformance

def test_barrier_roundtrip_ascending_src(wire):
    kind, (t0, t1) = wire
    spec = _spec()
    s0, s1 = t0.sender(spec), t1.sender(spec)
    s1.put([0, 0], _rows(10, 11))           # the higher src seals first
    s0.put([0, 1], _rows(1, 2))
    assert s1.seal(epoch=0).sum() == 0
    assert s0.seal(epoch=0).sum() == 0
    got = list(t0.recv(spec, 0, (0, 1), timeout=20))
    assert [src for src, _ in got] == [0, 1]
    assert got[0][1].tolist() == [[1]]
    assert got[1][1].tolist() == [[10], [11]]
    (src, rows), = t1.recv(spec, 0, (0, 1), timeout=20)
    assert src == 0 and rows.tolist() == [[2]]


def test_live_roundtrip_and_redrain_is_empty(wire):
    kind, (t0, t1) = wire
    spec = _spec()
    for t in (t0, t1):
        s = t.sender(spec)
        s.put([0], _rows(100 + t.me))
        s.seal(epoch=0, publish_done=True)
    got = list(t0.recv(spec, 0, (0, 1), live=True, timeout=20))
    assert [(s, r.tolist()) for s, r in got] == [(0, [[100]]), (1, [[101]])]
    assert list(t0.recv(spec, 0, (0, 1), live=True, timeout=20)) == []


def test_unsealed_traffic_is_invisible(wire):
    kind, (t0, t1) = wire
    spec = _spec()
    s1 = t1.sender(spec)
    s1.put([0], _rows(7))
    s1._spill()
    with pytest.raises(TimeoutError):
        list(t0.recv(spec, 0, (1,), live=True, ordered=False, timeout=0.3))


def test_live_ordered_waits_for_ascending_src(wire):
    kind, (t0, t1) = wire
    spec = _spec()
    s1 = t1.sender(spec)
    s1.put([0], _rows(11))
    s1.seal(epoch=0, publish_done=True)
    with pytest.raises(TimeoutError):
        list(t0.recv(spec, 0, (0, 1), live=True, ordered=True, timeout=0.4))
    it = t0.recv(spec, 0, (0, 1), live=True, ordered=False, timeout=20)
    src, rows = next(it)
    assert src == 1 and rows.tolist() == [[11]]
    it.close()
    s0 = t0.sender(spec)
    s0.put([0], _rows(1))
    s0.seal(epoch=0, publish_done=True)
    got = list(t0.recv(spec, 0, (0, 1), live=True, timeout=20))
    assert [(s, r.tolist()) for s, r in got] == [(0, [[1]])]


def test_overflow_dropped_exact(wire):
    kind, (t0, t1) = wire
    spec = _spec(capacity=2)
    s0 = t0.sender(spec)
    s0.put([0, 0, 0], _rows(1, 2, 3))
    s0.put([0, 0, 1], _rows(4, 5, 6))
    assert s0.seal(epoch=0).tolist() == [3, 0]
    (src, rows), = t0.recv(spec, 0, (0,), timeout=20)
    assert src == 0 and rows.tolist() == [[1], [2]]
    (src, rows), = t1.recv(spec, 0, (0,), timeout=20)
    assert rows.tolist() == [[6]]
    s0.put([0, 0], _rows(7, 8))
    assert s0.seal(epoch=1).tolist() == [0, 0]


def test_epoch_isolation(wire):
    kind, (t0, t1) = wire
    spec = _spec()
    s1 = t1.sender(spec)
    s1.put([0], _rows(1))
    s1.seal(epoch=0, publish_done=True)
    s1.put([0], _rows(2))
    s1.seal(epoch=1, publish_done=True)
    (_, rows), = t0.recv(spec, 1, (1,), live=True, timeout=20)
    assert rows.tolist() == [[2]]
    (_, rows), = t0.recv(spec, 0, (1,), live=True, timeout=20)
    assert rows.tolist() == [[1]]


def test_killed_writer_strays_swept_sealed_survives(wire, tmp_path):
    kind, (t0, t1) = wire
    spec = _spec()
    dead = t1.sender(spec)
    dead.put([0], _rows(666))
    dead._spill()               # killed mid-epoch: staged, never sealed
    live = t0.sender(spec)
    live.put([0], _rows(1))
    live.seal(epoch=0)
    if kind == "loopback":
        t1b = make_transport({"kind": kind}, 1, 2, str(tmp_path),
                             store=t0.store)
    else:
        t1b = make_transport({"kind": kind, "host": "127.0.0.1"}, 1, 2,
                             str(tmp_path))
    try:
        t1b.startup(fresh=False)
        (src, rows), = t0.recv(spec, 0, (0,), timeout=20)
        assert src == 0 and rows.tolist() == [[1]]
        if kind in ("fs", "tcp"):
            for base, _dirs, names in os.walk(str(tmp_path)):
                assert not any(f.endswith(".tmp") for f in names), names
    finally:
        t1b.close()


def test_wipe_discards_structure_traffic(wire):
    """Both structures' traffic is sealed and waiting before the wipe
    (each recv below needs its epoch complete), so nothing races."""
    kind, (t0, t1) = wire
    spec, other = _spec(), _spec(name="y")
    for sp in (spec, other):
        s1 = t1.sender(sp)
        s1.put([0], _rows(5))
        s1.seal(epoch=0, publish_done=True)
    # every payload has landed before the wipe (tcp delivers on threads)
    for sp in (spec, other):
        box = (t0._receiver.box if kind == "tcp" else
               t0.store if kind == "loopback" else None)
        if box is not None:
            with box.cond:
                assert box.cond.wait_for(
                    lambda: 1 in box.sealed_set(sp["name"], 0, 0),
                    timeout=20)
    for t in (t0, t1):
        t.wipe("x")
    with pytest.raises(TimeoutError):
        list(t0.recv(spec, 0, (1,), live=True, ordered=False, timeout=0.3))
    (_, rows), = t0.recv(other, 0, (1,), live=True, timeout=20)
    assert rows.tolist() == [[5]]


def test_bytes_on_wire_counters_symmetric(wire):
    kind, (t0, t1) = wire
    spec = _spec(rec_width=2)
    before = dict(TRANSPORT_STATS)
    s1 = t1.sender(spec)
    s1.put([0, 0, 1], np.arange(6, dtype=np.int64).reshape(3, 2))
    s1.seal(epoch=0, publish_done=True)
    list(t0.recv(spec, 0, (1,), live=True, timeout=20))
    list(t1.recv(spec, 0, (1,), live=True, timeout=20))
    d = {k: TRANSPORT_STATS[k] - before.get(k, 0) for k in TRANSPORT_STATS}
    assert d[f"{kind}_bytes_out"] == d[f"{kind}_bytes_in"] == 6 * 8
    assert d[f"{kind}_buckets_out"] == d[f"{kind}_buckets_in"] == 2
    for other in set(TRANSPORT_KINDS) - {kind}:
        assert d[f"{other}_bytes_out"] == d[f"{other}_bytes_in"] == 0


@pytest.mark.parametrize("kind", ("tcp", "loopback"))
def test_wire_compress_roundtrip(tmp_path, kind):
    store = LoopbackStore() if kind == "loopback" else None
    ts = [make_transport({"kind": kind, "host": "127.0.0.1",
                          "wire_compress": True}, s, 2, str(tmp_path),
                         store=store) for s in range(2)]
    try:
        if kind == "tcp":
            peers = {s: t.handshake() for s, t in enumerate(ts)}
            for t in ts:
                t.connect(peers)
        s1 = ts[1].sender(_spec())
        s1.put(np.zeros(4096, np.int64), np.zeros((4096, 1), np.int64))
        s1.seal(epoch=0)
        (src, rows), = ts[0].recv(_spec(), 0, (1,), timeout=20)
        assert src == 1 and rows.shape == (4096, 1) and not rows.any()
    finally:
        for t in ts:
            t.close()


# ========================================================== construction

def test_make_transport_errors(tmp_path):
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="loopback"):
            mod.make_transport({"kind": "loopback"}, 0, 2, str(tmp_path))
        with pytest.raises(ValueError, match="unknown transport"):
            mod.make_transport({"kind": "carrier-pigeon"}, 0, 2,
                               str(tmp_path))
        with pytest.raises(ValueError, match="mailbox wire"):
            mod.make_transport({"kind": "fs", "wire_compress": True}, 0, 2,
                               str(tmp_path))
    assert TT.TRANSPORT_KINDS == JT.TRANSPORT_KINDS


def test_seal_before_connect_is_loud(tmp_path):
    t0 = make_transport({"kind": "tcp", "host": "127.0.0.1"}, 0, 2,
                        str(tmp_path))
    try:
        s0 = t0.sender(_spec())
        s0.put([1], _rows(1))
        with pytest.raises(AssertionError, match="handshake"):
            s0.seal(epoch=0)
    finally:
        t0.close()


# ============================================================== tcp wire

def test_tcp_frames_are_the_references():
    for args in ((0, 1, 7, "x", b""), (1, 3, 12, "bfs1", b"\x01" * 9)):
        assert TT._frame(*args) == JT._frame(*args)
    assert TT._HEADER.format == JT._HEADER.format


@pytest.mark.parametrize("send_mod,recv_mod", [(TT, JT), (JT, TT)])
def test_tcp_torn_and_garbage_frames_dropped_whole(tmp_path, send_mod,
                                                   recv_mod):
    """Each package's receiver takes the other's frames; a sender dying
    mid-frame and a garbage stream leave nothing behind."""
    recv = recv_mod.make_transport({"kind": "tcp", "host": "127.0.0.1"},
                                   0, 2, str(tmp_path / "r"))
    send = send_mod.make_transport({"kind": "tcp", "host": "127.0.0.1"},
                                   1, 2, str(tmp_path / "s"))
    try:
        addr = recv.handshake()
        send.connect({0: addr, 1: send.handshake()})
        with socket.create_connection(addr, timeout=5) as s:
            s.sendall(b"RMYB\x00")
        with socket.create_connection(addr, timeout=5) as s:
            s.sendall(b"NOPE" + b"\x00" * 30)
        with socket.create_connection(addr, timeout=5) as s:
            s.sendall(TT._frame(TT._DATA, 1, 0, "x", b"\x05" * 16)[:-3])
        sender = send.sender(_spec())
        sender.put([0, 0], _rows(42, 43))
        sender.seal(epoch=0, publish_done=True)
        got = list(recv.recv(_spec(), 0, (1,), live=True, timeout=20))
        assert [(s_, r.tolist()) for s_, r in got] == [(1, [[42], [43]])]
    finally:
        recv.close()
        send.close()


def test_tcp_spool_is_node_local(tmp_path):
    t0, t1 = _build_wire("tcp", str(tmp_path))
    try:
        s0 = t0.sender(_spec())
        s0.put([1], _rows(9))
        s0._spill()
        assert os.path.isdir(os.path.join(str(tmp_path), "shard000",
                                          "_spool", "x"))
        assert not os.path.exists(os.path.join(str(tmp_path), "exchange"))
    finally:
        t0.close()
        t1.close()


# =============================================================== fs wire

def _fs_traffic(mod, root, publish_done):
    t0, t1, t2 = _build_wire("fs", root, nshards=3, mod=mod)
    rng = np.random.default_rng(11)
    for epoch in range(2):
        for t in (t0, t1, t2):
            s = t.sender(_spec(rec_width=2))
            s.put(rng.integers(0, 3, 40), rng.integers(0, 99, (40, 2)))
            s.seal(epoch=epoch, publish_done=publish_done)


@pytest.mark.parametrize("publish_done", (False, True))
def test_fs_layout_is_the_references(tmp_path, publish_done):
    _fs_traffic(JT, str(tmp_path / "ref"), publish_done)
    _fs_traffic(TT, str(tmp_path / "port"), publish_done)
    want, got = files(tmp_path / "ref"), files(tmp_path / "port")
    assert got == want
    names = sorted(os.path.basename(f) for f in got)
    assert any(n.endswith(".done") for n in names) == publish_done
    assert "e000001_s002_d001.bin" in names


def test_fs_barrier_layout_is_byte_compatible(tmp_path):
    t0, _t1 = _build_wire("fs", str(tmp_path))
    s0 = t0.sender(_spec())
    s0.put([0, 1], _rows(1, 2))
    s0.seal(epoch=3)
    exch = os.path.join(str(tmp_path), "exchange", "x")
    assert sorted(os.listdir(exch)) == ["e000003_s000_d000.bin",
                                        "e000003_s000_d001.bin"]
    (src, rows), = B.iter_incoming(exch, 1, 3, 1)
    assert src == 0 and rows.tolist() == [[2]]


def test_fs_pipelined_markers_land_after_data(tmp_path, monkeypatch):
    """Every marker is written after every data rename of its seal."""
    t0, _t1 = _build_wire("fs", str(tmp_path))
    order = []
    real_replace = os.replace
    monkeypatch.setattr(os, "replace", lambda a, b: (
        order.append(("data", os.path.basename(b))), real_replace(a, b)))
    real_open = open

    def spy_open(path, mode="r", *a, **k):
        if str(path).endswith(".done"):
            order.append(("done", os.path.basename(str(path))))
        return real_open(path, mode, *a, **k)
    monkeypatch.setattr("builtins.open", spy_open)
    s0 = t0.sender(_spec())
    s0.put([1, 0], _rows(2, 3))
    s0.seal(epoch=0, publish_done=True)
    monkeypatch.undo()
    kinds = [k for k, _ in order]
    assert kinds == ["data", "data", "done", "done"]
    names = sorted(os.listdir(os.path.join(str(tmp_path), "exchange", "x")))
    assert names == ["e000000_s000_d000.bin", "e000000_s000_d000.done",
                     "e000000_s000_d001.bin", "e000000_s000_d001.done"]


# ============================================ per-key order, pipelined

@pytest.mark.parametrize("transport", TRANSPORT_KINDS)
def test_del_put_order_survives_pipelined_exchange(tmp_path, transport):
    with ShardRuntime(str(tmp_path), 2, mode="inline", transport=transport,
                      exchange="pipelined") as rt:
        ht = ShardedDiskHashTable(rt, 1, 1)
        ks = np.arange(8, dtype=np.uint32).reshape(-1, 1)
        ht.insert(ks, np.full((8, 1), 10, np.int64))
        ht.sync()
        ht.remove(ks[:4])
        ht.insert(ks[:4], np.full((4, 1), 99, np.int64))
        ht.insert(ks[4:], np.full((4, 1), 77, np.int64))
        ht.remove(ks[4:])
        ht.sync()
        out, found = ht.lookup(ks)
        assert found[:4].all() and not found[4:].any()
        assert (out[:4, 0] == 99).all()
        assert ht.size() == 4
