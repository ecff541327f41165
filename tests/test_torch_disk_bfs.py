"""Port parity: Tier D's search engines, ``repro_torch.core.disk.bfs``
against ``repro.core.disk.bfs``, and checkpoints across the packages.

Tolerance: none.  The implicit BFS runs pancake n = 7 (5,040 states) in
chunks of 1,000 fields (the last chunk 40 fields, 10 bytes: no whole
word) with ``log_buf_rows = 64`` (the op logs spill every few batches),
fused and unfused, compressed and not, through both packages, each in
its own directory, with the port's passes on the CPU (the kernels'
plain versions).  After every pass the two workdirs are the same files,
byte for byte (chunks, ``.bin`` / ``.pass`` logs), and the ``bits``,
``extsort`` and ``codec`` counters are equal.  The level sizes equal the
reference's and the port's in-memory ``constructs.implicit_bfs``; after
level k the chunk bytes equal that engine's words after k levels, as
little-endian bytes.  A checkpoint written by one package at level k is
resumed by the other, both ways, to the same sizes and bytes.  The
sorted engine's runs, checkpoints and level sizes are held the same way.
"""
import math
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.disk import bfs as JD
from repro.core.disk import config as jconfig
from repro.core.disk import bitarray as JB
from repro.core.disk import codec as jcodec
from repro.core.disk import extsort as jx
from repro.core.disk import lsm as jlsm
from repro_torch.apps import pancake_bfs as PB
from repro_torch.apps import pancake_bits as P
from repro_torch.core import constructs as C
from repro_torch.core.disk import bfs as TD
from repro_torch.core.disk import bitarray as TB
from repro_torch.core.disk import codec as tcodec
from repro_torch.core.disk import extsort as tx
from repro_torch.core.disk import lsm as tlsm
from repro_torch.core.disk import config as tconfig
from repro_torch.core.disk.config import CheckpointConfig, ClusterConfig

sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))
from pancake_bfs import GenNextNp, start_code  # noqa: E402
from pancake_bits import NeighborsNp  # noqa: E402

N = 7
TOTAL = math.factorial(N)
START = P.start_rank(N)
CE, LOG_ROWS = 1000, 64
SIZES_7 = [1, 6, 30, 149, 543, 1357, 1903, 1016, 35]


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


def stats(port):
    """The bits, extsort and codec counters that are not 0 (other modules
    of a package may register more keys in a namespace)."""
    mods = (TB, tx, tcodec) if port else (JB, jx, jcodec)
    return tuple({k: v for k, v in m.STATS.items() if v} for m in mods)


def record_passes(monkeypatch, cls, root, port, log):
    """After every pass (``run_pass``, which ``sync`` rides, and the
    unfused engine's ``map_chunks``), append (files, counters)."""
    for name in ("run_pass", "map_chunks"):
        orig = getattr(cls, name)

        def wrapped(self, *a, _orig=orig, **kw):
            out = _orig(self, *a, **kw)
            log.append((files(root), stats(port)))
            return out
        monkeypatch.setattr(cls, name, wrapped)


def ckpt(key, **kw):
    """Each package's own CheckpointConfig."""
    return (jconfig if key == "ref" else tconfig).CheckpointConfig(**kw)


def run_ref(wd, **kw):
    return JD.implicit_bfs(str(wd), TOTAL, [START], NeighborsNp(N),
                           chunk_elems=CE, log_buf_rows=LOG_ROWS, **kw)


def run_port(wd, **kw):
    return TD.implicit_bfs(str(wd), TOTAL, [START], P.neighbors(N),
                           chunk_elems=CE, log_buf_rows=LOG_ROWS,
                           device="cpu", **kw)


def memory_words_bytes(levels):
    """The in-memory engine's words after ``levels`` levels, as bytes."""
    _, ba = C.implicit_bfs(TOTAL, [START], P.neighbors(N),
                           max_levels=levels, device="cpu")
    nbytes = -(-TOTAL // 4)
    return ba.data.numpy().tobytes()[:nbytes]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_implicit_bfs_every_pass_is_the_reference(tmp_path, monkeypatch,
                                                  fused, compress):
    logs = {"ref": [], "port": []}
    record_passes(monkeypatch, JB.DiskBitArray, str(tmp_path / "ref"),
                  False, logs["ref"])
    record_passes(monkeypatch, TB.DiskBitArray, str(tmp_path / "port"),
                  True, logs["port"])
    reset()
    sj, bj = run_ref(tmp_path / "ref", fused=fused, compress=compress)
    sj_stats = stats(False)
    st, bt = run_port(tmp_path / "port", fused=fused, compress=compress)
    assert sj == st == SIZES_7
    assert stats(True) == sj_stats
    assert len(logs["port"]) == len(logs["ref"]) == (
        len(SIZES_7) + 1 if fused else 2 * len(SIZES_7) + 1)
    for k, (got, want) in enumerate(zip(logs["port"], logs["ref"])):
        assert sorted(got[0]) == sorted(want[0]), k
        for fn in want[0]:
            assert got[0][fn] == want[0][fn], (k, fn)
        assert got[1] == want[1], k
    assert bt.n_chunks == 6 and bt._chunk_rows(5) == 40
    assert bt.count_values().tolist() == [0, 0, 0, TOTAL]
    sizes_mem, _ = C.implicit_bfs(TOTAL, [START], P.neighbors(N),
                                  fused=fused, device="cpu")
    assert sizes_mem == st
    if fused and not compress:
        # pass k leaves level k rotated in: the in-memory words after k
        # levels, byte for byte (the seed pass is level 0)
        for k, (tree, _) in enumerate(logs["port"][:-1]):
            nbs = [-(-bt._chunk_rows(c) // 4) for c in range(bt.n_chunks)]
            got = b"".join(tree[f"bfs_bits/b{c:06d}.npy"][-nb:]
                           for c, nb in enumerate(nbs))
            assert got == memory_words_bytes(k), k


def test_one_read_write_pass_per_level(tmp_path):
    """``tests/test_passes.py:189``'s budget on the port: one fused
    read-write pass per level, the array traversed once to the byte."""
    n_states = 256

    def ring(idx):
        return torch.stack([(idx + 1) % n_states, (idx - 1) % n_states], 1)

    reset()
    sizes, bits = TD.implicit_bfs(str(tmp_path), n_states, [0], ring,
                                  chunk_elems=64, device="cpu")
    passes = len(sizes) + 1
    assert sum(sizes) == n_states
    assert TB.STATS["sync_passes"] == passes and TB.STATS["scan_passes"] == 0
    assert tx.STATS["rw_passes"] == passes
    assert tx.STATS["piggybacked_stages"] >= 2 * passes
    arr_read = TB.STATS["bytes_read"] - TB.STATS["log_bytes_read"]
    arr_written = TB.STATS["bytes_written"] - TB.STATS["log_bytes_written"]
    assert arr_read == arr_written == (passes - 1) * bits.nbytes + 16


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("kill_after", [0, 3])
@pytest.mark.parametrize("compress", [(False, False), (True, False),
                                      (False, True)])
def test_implicit_checkpoint_crosses_packages(tmp_path, writer, kill_after,
                                              compress):
    runs = {"ref": run_ref, "port": run_port}
    reader = "port" if writer == "ref" else "ref"
    ck = str(tmp_path / "ck")
    part, bits = runs[writer](tmp_path / "w1", compress=compress[0],
                              checkpoint=ckpt(writer, dir=ck, every=1),
                              max_levels=kill_after)
    assert part == SIZES_7[:kill_after + 1]
    sizes, bits = runs[reader](tmp_path / "w2", compress=compress[1],
                               checkpoint=ckpt(reader, dir=ck, resume=True))
    assert sizes == SIZES_7
    full, fb = runs[reader](tmp_path / "w3", compress=compress[1])
    assert files(bits.path) == files(fb.path)


def test_checkpoints_are_the_same_bytes(tmp_path):
    """The two packages publish the same checkpoint directory (manifest,
    META.json, chunk and log payload) at every level."""
    for key, run in (("ref", run_ref), ("port", run_port)):
        run(tmp_path / f"w_{key}", max_levels=4,
            checkpoint=ckpt(key, dir=str(tmp_path / f"ck_{key}"), every=2))
    assert files(tmp_path / "ck_ref") == files(tmp_path / "ck_port")


def test_engine_config_errors(tmp_path):
    """The engines refuse what the reference's validation refuses
    (``tests/test_transport.py::TestConfigValidation``), with the same
    messages; a sharded config itself runs (``test_torch_cluster.py``)."""
    from repro_torch.core.disk.cluster import ShardRuntime

    def both(fn):
        msgs = []
        for key in ("ref", "port"):
            with pytest.raises(ValueError) as ei:
                fn(key)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
        return msgs[1]

    def sorted_kw(key, **kw):
        mod, gen = ((JD, GenNextNp(5)) if key == "ref" else
                    (TD, PB.HostMoves(5, P.prefix_flip_table(5))))
        return mod.breadth_first_search(
            str(tmp_path / f"s_{key}"), start_code(5)[None], gen, 1, **kw)

    def implicit_kw(key, **kw):
        return (run_ref if key == "ref" else run_port)(
            tmp_path / f"i_{key}", **kw)

    def cl(key, **kw):
        return (jconfig if key == "ref" else tconfig).ClusterConfig(**kw)

    for run in (sorted_kw, implicit_kw):
        assert "fused=False" in both(lambda k: run(
            k, fused=False, cluster=cl(k, nshards=2)))
        assert "fused" in both(lambda k: run(
            k, fused=False, checkpoint=ckpt(k, dir="ck")))
        assert "transport" in both(lambda k: run(
            k, cluster=cl(k, transport="smoke-signal")))
        assert "exchange" in both(lambda k: run(
            k, cluster=cl(k, exchange="vibes")))
        assert "loopback" in both(lambda k: run(
            k, cluster=cl(k, transport="loopback", mode="spawn")))
        assert "nshards" in both(lambda k: run(k, cluster=cl(k, nshards=0)))
        assert "mailbox" in both(lambda k: run(
            k, cluster=cl(k, wire_compress=True)))
    with ShardRuntime(str(tmp_path / "rt"), 2, mode="inline") as rt:
        with pytest.raises(ValueError, match="nshards=4 was also passed"):
            run_port(tmp_path / "f", cluster=ClusterConfig(runtime=rt,
                                                           nshards=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.implicit_bfs(str(tmp_path / "e"), 24, [0], P.neighbors(4))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.implicit_bfs(str(tmp_path / "g"), 24, [0], P.neighbors(4),
                            cluster=ClusterConfig(nshards=2, mode="inline"))


# ----------------------------------------------------- the sorted engine

def sorted_run(key, wd, n=6, **kw):
    mod = JD if key == "ref" else TD
    gen = GenNextNp(n) if key == "ref" else PB.HostMoves(
        n, P.prefix_flip_table(n))
    start = (np.array([[start_code(n)]], np.uint32) if key == "ref"
             else PB.start_code(n)[None])
    return mod.breadth_first_search(str(wd), start, gen, width=1,
                                    chunk_rows=128, run_rows=512, **kw)


SORTED_CASES = [
    {}, {"compress": True}, {"compaction": "tiered", "max_runs": 2},
    {"max_runs": 2}, {"fused": False},
]


@pytest.mark.parametrize("kw", SORTED_CASES)
def test_sorted_bfs_is_the_reference(tmp_path, monkeypatch, kw):
    """The fused engine's workdir is the same files after every level (each
    level ends in ``SortedRunSet.add_run``); the unfused one's lists."""
    out, trees = {}, {"ref": [], "port": []}
    for key, mod in (("ref", jlsm), ("port", tlsm)):
        orig = mod.SortedRunSet.add_run

        def add_run(self, store, _orig=orig, _key=key):
            _orig(self, store)
            trees[_key].append(files(tmp_path / _key))
        monkeypatch.setattr(mod.SortedRunSet, "add_run", add_run)
    for key in ("ref", "port"):
        reset()
        sizes, all_ = sorted_run(key, tmp_path / key, **kw)
        out[key] = (sizes, all_.read_all(), stats(key == "port")[1])
    assert out["ref"][0] == out["port"][0] == [1, 5, 20, 79, 199, 281, 133,
                                               2]
    assert np.array_equal(out["ref"][1], out["port"][1])
    assert out["ref"][2] == out["port"][2]
    assert trees["ref"] == trees["port"]
    if kw.get("fused", True):
        assert len(trees["port"]) == len(out["port"][0])
        assert files(tmp_path / "ref") == files(tmp_path / "port")


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("compress", [(False, False), (True, False)])
def test_sorted_checkpoint_crosses_packages(tmp_path, writer, compress):
    reader = "port" if writer == "ref" else "ref"
    ck = str(tmp_path / "ck")
    sorted_run(writer, tmp_path / "w1", compress=compress[0], max_levels=3,
               checkpoint=ckpt(writer, dir=ck, every=1))
    sizes, _ = sorted_run(reader, tmp_path / "w2", compress=compress[1],
                          checkpoint=ckpt(reader, dir=ck, resume=True))
    assert sizes == [1, 5, 20, 79, 199, 281, 133, 2]
    shutil.rmtree(ck)
    for key in ("ref", "port"):
        sorted_run(key, tmp_path / f"x_{key}", max_levels=4,
                   checkpoint=ckpt(key, dir=str(tmp_path / f"ck_{key}")))
    assert files(tmp_path / "ck_ref") == files(tmp_path / "ck_port")
