"""Port parity: Tier D's sharded runtime, ``repro_torch.core.disk.cluster``
against ``repro.core.disk.cluster``.

Tolerance: none.  Inline runtimes run the collectives, sweep the strays
of a killed run at start and return the exact overflow drops of each
structure at ``sync``.  The sharded list, hash table and 2-bit array at
1, 2 and 4 shards hold the same elements as the port's single-process
structures and as the reference's sharded ones on the same inputs (the
bit array's ``get`` / ``read_all`` / ``count_values`` come back as
tensors on its device).  Both sharded BFS engines run pancake n = 5
over every shard count, wire and exchange, inline, with the reference's
level sizes; with the fs wire and the barrier exchange every shard
workdir and every bucket file after each shard's pass is the
reference's, byte for byte.  Each shard pays one read-write pass a level
and no sort; a killed worker's strays are ignored and swept; a sharded
checkpoint written by either package at 2 shards resumes in the other,
for both engines.  A few tests spawn real workers: the list and the
worker stats, an error in a worker (and a kernel that cannot launch)
raising through the coordinator, the per-worker implicit budget, the
TCP wire with the pipelined exchange, and one worker killed mid-search
healed by recovery to the exact level sizes.  The port's chunk passes
run on the CPU (the kernels' plain versions).
"""
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.disk import bfs as JD
from repro.core.disk import cluster as JC
from repro.core.disk import config as jconfig
from repro_torch.apps import pancake_bfs as PB
from repro_torch.apps import pancake_bits as P
from repro_torch.core.disk import bfs as TD
from repro_torch.core.disk import bitarray as TBA
from repro_torch.core.disk import buckets as TB
from repro_torch.core.disk import cluster as TC
from repro_torch.core.disk import extsort as tx
from repro_torch.core.disk import faults as tfaults
from repro_torch.core.disk.cluster import (ShardedDiskBitArray,
                                          ShardedDiskList, ShardFailure,
                                          ShardRuntime)
from repro_torch.core.disk.config import (CheckpointConfig, ClusterConfig,
                                          RecoveryConfig)
from repro_torch.core.disk.dhash import DiskHashTable
from repro_torch.core.disk.dlist import DiskList

from _torch_shard_helpers import FailOn

sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))

SHARD_COUNTS = (1, 2, 4)
WIRES = ("fs", "tcp", "loopback")
EXCHANGES = ("barrier", "pipelined")
PANCAKE5 = [1, 4, 12, 35, 48, 20]
PANCAKE6 = [1, 5, 20, 79, 199, 281, 133, 2]
TIMEOUT = 120.0


def files(path):
    out = {}
    for root, _, names in os.walk(path):
        for fn in names:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def ref_gens(n):
    """The reference examples' generators (their module imports jax)."""
    from pancake_bfs import GenNextNp
    from pancake_bits import NeighborsNp
    return GenNextNp(n), NeighborsNp(n)


def host_moves(n):
    return PB.HostMoves(n, P.prefix_flip_table(n))


def cfg(pkg, **kw):
    return (jconfig if pkg == "ref" else
            __import__("repro_torch.core.disk.config",
                       fromlist=["x"])).ClusterConfig(**kw)


def run_implicit(pkg, wd, n=5, chunk_elems=32, **kw):
    total = math.factorial(n)
    start = P.start_rank(n)
    if pkg == "ref":
        return JD.implicit_bfs(str(wd), total, [start], ref_gens(n)[1],
                               chunk_elems=chunk_elems, **kw)
    return TD.implicit_bfs(str(wd), total, [start], P.neighbors(n),
                           chunk_elems=chunk_elems, device="cpu", **kw)


def run_sorted(pkg, wd, n=5, **kw):
    gen = ref_gens(n)[0] if pkg == "ref" else host_moves(n)
    eng = JD if pkg == "ref" else TD
    return eng.breadth_first_search(str(wd), PB.start_code(n)[None], gen,
                                    width=1, chunk_rows=1 << 10, **kw)


class Ring:
    """Ring-graph neighbours on torch tensors (inline runs only)."""

    def __init__(self, n):
        self.n = n

    def __call__(self, idx):
        return torch.stack([(idx + 1) % self.n, (idx - 1) % self.n], 1)


# ================================================================ runtime

def test_inline_map_barrier_and_names(tmp_path):
    with ShardRuntime(str(tmp_path), 3, mode="inline") as rt:
        assert rt.map(TC._w_noop) == [0, 1, 2]
        assert rt.map(TC._w_noop, [(), (), ()]) == [0, 1, 2]
        rt.barrier()
        assert rt.next_name("x") == "x1" and rt.next_epoch() == 1
        assert rt.driver.shard == 3 and not rt.pipelined
    with pytest.raises(ValueError, match="loopback"):
        ShardRuntime(str(tmp_path), 2, mode="spawn", transport="loopback")
    with pytest.raises(ValueError, match="mailbox"):
        ShardRuntime(str(tmp_path), 2, mode="inline", wire_compress=True)


def test_fresh_runtime_sweeps_exchange_strays(tmp_path):
    wd = str(tmp_path)
    exch = os.path.join(wd, "exchange", "mystruct")
    stray = os.path.join(exch, "s000_d000.bin.tmp")
    sealed = os.path.join(exch, "e000001_s000_d000.bin")

    def plant():
        os.makedirs(exch, exist_ok=True)
        open(stray, "wb").write(b"\x00" * 16)
        open(sealed, "wb").write(np.zeros(2, np.int64).tobytes())
    plant()
    ShardRuntime(wd, 2, mode="inline", fresh=True)
    assert not os.path.exists(stray) and not os.path.exists(sealed)
    plant()
    tx.reset_stats()
    ShardRuntime(wd, 2, mode="inline", fresh=False)
    assert not os.path.exists(stray) and os.path.exists(sealed)
    assert tx.STATS["stray_files_swept"] == 1
    assert tx.STATS["stray_bytes_swept"] == 16


@pytest.mark.parametrize("wire", WIRES)
def test_sync_surfaces_exact_dropped_per_structure(tmp_path, wire):
    with ShardRuntime(str(tmp_path), 2, mode="inline", transport=wire) as rt:
        lst = ShardedDiskList(rt, width=1, capacity=2)
        big = ShardedDiskList(rt, width=1)
        bits = ShardedDiskBitArray(rt, 50, chunk_elems=16, capacity=3,
                                   device="cpu")
        rows = np.arange(64, dtype=np.uint32).reshape(-1, 1)
        owners = TB.hash_owner_np(rows, 2)
        lst.add(rows)
        big.add(rows)
        bits.update(np.arange(10), np.full(10, 2, np.uint8))
        want = sum(max(0, int((owners == d).sum()) - 2) for d in range(2))
        dropped = rt.sync()
        assert dropped == {lst.name: want, big.name: 0, bits.name: 7}
        assert lst.size() + want == 64 and big.size() == 64
        assert bits.count_values().tolist() == [47, 0, 3, 0]


# ===================================================== sharded structures

@pytest.mark.parametrize("nshards", SHARD_COUNTS)
def test_sharded_list_matches_single_process_and_reference(tmp_path,
                                                           nshards):
    rng = np.random.default_rng(3)
    a_rows = rng.integers(0, 40, (200, 2)).astype(np.uint32)
    b_rows = rng.integers(0, 40, (60, 2)).astype(np.uint32)
    got = {}
    for key, mod in (("ref", JC), ("port", TC)):
        with mod.ShardRuntime(str(tmp_path / key), nshards,
                              mode="inline") as rt:
            a = mod.ShardedDiskList(rt, width=2, chunk_rows=32)
            b = mod.ShardedDiskList(rt, width=2, chunk_rows=32)
            a.add(a_rows)
            b.add(b_rows)
            assert rt.sync() == {a.name: 0, b.name: 0}
            assert a.size() == 200 and b.size() == 60
            a.remove_dupes()
            a.remove_all(b)
            b.add_all(a)
            got[key] = (a.read_all(), b.read_all(), b.size())
            a.destroy()
            b.destroy()
    oa = DiskList(str(tmp_path / "oracle"), 2, 32)
    ob = DiskList(str(tmp_path / "oracle"), 2, 32)
    oa.add(a_rows)
    ob.add(b_rows)
    oa.remove_dupes()
    oa.remove_all(ob)
    assert np.array_equal(got["port"][0], tx.sort_rows(oa.read_all()))
    for x, y in zip(got["port"], got["ref"]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("nshards", SHARD_COUNTS)
def test_sharded_hash_table_matches_single_process_and_reference(
        tmp_path, nshards):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 50, (120, 1)).astype(np.uint32)
    vals = rng.integers(0, 1000, (120, 1)).astype(np.int64)
    q = np.arange(60, dtype=np.uint32).reshape(-1, 1)
    got = {}
    for key, mod in (("ref", JC), ("port", TC)):
        with mod.ShardRuntime(str(tmp_path / key), nshards,
                              mode="inline") as rt:
            ht = mod.ShardedDiskHashTable(rt, key_width=1, val_width=1,
                                          nbuckets=4)
            ht.insert(keys, vals)
            assert ht.sync() == 0
            ht.remove(keys[:10])
            ht.insert(keys[5:8], vals[5:8] + 1)
            assert ht.sync() == 0
            out, found = ht.lookup(q)
            items = sorted((tuple(k.tolist()), tuple(v.tolist()))
                           for k, v in ht.items())
            got[key] = (out.tolist(), found.tolist(), ht.size(), items)
    single = DiskHashTable(str(tmp_path / "single"), 1, 1, nbuckets=4)
    single.insert(keys, vals)
    single.sync()
    single.remove(keys[:10])
    single.insert(keys[5:8], vals[5:8] + 1)
    single.sync()
    out, found = single.lookup(q)
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (out.tolist(), found.tolist(), single.size())


@pytest.mark.parametrize("nshards", SHARD_COUNTS)
def test_sharded_bit_array_matches_single_process_and_reference(
        tmp_path, nshards):
    n = 101                                 # not divisible: a short shard
    rng = np.random.default_rng(5)
    idx = rng.integers(-5, n + 5, 300)      # out-of-range indices drop
    vals = rng.integers(0, 4, 300).astype(np.uint8)
    with JC.ShardRuntime(str(tmp_path / "ref"), nshards,
                         mode="inline") as rt:
        jb = JC.ShardedDiskBitArray(rt, n, chunk_elems=16)
        jb.update(idx, vals)
        assert jb.sync() == 0
        want = (jb.read_all(), jb.get(np.arange(n)), jb.count_values())
        jb.destroy()
    with ShardRuntime(str(tmp_path / "port"), nshards, mode="inline") as rt:
        sb = ShardedDiskBitArray(rt, n, chunk_elems=16, device="cpu")
        sb.update(torch.from_numpy(idx), torch.from_numpy(vals))
        assert sb.sync() == 0
        got = (sb.read_all(), sb.get(torch.arange(n)), sb.count_values())
        # a second epoch with a mark-first / apply-where-unseen pair
        sb.update([0, 1, 2], [1, 1, 1])
        assert sb.sync(combine=lambda p, q: p, apply=lambda old, agg:
                       torch.where(old == 0, agg, old)) == 0
        after = sb.read_all()
        sb.destroy()
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert np.array_equal(g.numpy(), w)
    single = TBA.DiskBitArray(str(tmp_path / "single"), n, chunk_elems=16,
                              device="cpu")
    single.update(idx, vals)
    single.sync()
    assert torch.equal(got[0], single.read_all())
    assert torch.equal(got[2], single.count_values())
    before = got[0][:3]
    assert after[:3].tolist() == [1 if v == 0 else int(v) for v in before]


def test_sharded_bit_array_get_rejects_out_of_range(tmp_path):
    with ShardRuntime(str(tmp_path), 2, mode="inline") as rt:
        sb = ShardedDiskBitArray(rt, 20, chunk_elems=8, device="cpu")
        with pytest.raises(AssertionError, match="out of range"):
            sb.get([20])
        assert sb.get([]).shape == (0,)


# ======================================================== BFS equivalence

@pytest.mark.parametrize("engine", ("sorted", "implicit"))
@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("nshards", SHARD_COUNTS)
def test_pancake5_levels_match_the_reference(tmp_path, engine, wire,
                                             exchange, nshards):
    run = run_sorted if engine == "sorted" else run_implicit
    sizes = {}
    for pkg in ("ref", "port"):
        got, handle = run(pkg, tmp_path / pkg, cluster=cfg(
            pkg, nshards=nshards, mode="inline", transport=wire,
            exchange=exchange))
        assert handle.dropped == 0
        if engine == "implicit" and pkg == "port":
            assert handle.count_values().tolist() == [0, 0, 0, 120]
        handle.destroy()
        sizes[pkg] = got
    assert sizes["port"] == sizes["ref"] == PANCAKE5


@pytest.mark.parametrize("nshards", (2, 4))
def test_implicit_levels_match_at_n6(tmp_path, nshards):
    sizes, bits = run_implicit("port", tmp_path, n=6, chunk_elems=256,
                               cluster=ClusterConfig(nshards=nshards,
                                                     mode="inline"))
    assert sizes == PANCAKE6
    assert torch.equal(bits.read_all(),
                       torch.full((720,), TBA.DONE, dtype=torch.uint8))
    bits.destroy()
    single, sb = run_implicit("port", tmp_path / "single", n=6,
                              chunk_elems=256)
    assert single == sizes


def _record(monkeypatch, mod, names, root, log):
    for name in names:
        orig = getattr(mod, name)

        def wrapped(ctx, *a, _orig=orig, **kw):
            out = _orig(ctx, *a, **kw)
            log.append((ctx.shard, files(root)))
            return out
        monkeypatch.setattr(mod, name, wrapped)


@pytest.mark.parametrize("engine", ("sorted", "implicit"))
@pytest.mark.parametrize("nshards", (2, 3))
def test_fs_barrier_workdirs_are_the_references(tmp_path, monkeypatch,
                                                engine, nshards):
    """After every shard's pass (implicit) or expand and absorb (sorted),
    the whole cluster directory — each shard's chunk files, op logs,
    sorted runs and the sealed bucket files on the fs wire — is the
    reference's, byte for byte."""
    names = (("_w_ibfs_pass",) if engine == "implicit"
             else ("_w_bfs_expand", "_w_bfs_absorb"))
    logs = {"ref": [], "port": []}
    _record(monkeypatch, JC, names, str(tmp_path / "ref"), logs["ref"])
    _record(monkeypatch, TC, names, str(tmp_path / "port"), logs["port"])
    for pkg in ("ref", "port"):
        kw = dict(cluster=cfg(pkg, nshards=nshards, mode="inline"))
        if engine == "implicit":
            got, h = run_implicit(pkg, tmp_path / pkg, n=6, chunk_elems=64,
                                  log_buf_rows=100, **kw)
        else:
            got, h = run_sorted(pkg, tmp_path / pkg, n=6, **kw)
        assert got == PANCAKE6
    assert len(logs["port"]) == len(logs["ref"]) > nshards * len(PANCAKE6)
    saw_bucket = False
    for k, (got, want) in enumerate(zip(logs["port"], logs["ref"])):
        assert got[0] == want[0]
        assert sorted(got[1]) == sorted(want[1]), k
        for fn in want[1]:
            assert got[1][fn] == want[1][fn], (k, fn)
            saw_bucket |= fn.startswith("cluster/exchange/")
    assert saw_bucket


def test_implicit_one_rw_pass_per_level_per_shard(tmp_path):
    n_states, nshards = 256, 2
    TBA.reset_stats()
    tx.reset_stats()
    sizes, bits = TD.implicit_bfs(str(tmp_path), n_states, [0],
                                  Ring(n_states), chunk_elems=64,
                                  device="cpu",
                                  cluster=ClusterConfig(nshards=nshards,
                                                        mode="inline"))
    assert sum(sizes) == n_states
    passes = len(sizes) + 1
    assert TBA.STATS["sync_passes"] == nshards * passes
    assert TBA.STATS["scan_passes"] == 0
    assert tx.STATS["rw_passes"] + tx.STATS["read_passes"] == \
        nshards * passes
    assert tx.STATS["sort_passes"] == 0
    per_shard_bytes = (n_states // nshards) // 4
    arr_read = TBA.STATS["bytes_read"] - TBA.STATS["log_bytes_read"]
    arr_written = TBA.STATS["bytes_written"] - TBA.STATS["log_bytes_written"]
    assert arr_read == arr_written == \
        nshards * (passes - 1) * per_shard_bytes + 16
    bits.destroy()


def test_sorted_no_extra_sorts_per_shard(tmp_path):
    tx.reset_stats()
    want, vis = run_sorted("port", tmp_path / "single")
    vis.destroy()
    single = dict(tx.STATS)
    levels = len(want) - 1
    for nshards in (2, 4):
        tx.reset_stats()
        sizes, vis = run_sorted("port", tmp_path / f"s{nshards}",
                                cluster=ClusterConfig(nshards=nshards,
                                                      mode="inline"))
        vis.destroy()
        assert sizes == want == PANCAKE5
        assert tx.STATS["rows_sorted"] == single["rows_sorted"]
        assert tx.STATS["sort_passes"] <= nshards * (levels + 2)
        assert tx.STATS["sort_passes"] >= single["sort_passes"]


@pytest.mark.parametrize("engine", ("sorted", "implicit"))
def test_pipelined_budgets_match_barrier_baseline(tmp_path, engine):
    """The threaded pipelined map books the same work as the barrier
    discipline: rows sorted, pass ledgers and bit-array counters."""
    run = run_sorted if engine == "sorted" else run_implicit
    got = {}
    for ex in EXCHANGES:
        tx.reset_stats()
        TBA.reset_stats()
        sizes, h = run("port", tmp_path / ex, cluster=ClusterConfig(
            nshards=4, mode="inline", exchange=ex))
        h.destroy()
        assert sizes == PANCAKE5
        got[ex] = (dict(tx.STATS), dict(TBA.STATS))
    assert got["pipelined"] == got["barrier"]


def test_threaded_shards_keep_the_counters_exact(tmp_path):
    """The pipelined inline map runs a thread a shard; with a switch
    interval of a microsecond, eight shard threads bump the shared
    counters (``bits``, ``extsort``, ``transport``) as often as the
    one-at-a-time barrier run does, to the count."""
    def counts(ex, k):
        for d in (TBA.STATS, tx.STATS, TB.TRANSPORT_STATS):
            for key in d:
                d[key] = 0
        sizes, bits = TD.implicit_bfs(
            str(tmp_path / f"{ex}{k}"), 720, [P.start_rank(6)],
            P.neighbors(6), chunk_elems=16, expand_batch=8, log_buf_rows=4,
            device="cpu", cluster=ClusterConfig(
                nshards=8, mode="inline", exchange=ex,
                transport="loopback"))
        bits.destroy()
        assert sizes == PANCAKE6
        return dict(TBA.STATS), dict(tx.STATS), dict(TB.TRANSPORT_STATS)

    want = counts("barrier", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k in range(3):
            assert counts("pipelined", k) == want
    finally:
        sys.setswitchinterval(old)


# ============================================================ abort safety

def test_killed_worker_leaves_only_ignorable_tmp(tmp_path):
    wd = str(tmp_path)
    rt = ShardRuntime(wd, 2, mode="inline")
    lst = ShardedDiskList(rt, width=1, name="surv")
    lst.add(np.array([[1], [2], [3]], np.uint32))
    rt.driver.writer(lst.spec)._spill()     # spilled, never sealed
    exch = rt.driver.exchange_dir("surv")
    assert any(f.endswith(".tmp") for f in os.listdir(exch))
    rt2 = ShardRuntime(wd, 2, mode="inline", fresh=False)
    assert not any(f.endswith(".tmp") for f in os.listdir(exch))
    lst2 = ShardedDiskList(rt2, width=1, name="surv2")
    lst2.add(np.array([[9]], np.uint32))
    assert lst2.sync() == 0
    assert lst2.read_all().reshape(-1).tolist() == [9]


def test_pass_snapshot_readoption_inside_a_shard(tmp_path):
    rt = ShardRuntime(str(tmp_path), 2, mode="inline")
    sb = ShardedDiskBitArray(rt, 64, name="bits", chunk_elems=16,
                             device="cpu")
    local = rt._inline_ctxs[0].objects["bits"]
    with open(local._log_path(0) + ".pass", "wb") as f:
        f.write(np.array([[3, 1]], np.int64).tobytes())
    exch = rt.driver.exchange_dir("bits")
    os.makedirs(exch, exist_ok=True)
    with open(os.path.join(exch, "s001_d000.bin.tmp"), "wb") as f:
        f.write(np.array([[5, 3]], np.int64).tobytes())
    sb.update([40], [2])
    assert sb.sync() == 0
    assert sb.get([3, 40, 5]).tolist() == [1, 2, 0]     # stray not applied
    sb.destroy()
    assert not os.path.exists(exch)


def test_bfs_runtime_dir_is_clean_after_search(tmp_path):
    sizes, vis = run_sorted("port", tmp_path, n=4,
                            cluster=ClusterConfig(nshards=2, mode="inline"))
    assert sum(sizes) == 24
    vis.destroy()
    leftovers = [f for _d, _s, fs in os.walk(tmp_path / "cluster" /
                                             "exchange")
                 for f in fs if f.endswith((".bin", ".tmp"))]
    assert leftovers == []


def failing_pass(n, level):
    """Pancake ``n``'s neighbours, failing as a kernel launch does in the
    chunk pass that expands ``level``."""
    dist = P.ram_distances(n, device="cpu")
    return FailOn(P.neighbors(n), torch.nonzero(dist == level).flatten())


def test_inline_kill_recovers_and_kernel_faults_surface(tmp_path,
                                                        monkeypatch):
    """A killed shard (inline: a ``WorkerKilled`` raise) rolls back to the
    last coordinated checkpoint and heals to the exact level sizes; a
    chunk pass that cannot launch its kernel (``impl="cuda"`` on the CPU,
    or a launch failure at level 3, with levels 0-2 checkpointed) is
    neither healed nor moved to a plain version: its error reaches the
    caller as it was raised, with no recovery."""
    monkeypatch.setenv(tfaults.ENV_VAR, "worker_level:kill:shard=1:level=3")
    tx.reset_stats()
    try:
        sizes, bits = run_implicit(
            "port", tmp_path / "kill", n=6, chunk_elems=64,
            cluster=ClusterConfig(nshards=2, mode="inline"),
            checkpoint=CheckpointConfig(dir=str(tmp_path / "ck1")),
            recovery=RecoveryConfig(max_recoveries=1))
    finally:
        tfaults.uninstall()
    monkeypatch.delenv(tfaults.ENV_VAR)
    assert sizes == PANCAKE6
    assert tx.STATS["recoveries"] == 1
    bits.destroy()
    tx.reset_stats()
    for ex in EXCHANGES:
        with pytest.raises(ValueError, match="impl='cuda' needs a CUDA"):
            TD.implicit_bfs(str(tmp_path / ex), 720, [P.start_rank(6)],
                            P.neighbors(6), chunk_elems=64, device="cpu",
                            impl="cuda",
                            cluster=ClusterConfig(nshards=2, mode="inline",
                                                  exchange=ex),
                            checkpoint=CheckpointConfig(
                                dir=str(tmp_path / f"ck_{ex}")),
                            recovery=RecoveryConfig(max_recoveries=1))
        ck = tmp_path / f"ck3_{ex}"
        with pytest.raises(RuntimeError, match="CUDA error 719") as ei:
            TD.implicit_bfs(str(tmp_path / f"l3_{ex}"), 720, [P.start_rank(6)],
                            failing_pass(6, 3), chunk_elems=64,
                            device="cpu",
                            cluster=ClusterConfig(nshards=2, mode="inline",
                                                  exchange=ex),
                            checkpoint=CheckpointConfig(dir=str(ck)),
                            recovery=RecoveryConfig(max_recoveries=1))
        assert not isinstance(ei.value, ShardFailure)
        assert TC.SearchCheckpoint(str(ck)).latest()["level_sizes"] \
            == PANCAKE6[:3]
    assert tx.STATS["recoveries"] == 0


# ============================================ checkpoints across packages

@pytest.mark.parametrize("engine", ("sorted", "implicit"))
@pytest.mark.parametrize("writer", ("ref", "port"))
def test_sharded_checkpoint_crosses_packages(tmp_path, engine, writer):
    reader = "port" if writer == "ref" else "ref"
    run = run_sorted if engine == "sorted" else run_implicit
    kw = dict(n=6) if engine == "sorted" else dict(n=6, chunk_elems=64)
    ck = str(tmp_path / "ck")
    ckcls = {"ref": jconfig.CheckpointConfig, "port": CheckpointConfig}
    part, h = run(writer, tmp_path / "w1", max_levels=3,
                  cluster=cfg(writer, nshards=2, mode="inline"),
                  checkpoint=ckcls[writer](dir=ck), **kw)
    assert part == PANCAKE6[:len(part)] and len(part) < len(PANCAKE6)
    h.destroy()
    sizes, h = run(reader, tmp_path / "w2",
                   cluster=cfg(reader, nshards=2, mode="inline"),
                   checkpoint=ckcls[reader](dir=ck, resume=True), **kw)
    assert sizes == PANCAKE6
    if engine == "implicit":
        done = h.count_values()
        assert list(np.asarray(done)) == [0, 0, 0, 720]
    h.destroy()


def test_sharded_checkpoint_refuses_another_shard_count(tmp_path):
    ck = str(tmp_path / "ck")
    run_implicit("port", tmp_path / "w1", n=5, max_levels=2,
                 cluster=ClusterConfig(nshards=2, mode="inline"),
                 checkpoint=CheckpointConfig(dir=ck))
    with pytest.raises(Exception, match="nshards"):
        run_implicit("port", tmp_path / "w2", n=5,
                     cluster=ClusterConfig(nshards=4, mode="inline"),
                     checkpoint=CheckpointConfig(dir=ck, resume=True))


# ================================================================ spawn

@pytest.fixture(scope="module")
def spawn_rt(tmp_path_factory):
    rt = ShardRuntime(str(tmp_path_factory.mktemp("spawn")), 2,
                      mode="spawn", timeout=TIMEOUT)
    yield rt
    rt.shutdown()


def test_spawn_list_and_worker_stats(spawn_rt):
    lst = ShardedDiskList(spawn_rt, width=1)
    lst.add(np.arange(32, dtype=np.uint32).reshape(-1, 1))
    assert lst.sync() == 0
    assert lst.size() == 32
    assert lst.read_all().reshape(-1).tolist() == list(range(32))
    stats = spawn_rt.bcast(TC._w_get_stats)
    assert len(stats) == 2
    for s in stats:
        assert {"extsort", "bits", "kernels", "bitpack_route"} <= set(s)
        assert s["kernels"]["mark_rotate_count"] == 0   # plain on the CPU
    lst.destroy()


def test_spawn_worker_error_propagates(spawn_rt, tmp_path):
    with pytest.raises(RuntimeError, match="KeyError"):
        spawn_rt.bcast(TC._w_list_size, "no-such-structure")
    assert spawn_rt.map(TC._w_noop) == [0, 1]           # still usable
    # a worker's chunk pass that cannot launch its kernel, at the seed
    # pass or at level 3 with levels 0-2 checkpointed and a recovery to
    # spend: the search fails with the worker's error, healed by nothing
    tx.reset_stats()
    for what, gen, impl in (("impl='cuda' needs a CUDA tensor",
                             P.neighbors(5), "cuda"),
                            ("CUDA error 719", failing_pass(5, 3), "auto")):
        ck = tmp_path / f"ck_{impl}"
        with pytest.raises(RuntimeError,
                           match="worker failure in _w_ibfs_pass") as ei:
            TD.implicit_bfs(str(tmp_path / impl), 120, [P.start_rank(5)],
                            gen, chunk_elems=32, device="cpu", impl=impl,
                            cluster=ClusterConfig(runtime=spawn_rt),
                            checkpoint=CheckpointConfig(dir=str(ck)),
                            recovery=RecoveryConfig(max_recoveries=1))
        assert type(ei.value) is RuntimeError and what in str(ei.value)
        assert spawn_rt.map(TC._w_noop) == [0, 1]
    assert TC.SearchCheckpoint(str(ck)).latest()["level_sizes"] \
        == PANCAKE5[:3]
    assert tx.STATS["recoveries"] == 0


def test_spawn_bit_array_returns_host_copies(spawn_rt):
    sb = ShardedDiskBitArray(spawn_rt, 40, chunk_elems=8, device="cpu")
    sb.update(np.arange(0, 40, 3), np.full(14, 3, np.uint8))
    assert sb.sync() == 0
    assert sb.count_values().tolist() == [26, 0, 0, 14]
    assert sb.get([0, 1, 39]).tolist() == [3, 0, 3]
    assert int(sb.read_all().sum()) == 42
    sb.destroy()


def test_spawn_implicit_budget_per_worker(tmp_path):
    with ShardRuntime(str(tmp_path), 2, mode="spawn",
                      timeout=TIMEOUT) as rt:
        TBA.reset_stats()
        sizes, bits = run_implicit("port", tmp_path / "w", n=6,
                                   chunk_elems=128,
                                   cluster=ClusterConfig(runtime=rt))
        assert sizes == PANCAKE6
        passes = len(sizes) + 1
        stats = rt.bcast(TC._w_get_stats)
        for s in stats:
            assert s["bits"]["sync_passes"] == passes
            assert s["bits"]["scan_passes"] == 0
            assert s["extsort"]["sort_passes"] == 0
        # the workers' counters reach the coordinator's registry
        assert TBA.STATS["sync_passes"] == 2 * passes
        assert TBA.STATS["ops_applied"] == sum(s["bits"]["ops_applied"]
                                               for s in stats)
        assert bits.count_values().tolist() == [0, 0, 0, 720]
        bits.destroy()


def test_spawn_tcp_pipelined_sorted(tmp_path):
    sizes, vis = run_sorted("port", tmp_path, n=6, cluster=ClusterConfig(
        nshards=2, transport="tcp", exchange="pipelined", timeout=TIMEOUT))
    assert sizes == PANCAKE6
    assert vis.size() == 720
    vis.destroy()


def test_spawn_worker_kill_heals(tmp_path, monkeypatch):
    """A worker really exits (``os._exit``) at level 2; the coordinator
    sees it lost, respawns the pool, re-adopts the level checkpoint and
    replays to the exact level sizes."""
    monkeypatch.setenv(tfaults.ENV_VAR, "worker_level:kill:shard=1:level=2")
    tx.reset_stats()
    try:
        sizes, bits = run_implicit(
            "port", tmp_path / "w", n=6, chunk_elems=128,
            cluster=ClusterConfig(nshards=2, timeout=TIMEOUT),
            checkpoint=CheckpointConfig(dir=str(tmp_path / "ck")),
            recovery=RecoveryConfig(max_recoveries=1))
    finally:
        tfaults.uninstall()
    assert sizes == PANCAKE6
    assert tx.STATS["recoveries"] == 1
    assert tx.STATS["replayed_levels"] >= 1
    bits.destroy()
