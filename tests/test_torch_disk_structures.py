"""Port parity: Tier D's host structures — the owner maps, the external
sort (``extsort``), the run set (``lsm``), ``DiskList``, ``DiskArray``,
``DiskHashTable``, the pass planner and the config checker —
``repro_torch.core.disk`` against ``repro.core.disk``.

Tolerance: none; these move bytes and integers.  The same seeded calls
go through both packages, each in its own directory, and leave the same
files, byte for byte (``DiskHashTable``'s ``.npz`` buckets, whose zip
headers carry a timestamp, by their arrays), the same results and the
same ``extsort`` counters.  Mirrors ``tests/test_disk_tier.py``,
``test_sort_once.py`` and ``test_passes.py``.  Inputs come from
``np.random.default_rng``.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.disk import buckets as jbuckets
from repro.core.disk import darray as jdarray
from repro.core.disk import dhash as jdhash
from repro.core.disk import dlist as jdlist
from repro.core.disk import extsort as jx
from repro.core.disk import lsm as jlsm
from repro.core.disk import passes as jpasses
from repro.core.disk import store as jstore
from repro_torch.core.disk import buckets as tbuckets
from repro_torch.core.disk import config as tconfig
from repro_torch.core.disk import darray as tdarray
from repro_torch.core.disk import dhash as tdhash
from repro_torch.core.disk import dlist as tdlist
from repro_torch.core.disk import extsort as tx
from repro_torch.core.disk import lsm as tlsm
from repro_torch.core.disk import passes as tpasses
from repro_torch.core.disk import store as tstore
from repro_torch.kernels.bitpack import make_lut

PKGS = {"ref": (jstore, jx, jlsm, jdlist, jdarray, jdhash),
        "port": (tstore, tx, tlsm, tdlist, tdarray, tdhash)}


def files(path):
    """Every file under ``path``: relative path → bytes."""
    out = {}
    for root, _, names in os.walk(path):
        for fn in names:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def assert_same_tree(a, b):
    fa, fb = files(a), files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k] == fb[k], k


def rows(rng, n, width=2, hi=50):
    return rng.integers(0, hi, (n, width)).astype(np.uint32)


def both(tmp_path, fn):
    """Run ``fn(mods, workdir)`` for each package; returns {key: result}
    with the extsort counters of each run beside it."""
    out = {}
    for key, mods in PKGS.items():
        mods[1].reset_stats()
        wd = str(tmp_path / key)
        os.makedirs(wd, exist_ok=True)
        res = fn(mods, wd)
        out[key] = (res, {k: v for k, v in mods[1].STATS.items() if v})
    assert out["ref"][1] == out["port"][1]
    return out["ref"][0], out["port"][0]


# ------------------------------------------------------------ owner maps

@pytest.mark.parametrize("width", [1, 2, 3])
def test_owner_maps_are_the_reference(width):
    rng = np.random.default_rng(width)
    r = rng.integers(0, 1 << 32, (500, width), dtype=np.uint64).astype(
        np.uint32)
    assert np.array_equal(tbuckets.hash_rows_np(r), jbuckets.hash_rows_np(r))
    for ns in (1, 2, 3, 8):
        assert np.array_equal(tbuckets.hash_owner_np(r, ns),
                              jbuckets.hash_owner_np(r, ns))
        idx = rng.integers(0, 10 ** 6, 300)
        assert np.array_equal(tbuckets.block_owner_np(idx, 10 ** 6, ns),
                              jbuckets.block_owner_np(idx, 10 ** 6, ns))
        assert tbuckets.block_owner(idx, 10 ** 6, ns).numpy().tolist() == \
            jbuckets.block_owner_np(idx, 10 ** 6, ns).tolist()


# --------------------------------------------------------------- extsort

@pytest.mark.parametrize("width", [1, 2, 3])
def test_sort_rows_and_segment_combine(width):
    rng = np.random.default_rng(7)
    r = rows(rng, 400, width, hi=5)
    assert np.array_equal(tx.sort_rows(r), jx.sort_rows(r))
    ids = np.sort(rng.integers(0, 40, 300))
    vals = rng.integers(0, 100, 300)
    for comb in (np.add, np.maximum, lambda p, q: p, lambda p, q: q):
        got = tx.segment_combine_ordered(ids, vals, comb)
        want = jx.segment_combine_ordered(ids, vals, comb)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


SORT_CASES = [  # n rows, width, chunk rows, run rows, dedupe, codec
    (3000, 1, 128, 500, True, None),
    (3000, 2, 100, 256, False, None),
    (2000, 2, 300, 700, True, "keys"),
    (1500, 3, 64, 200, True, None),
    (0, 2, 64, 128, True, None),
    (777, 1, 1000, 10000, False, "keys"),
]


@pytest.mark.parametrize("case", SORT_CASES)
def test_external_sort_trees(tmp_path, case):
    n, width, chunk, run_rows, dedupe, codec = case
    data = rows(np.random.default_rng(n + width), n, width, hi=60)

    def go(mods, wd):
        S, X = mods[0], mods[1]
        src = S.ChunkStore(f"{wd}/src", width, chunk_rows=chunk, fresh=True,
                           codec=None)
        src.append(data)
        src.flush()
        out = S.ChunkStore(f"{wd}/out", width, chunk_rows=chunk, fresh=True,
                           codec=codec)
        X.external_sort(src, out, f"{wd}/tmp", run_rows=run_rows,
                        dedupe=dedupe)
        # the sorted input skips the sort: a copy, or one dedupe pass
        again = S.ChunkStore(f"{wd}/again", width, chunk_rows=chunk,
                             fresh=True)
        X.external_sort(out, again, f"{wd}/tmp2", run_rows=run_rows,
                        dedupe=True)
        return out.read_all(), again.read_all()

    (ro, ra), (po, pa) = both(tmp_path, go)
    assert np.array_equal(ro, po) and np.array_equal(ra, pa)
    assert_same_tree(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("compressed", [False, True])
def test_merge_difference_and_probe(tmp_path, compressed):
    rng = np.random.default_rng(3)
    a = jx.sort_rows(rows(rng, 4000, 1, hi=20000))
    b = jx.sort_rows(np.unique(rows(rng, 3000, 1, hi=20000), axis=0))
    codec = "keys" if compressed else None

    def go(mods, wd):
        S, X = mods[0], mods[1]
        sa = S.ChunkStore(f"{wd}/a", 1, chunk_rows=256, fresh=True)
        sa.append(a)
        sa.flush(mark_sorted=True)
        sb = S.ChunkStore(f"{wd}/b", 1, chunk_rows=200, fresh=True,
                          codec=codec)
        sb.append(b)
        sb.flush(mark_sorted=True)
        out = S.ChunkStore(f"{wd}/d", 1, chunk_rows=256, fresh=True)
        X.merge_difference(sa, sb, out)
        probe = X.MembershipProbe(sb)
        keys = jstore.row_keys(a[(a[:, 0] > 5000) & (a[:, 0] < 9000)])
        hits = [probe.contains(keys[i:i + 100])
                for i in range(0, keys.shape[0], 100)]
        return out.read_all(), np.concatenate(hits)

    (rd, rh), (pd, ph) = both(tmp_path, go)
    assert np.array_equal(rd, pd) and np.array_equal(rh, ph)
    assert_same_tree(tmp_path / "ref", tmp_path / "port")


def test_iter_merged_blocks_and_run_builder(tmp_path):
    rng = np.random.default_rng(11)
    data = rows(rng, 5000, 2, hi=40)

    def go(mods, wd):
        S, X = mods[0], mods[1]
        b = X.RunBuilder(f"{wd}/tmp", 2, chunk_rows=128, run_rows=700)
        for part in np.array_split(data, 9):
            b.add(part)
        runs = b.finish()
        blocks = [blk for blk in X.iter_merged(runs, dedupe=True)]
        out = S.ChunkStore(f"{wd}/m", 2, chunk_rows=128, fresh=True)
        X.merge_runs(runs, out, dedupe=False)
        return [x.tolist() for x in blocks], out.read_all()

    (rb, rm), (pb, pm) = both(tmp_path, go)
    assert rb == pb and np.array_equal(rm, pm)
    assert_same_tree(tmp_path / "ref", tmp_path / "port")


# ---------------------------------------------------------- SortedRunSet

@pytest.mark.parametrize("policy", ["full", "tiered"])
def test_sorted_run_set(tmp_path, policy):
    rng = np.random.default_rng(5)
    levels = [np.unique(rows(rng, int(rng.integers(10, 400)), 1, hi=3000),
                        axis=0) for _ in range(7)]

    def go(mods, wd):
        S, X, L = mods[0], mods[1], mods[2]
        rs = L.SortedRunSet(wd, 1, chunk_rows=64, max_runs=3, name="rs",
                            policy=policy)
        compacted = []
        for i, lev in enumerate(levels):
            st = S.ChunkStore(f"{wd}/lev{i}", 1, chunk_rows=64, fresh=True)
            st.append(lev)
            st.flush(mark_sorted=True)
            rs.add_run(st)
            compacted.append(rs.maybe_compact())
        return compacted, rs.size(), rs.read_all()

    (rc, rn, ra), (pc, pn, pa) = both(tmp_path, go)
    assert rc == pc and rn == pn and np.array_equal(ra, pa)
    assert_same_tree(tmp_path / "ref", tmp_path / "port")


# -------------------------------------------------------------- DiskList

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_disk_list_ops(tmp_path, seed):
    rng = np.random.default_rng(seed)
    a, b, c = rows(rng, 900, 2, 25), rows(rng, 300, 2, 25), rows(rng, 40, 2)

    def go(mods, wd):
        DL = mods[3].DiskList
        A = DL(wd, 2, chunk_rows=64, name="A")
        B = DL(wd, 2, chunk_rows=64, name="B")
        A.add(a)
        B.add(b)
        out = {"sizes": [A.size(), B.size()]}
        A.remove_dupes(run_rows=128)
        out["dedup"] = A.read_all()
        B.remove_all(A, run_rows=128)
        out["diff"] = B.read_all()
        A.remove(c)
        A.add_all(B)
        seen = []
        A.map_chunks(lambda ch: seen.append(ch.shape[0]))
        out["chunks"] = seen
        out["sum"] = A.reduce(lambda ch: int(ch.astype(np.int64).sum()),
                              lambda x, y: x + y, 0)
        out["pcount"] = A.predicate_count(lambda ch: ch[:, 0] > 10)
        out["all"] = A.read_all()
        out["files"] = files(A.store.path)
        return out

    r, p = both(tmp_path, go)
    for k in r:
        if k == "files":
            assert r[k] == p[k]
        else:
            assert np.array_equal(np.asarray(r[k]), np.asarray(p[k])), k


# ------------------------------------------------------------- DiskArray

def test_disk_array_chain_reduction_and_streams(tmp_path):
    def go(mods, wd):
        DA = mods[4].DiskArray
        da = DA(wd, n=200, width=1, chunk_rows=16, name="a")
        da.write_all(np.arange(200, dtype=np.int64)[:, None])
        vals = da.read_all()
        da.update(np.arange(1, 200), vals[:-1])
        da.sync(combine=lambda p, q: p + q, apply=lambda o, x: o + x)
        da.update(np.array([3, 3, 7, 3]),
                  np.array([[1], [2], [5], [4]], np.int64))
        da.sync(combine=lambda p, q: p + q, apply=lambda o, x: o + x)
        da.map_update(lambda s, ch: ch * 2 + s)
        seen = []
        da.map_chunks(lambda s, ch: seen.append((s, int(ch.sum()))))
        red = da.reduce(lambda ch: int(ch.max()), max, 0)
        return da.read_all(), seen, red

    (ra, rs, rr), (pa, ps, pr) = both(tmp_path, go)
    assert np.array_equal(ra, pa) and rs == ps and rr == pr
    assert_same_tree(tmp_path / "ref", tmp_path / "port")


# --------------------------------------------------------- DiskHashTable

def npz_tree(path):
    out = {}
    for fn in sorted(os.listdir(path)):
        z = np.load(os.path.join(path, fn))
        out[fn] = {k: z[k].tolist() for k in sorted(z.files)}
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_disk_hash_table_rounds(tmp_path, seed):
    rng = np.random.default_rng(seed)
    rounds = [(rng.integers(0, 60, (150, 2)).astype(np.uint32),
               rng.integers(0, 100, (150, 1)).astype(np.int64),
               rng.integers(0, 60, (30, 2)).astype(np.uint32))
              for _ in range(3)]
    queries = rng.integers(0, 60, (200, 2)).astype(np.uint32)

    def go(mods, wd):
        ht = mods[5].DiskHashTable(wd, key_width=2, val_width=1, nbuckets=8,
                                   name="h")
        for keys, vals, rm in rounds:
            ht.insert(keys, vals)
            ht.remove(rm)
            ht.insert(keys[:20], vals[:20])
            ht.sync(combine=lambda a, b: a + b,
                    apply=lambda o, a, p: np.where(p[:, None], o + a, a))
        v, f = ht.lookup(queries)
        items = [(k.tolist(), x.tolist()) for k, x in ht.items()]
        return v, f, ht.size(), items, npz_tree(ht.path)

    r, p = both(tmp_path, go)
    for g, w in zip(p, r):
        if isinstance(g, np.ndarray):
            assert np.array_equal(g, w)
        else:
            assert g == w


OP_ORDER = [  # (ops before the first sync, ops of the second window, want)
    ([("put", 7, 1)], [("del", 7), ("put", 7, 5)], (True, 5, 1)),
    ([("put", 7, 1)], [("put", 7, 9), ("del", 7)], (False, 0, 0)),
    ([("put", 3, 100)], [("del", 3), ("put", 3, 2), ("put", 3, 3)],
     (True, 5, 1)),
    ([], [("del", 42)], (False, 0, 0)),
]


@pytest.mark.parametrize("case", OP_ORDER)
def test_disk_hash_table_op_order(tmp_path, case):
    """``TestDiskHashTableOpOrder``'s rules: DEL then PUT resurrects, PUT
    then DEL removes, PUTs after a DEL combine fresh, a DEL of an absent
    key is a no-op."""
    first, second, want = case

    def go(mods, wd):
        ht = mods[5].DiskHashTable(wd, 1, 1, nbuckets=4, name="h")

        def run(ops):
            for op in ops:
                key = np.array([[op[1]]], np.uint32)
                if op[0] == "put":
                    ht.insert(key, np.array([[op[2]]], np.int64))
                else:
                    ht.remove(key)
            ht.sync(combine=lambda a, b: a + b,
                    apply=lambda o, a, p: np.where(p[:, None], o + a, a))
        run(first)
        run(second)
        key = (second or first)[0][1]
        v, f = ht.lookup(np.array([[key]], np.uint32))
        return bool(f[0]), int(v[0, 0]) if f[0] else 0, ht.size()

    r, p = both(tmp_path, go)
    assert r == p == want


# ------------------------------------------------------------ the planner

def test_pass_plan_stage_order_and_ledger():
    seen = []
    lut = [2, 0, 3, 2]
    plan = (tpasses.PassPlan("p")
            .writes(lambda s, v: v + 1)
            .reads(lambda s, v: seen.append(("r1", s, v.tolist())))
            .rotates(make_lut(lut))
            .counts(2, lambda s, n: seen.append(("c", s, n)))
            .writes(lambda s, v: v * 1))
    out = plan.apply_chunk(32, torch.tensor([1, 2, 0], dtype=torch.uint8))
    assert seen[0] == ("r1", 32, [2, 3, 1])
    assert seen[1] == ("c", 32, sum(lut[x] == 2 for x in (2, 3, 1)))
    assert out.tolist() == [lut[x] for x in (2, 3, 1)]
    assert plan.writes_chunks and plan.forces_full_traversal
    assert plan.n_stages == 5
    read_only = tpasses.PassPlan().reads(lambda s, v: None).counts(
        1, lambda s, n: None)
    assert not read_only.writes_chunks and read_only.forces_full_traversal
    assert tpasses.PassPlan().n_stages == 0
    assert not tpasses.PassPlan("x", dirty_only=True).reads(
        lambda s, v: None).forces_full_traversal
    for mods in (jx, tx):
        mods.reset_stats()
    for rp in (jpasses.record_pass, tpasses.record_pass):
        rp(3, writes=True)
        rp(1, writes=False)
    assert {k: v for k, v in jx.STATS.items() if v} == \
        {k: v for k, v in tx.STATS.items() if v}
    assert tx.STATS["rw_passes"] == 1 and tx.STATS["read_passes"] == 1
    assert tx.STATS["piggybacked_stages"] == 2


def test_pass_plan_packed_head():
    f = lambda s, n: None                                  # noqa: E731
    h, used, counted = tpasses.PassPlan().rotates(5).counts(1, f).reads(
        f).packed_head()
    assert (h.lut, used, counted.count) == (5, 2, 1)
    h, used, counted = tpasses.PassPlan().rotates(5, 2, f).counts(
        1, f).packed_head()
    assert (used, counted.count) == (1, 2)
    assert tpasses.PassPlan().reads(f).rotates(5).packed_head() == \
        (None, 0, None)
    with pytest.raises(ValueError):
        tpasses.PassPlan().rotates(300)
    with pytest.raises(ValueError):
        tpasses.PassPlan().rotates(5, count=1)


# ---------------------------------------------------------------- config

def test_config_errors(tmp_path):
    """``resolve_configs`` validates as the reference's does
    (``tests/test_transport.py::TestConfigValidation``): the same
    accepted configs and the same errors, word for word; a sharded
    config is accepted and builds a runtime."""
    from repro.core.disk import config as jconfig
    from repro_torch.core.disk.cluster import ShardRuntime
    CC, KC, RC = (tconfig.ClusterConfig, tconfig.CheckpointConfig,
                  tconfig.RecoveryConfig)
    ok = tconfig.resolve_configs("e", recovery=RC(max_recoveries=8))
    assert ok[2].max_recoveries == 8 and not ok[0].sharded
    for kw in ({"nshards": 2}, {"transport": "tcp"},
               {"exchange": "barrier"}, {"transport": "loopback",
                                          "mode": "inline"}):
        cl = tconfig.resolve_configs("e", cluster=CC(**kw))[0]
        assert cl.sharded and cl.sharded == jconfig.ClusterConfig(
            **kw).sharded
    assert CC().resolved_exchange() == "barrier"
    assert CC(exchange="pipelined").resolved_exchange() == "pipelined"
    rt, own = CC(nshards=2, mode="inline").build_runtime(str(tmp_path))
    assert own and rt.nshards == 2 and rt.root == str(tmp_path / "cluster")
    assert CC(runtime=rt).build_runtime("/nonexistent") == (rt, False)
    rt.shutdown()
    cases = [({"cluster": ("transport", "udp")},),
             ({"cluster": ("nshards", 0)},), ({"cluster": ("mode", "x")},),
             ({"cluster": ("exchange", "vibes")},),
             ({"cluster": ("wire_compress", True)},),
             ({"cluster": ("transport", "loopback")},),
             ({"checkpoint": ("every", 0)},),
             ({"checkpoint": ("resume", True)},),
             ({"recovery": ("max_recoveries", -1)},)]
    for (spec,) in cases:
        msgs = []
        for mod in (tconfig, jconfig):
            (what, (field, value)), = spec.items()
            cls = {"cluster": mod.ClusterConfig,
                   "checkpoint": mod.CheckpointConfig,
                   "recovery": mod.RecoveryConfig}[what]
            with pytest.raises(ValueError) as ei:
                mod.resolve_configs("e", **{what: cls(**{field: value})})
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], spec
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="fused"):
            mod.resolve_configs("e", checkpoint=mod.CheckpointConfig(
                dir="x"), fused=False)
        with pytest.raises(ValueError, match="fused=False"):
            mod.resolve_configs("e", cluster=mod.ClusterConfig(nshards=2),
                                fused=False)
    with ShardRuntime(str(tmp_path / "a"), 2, mode="inline") as rt:
        with pytest.raises(ValueError, match="nshards=4 was also passed"):
            tconfig.resolve_configs("e", cluster=CC(runtime=rt, nshards=4))
        tconfig.resolve_configs("e", cluster=CC(runtime=rt, nshards=2))
    with ShardRuntime(str(tmp_path / "b"), 2, mode="inline",
                      transport="loopback") as rt:
        with pytest.raises(ValueError, match="brings its own wire"):
            tconfig.resolve_configs("e", cluster=CC(runtime=rt,
                                                    transport="tcp"))
    assert not hasattr(tconfig, "SHARDED_MISSING")


def test_extsort_counters_are_the_fault_layers():
    """``faults`` registers ``io_retries`` / ``io_giveups`` in the extsort
    namespace; the ported ``extsort.STATS`` is that same live dict."""
    from repro_torch.core.disk import faults as tfaults
    assert tx.STATS is tfaults.STATS
    assert {"sort_passes", "rw_passes", "piggybacked_stages", "io_retries",
            "io_giveups", "ckpt_bytes_written"} <= set(tx.STATS)
    tx.reset_stats()
    tfaults.STATS["io_retries"] += 2
    assert tx.STATS["io_retries"] == 2
    tx.reset_stats()
    assert tfaults.STATS["io_retries"] == 0
