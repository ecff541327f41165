"""Port parity: the distance-oracle serving tier of ``repro_torch`` (labels
on the device, publish, LRU chunk cache, batched lookup through K4's plain
version, greedy descent, sharded front) against ``repro.core.disk.oracle``
on pancake n = 6, 7 and 8, on the CPU; plus the reference's own oracle
tests (``tests/test_oracle.py``) run against the port.

Tolerance: none.  Artifacts are compared byte for byte (META, manifest and
every chunk file, in both formats), codes, distances and paths value for
value, and the ``oracle`` counters key for key after the same query
stream.  Each package opens the other's artifacts.  Query samples come
from ``np.random.default_rng``.
"""
import json
import math
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.disk import implicit_bfs as disk_implicit_bfs
from repro.core.disk import oracle as J
from repro_torch.apps import pancake_bits as P
from repro_torch.core import constructs as TC
from repro_torch.core.disk import oracle as O

sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))
from pancake_bits import _ram_distances, neighbors_np  # noqa: E402

CPU = torch.device("cpu")
NS = (6, 7, 8)
CODEC = {"space": "pancake", "ranking": "myrvold-ruskey"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _publish_both(root, n, compress, chunk_elems=None):
    """The same search published by both packages; returns their dirs."""
    total = math.factorial(n)
    ce = chunk_elems or P.oracle_chunk_elems(total)
    start = P.start_rank(n)
    ref, port = os.path.join(root, "ref"), os.path.join(root, "port")
    want = J.publish_oracle(ref, total, [start], neighbors_np(n),
                            chunk_elems=ce, compress=compress,
                            codec={**CODEC, "n": n})
    got = O.publish_oracle(port, total, [start], P.neighbors(n),
                           level_sizes=want["level_sizes"], chunk_elems=ce,
                           compress=compress, codec={**CODEC, "n": n},
                           device=CPU)
    return {"n": n, "total": total, "start": start, "ref": ref,
            "port": port, "meta_ref": want, "meta_port": got}


_CACHE = {}


@pytest.fixture
def pair(tmp_path_factory):
    """Published pairs by (n, compress), made once per module."""
    def get(n, compress=False):
        key = (n, compress)
        if key not in _CACHE:
            root = str(tmp_path_factory.mktemp(f"pair{n}{int(compress)}"))
            _CACHE[key] = _publish_both(root, n, compress)
        return _CACHE[key]
    return get


def _sample(n):
    total = math.factorial(n)
    if n <= 7:
        return np.arange(total, dtype=np.int64)
    return np.random.default_rng(n).choice(total, 4096,
                                           replace=False).astype(np.int64)


def _files(vdir):
    return {fn: Path(vdir, fn).read_bytes() for fn in sorted(os.listdir(vdir))}


def _open(cls_ref, root, nshards, **kw):
    """A DistanceOracle (nshards 0) or ShardedOracle of either package."""
    mod = J if cls_ref else O
    if not cls_ref:
        kw["device"] = CPU
    if nshards == 0:
        return mod.DistanceOracle(root, **kw)
    return mod.ShardedOracle(root, nshards, **kw)


# ================================================================ publish

class TestPublishParity:

    @pytest.mark.parametrize("compress", [False, True])
    @pytest.mark.parametrize("n", NS)
    def test_artifacts_are_byte_identical(self, pair, n, compress):
        p = pair(n, compress)
        assert p["meta_port"] == p["meta_ref"]
        meta = p["meta_port"]
        assert meta["format"] == (2 if compress else 1)
        assert ("chunk_codec" in meta) == compress
        assert meta["n_chunks"] == 16 - (n == 6)
        assert _files(os.path.join(p["port"], "v000001")) == \
            _files(os.path.join(p["ref"], "v000001"))
        assert Path(p["port"], "ORACLE").read_bytes() == \
            Path(p["ref"], "ORACLE").read_bytes()
        assert not [f for f in os.listdir(p["port"]) if f.endswith(".tmp")]

    @pytest.mark.parametrize("n", NS)
    def test_both_formats_carry_the_same_fingerprints(self, pair, n):
        a, b = pair(n, False)["meta_port"], pair(n, True)["meta_port"]
        assert a["chunk_sha256"] == b["chunk_sha256"]
        assert a["owner_golden"] == b["owner_golden"]

    @pytest.mark.parametrize("n", NS)
    def test_label_words_are_the_chunk_bytes(self, pair, n):
        p = pair(n)
        sizes, words = O.label_distances_mod3(
            p["total"], [p["start"]], P.neighbors(n),
            expect_level_sizes=p["meta_ref"]["level_sizes"], device=CPU)
        assert sizes == p["meta_ref"]["level_sizes"]
        assert len(sizes) - 1 == P.DIAMETERS[n]
        assert words.dtype == torch.int32
        raw = words.numpy().astype("<i4").view(np.uint8)
        ce = p["meta_ref"]["chunk_elems"]
        chunks = [np.load(os.path.join(p["ref"], "v000001", f"b{c:06d}.npy"))
                  for c in range(p["meta_ref"]["n_chunks"])]
        joined = np.concatenate(chunks)
        np.testing.assert_array_equal(raw[:joined.size], joined)
        assert not raw[joined.size:].any()           # padding fields hold 0
        assert chunks[0].size == ce // 4

    def test_label_impl_picks_the_kernels_or_the_plain_versions(self):
        """``impl="ref"`` labels as the default does on the CPU, and
        ``impl="cuda"`` refuses a CPU tensor rather than fall back."""
        sizes, words = O.label_distances_mod3(720, [0], P.neighbors(6),
                                              device=CPU)
        sr, wr = O.label_distances_mod3(720, [0], P.neighbors(6),
                                        impl="ref", device=CPU)
        assert sr == sizes and torch.equal(wr, words)
        with pytest.raises(ValueError, match="CUDA tensor"):
            O.label_distances_mod3(720, [0], P.neighbors(6), impl="cuda",
                                   device=CPU)

    def test_wrong_codes_fail_the_per_code_count(self, monkeypatch):
        """Labels marked with the wrong code keep every level count right;
        the per-code counts (K3 with the identity lut) catch them."""
        monkeypatch.setattr(O, "_code_of", lambda level: 1)
        with pytest.raises(O.OracleError, match="carry code 1"):
            O.label_distances_mod3(120, [0], P.neighbors(5), device=CPU)

    def test_label_levels_are_traced(self):
        spans = []
        O.obs.enable(sink=spans.append)
        try:
            sizes, _ = O.label_distances_mod3(24, [0], P.neighbors(4),
                                              device=CPU)
        finally:
            O.obs.disable()
        assert [s["attrs"]["level"] for s in spans] == \
            list(range(1, len(sizes) + 1))
        assert all(s["sid"] == "oracle.label" for s in spans)

    def test_labels_match_the_reference_disk_search(self, pair):
        """Level sizes equal the reference's disk implicit BFS's, and codes
        equal (distance % 3) + 1 of its in-memory distance table."""
        p = pair(7)
        sizes, bits = disk_implicit_bfs(
            os.path.join(os.path.dirname(p["port"]), "search"), p["total"],
            [p["start"]], neighbors_np(7), chunk_elems=512)
        bits.destroy()
        assert p["meta_port"]["level_sizes"] == sizes
        ref = _ram_distances(7, p["start"], p["total"])
        with O.DistanceOracle(p["port"], device=CPU) as orc:
            got = orc.codes(np.arange(p["total"])).numpy()
        np.testing.assert_array_equal(got, ref % 3 + 1)


# ============================================================ cross-open

class TestCrossOpen:
    """Each package serves the other's artifact, in both formats, through
    the single oracle and the sharded front (1, 2 and 4 shards)."""

    @pytest.mark.parametrize("nshards", [0, 1, 2, 4])
    @pytest.mark.parametrize("compress", [False, True])
    @pytest.mark.parametrize("n", NS)
    def test_port_opens_the_reference_artifact(self, pair, n, compress,
                                               nshards):
        p = pair(n, compress)
        q = _sample(n)
        with _open(True, p["ref"], nshards, cache_bytes=1 << 12) as ref, \
                _open(False, p["ref"], nshards, cache_bytes=1 << 12) as orc:
            want = ref.codes(q)
            got = orc.codes(torch.from_numpy(q))
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), want)
            assert orc.level_sizes == ref.level_sizes

    @pytest.mark.parametrize("nshards", [0, 1, 2, 4])
    @pytest.mark.parametrize("compress", [False, True])
    @pytest.mark.parametrize("n", NS)
    def test_reference_opens_the_port_artifact(self, pair, n, compress,
                                               nshards):
        p = pair(n, compress)
        q = _sample(n)
        with _open(True, p["port"], nshards, cache_bytes=1 << 12) as ref:
            np.testing.assert_array_equal(
                ref.codes(q), _ram_distances(n, p["start"], p["total"])[q]
                % 3 + 1)
            if nshards == 0:
                assert ref.distance(q[:64], neighbors_np(n)).tolist() == \
                    _ram_distances(n, p["start"], p["total"])[q[:64]].tolist()


# ============================================================== serving

class TestServeParity:

    @pytest.mark.parametrize("nshards", [0, 2])
    @pytest.mark.parametrize("n", NS)
    def test_codes_distance_paths_match_the_reference(self, pair, n,
                                                      nshards):
        p = pair(n)
        q = _sample(n)
        with _open(True, p["ref"], nshards, cache_bytes=1 << 14,
                   gen_neighbors=neighbors_np(n)) as ref, \
                _open(False, p["port"], nshards, cache_bytes=1 << 14,
                      gen_neighbors=P.neighbors(n)) as orc:
            tq = torch.from_numpy(q)
            np.testing.assert_array_equal(orc.codes(tq).numpy(),
                                          ref.codes(q))
            dist = orc.distance(tq)
            assert dist.dtype == torch.int64
            np.testing.assert_array_equal(dist.numpy(), ref.distance(q))
            np.testing.assert_array_equal(
                dist.numpy(), _ram_distances(n, p["start"], p["total"])[q])
            d2, chains = orc.paths(tq)
            rd, rchains = ref.paths(q)
            np.testing.assert_array_equal(d2.numpy(), rd)
            assert [c.tolist() for c in chains] == \
                [c.tolist() for c in rchains]
            assert all(c.dtype == torch.int64 for c in chains)

    @pytest.mark.parametrize("nshards", [0, 2])
    def test_counters_match_below_the_budget(self, pair, nshards):
        p = pair(7)
        budget = J.DistanceOracle(p["ref"]).artifact_bytes // 5
        q = np.random.default_rng(3).integers(0, p["total"], 700)
        stats = []
        for is_ref in (True, False):
            (J if is_ref else O).reset_stats()
            gen = neighbors_np(7) if is_ref else P.neighbors(7)
            root = p["ref"] if is_ref else p["port"]
            with _open(is_ref, root, nshards, cache_bytes=budget,
                       gen_neighbors=gen) as orc:
                qq = q if is_ref else torch.from_numpy(q)
                orc.codes(qq)
                orc.distance(qq[:300])
                orc.paths(qq[300:340])
                orc.codes(qq[:0])
                orc.codes(qq[::7])
                for _ in range(2):                    # one chunk: a hit
                    orc.codes(qq[:50] % 100)
            stats.append(dict((J if is_ref else O).STATS))
        assert stats[1] == stats[0]
        assert stats[0]["evictions"] > 0 and stats[0]["hits"] > 0
        assert stats[1]["resident_peak"] <= budget
        assert stats[1]["resident_bytes"] == 0

    def test_path_of_one_rank(self, pair):
        p = pair(6)
        with O.DistanceOracle(p["port"], device=CPU,
                              gen_neighbors=P.neighbors(6)) as orc, \
                J.DistanceOracle(p["ref"],
                                 gen_neighbors=neighbors_np(6)) as ref:
            for r in (0, p["start"], 719, 123):
                assert orc.path(r).tolist() == ref.path(r).tolist()


class TestServeEdges:

    def test_empty_batch(self, pair):
        p = pair(6)
        O.reset_stats()
        with O.DistanceOracle(p["port"], device=CPU,
                              gen_neighbors=P.neighbors(6)) as orc:
            got = orc.codes(torch.empty(0, dtype=torch.int64))
            assert got.dtype == torch.uint8 and got.shape == (0,)
            assert O.STATS["batches"] == 1 and O.STATS["lookups"] == 0
            assert orc.distance([]).shape == (0,)
            d, chains = orc.paths([])
            assert d.shape == (0,) and chains == []

    def test_rank_out_of_range_raises(self, pair):
        p = pair(6)
        for nshards in (0, 2):
            with _open(False, p["port"], nshards) as orc:
                for bad in ([p["total"]], [-1], [0, p["total"] + 5]):
                    with pytest.raises(ValueError, match="out of range"):
                        orc.codes(torch.tensor(bad))

    def test_unreached_states_get_minus_one(self, tmp_path):
        # a 2-regular ring with an unreachable tail half (test_oracle.py)
        ring, total = 16, 32

        def gen(idx):
            return torch.stack([(idx - 1) % ring, (idx + 1) % ring], dim=1)

        art = str(tmp_path / "ring")
        sizes = [1] + [2] * 7 + [1]
        O.publish_oracle(art, total, [0], gen, level_sizes=sizes,
                         chunk_elems=8, device=CPU)
        with O.DistanceOracle(art, cache_bytes=1 << 12, gen_neighbors=gen,
                              device=CPU) as orc:
            got = orc.lookup(torch.arange(total)).numpy()
            want = np.minimum(np.arange(ring), ring - np.arange(ring))
            np.testing.assert_array_equal(got[:ring], want)
            assert (got[ring:] == -1).all()
            d, chains = orc.paths([ring + 3])
            assert int(d[0]) == -1 and chains[0].tolist() == [ring + 3]

    @pytest.mark.parametrize("order", [(1, 2), (2, 1)])
    def test_descent_takes_the_first_wanted_neighbour(self, order):
        """Rank 0 (code of distance 2) has two neighbours one level closer;
        both packages step to the first in generator order."""
        code = {0: 3, 1: 2, 2: 2, 3: 1, 9: 1}
        nbrs = {0: [5, *order], 1: [3, 0], 2: [3, 0], 3: [1, 2]}
        nbrs[5] = [0, 0]
        code[5] = 3

        def t_codes(r):
            return torch.tensor([code[int(x)] for x in r], dtype=torch.uint8)

        def t_gen(r):
            return torch.tensor([nbrs[int(x)] for x in r], dtype=torch.int64)

        dist, trail = O._descend(t_codes, t_gen, torch.tensor([0]),
                                 torch.tensor([3]), 5, record=True)
        want, chains = J._descend(
            lambda r: np.asarray([code[int(x)] for x in r], np.uint8),
            lambda r: np.asarray([nbrs[int(x)] for x in r], np.int64),
            np.asarray([0]), np.asarray([3]), 5, record=True)
        assert dist.tolist() == want.tolist() == [2]
        assert trail[:, 0].tolist() == chains[0] == [0, order[0], 3]

    @pytest.mark.parametrize("budget,groups", [
        ("artifact", [[0, 5, 9]]),          # a budget holding every chunk
        (2, [[0, 5], [9]]),                 # two chunks
        (0.99, [[0], [5], [9]]),            # below one chunk
    ])
    def test_codes_gather_a_launch_a_group_in_ascending_order(
            self, pair, monkeypatch, budget, groups):
        """One chunked K4 call per group of touched chunks that fits the
        budget, in ascending chunk order, each call's table holding that
        group's chunks and no other; the chunks load once each, in
        ascending order."""
        p = pair(7)
        calls, loads = [], []
        real = O.K.bitpack_gather2_chunked

        def spy(table, chunk_elems, ranks, out, **kw):
            calls.append([c for c, w in enumerate(table) if w is not None])
            return real(table, chunk_elems, ranks, out, **kw)

        monkeypatch.setattr(O.K, "bitpack_gather2_chunked", spy)
        with O.DistanceOracle(p["port"], device=CPU) as probe:
            chunk = probe._chunk_bytes(0)
            cache = (probe.artifact_bytes if budget == "artifact"
                     else int(budget * chunk))
        with O.DistanceOracle(p["port"], cache_bytes=cache,
                              device=CPU) as orc:
            real_load = orc._load_chunk
            orc.cache._loader = lambda c: loads.append(c) or real_load(c)
            ce = orc.chunk_elems
            q = torch.tensor([5 * ce + 3, 2, 9 * ce, 5 * ce, 1, 9 * ce + 7])
            got = orc.codes(q)
            sizes = [sum(orc._chunk_bytes(c) for c in g) for g in calls]
        assert loads == [0, 5, 9]
        assert calls == groups
        assert all(b <= cache or len(g) == 1 for g, b in zip(calls, sizes))
        ref = _ram_distances(7, p["start"], p["total"])
        np.testing.assert_array_equal(got.numpy(), ref[q.numpy()] % 3 + 1)

    def test_entry_points_raise_without_a_device(self, pair):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default resolves to it")
        p = pair(6)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            O.DistanceOracle(p["port"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            O.ShardedOracle(p["port"], 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            O.label_distances_mod3(24, [0], P.neighbors(4))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.ram_distances(4)


# ================================================ the reference's classes

@pytest.fixture(scope="module")
def published6(tmp_path_factory):
    """The port's search → publish chain at n=6 (720 states, 15 chunks),
    as tests/test_oracle.py builds it."""
    n = 6
    total = math.factorial(n)
    start = P.start_rank(n)
    sizes, _ = TC.implicit_bfs(total, [start], P.neighbors(n), device=CPU)
    art = str(tmp_path_factory.mktemp("art6") / "oracle")
    meta = O.publish_oracle(art, total, [start], P.neighbors(n),
                            level_sizes=sizes, chunk_elems=48,
                            codec={"space": "pancake", "n": n}, device=CPU)
    return {"n": n, "total": total, "start": start, "sizes": sizes,
            "art": art, "meta": meta,
            "ref": _ram_distances(n, start, total)}


def _codes_of(p):
    return (p["ref"] % 3 + 1).astype(np.uint8)


class TestPublish:

    def test_meta_shape_and_manifest(self, published6):
        p = published6
        meta = p["meta"]
        assert meta["version"] == 1
        assert meta["level_sizes"] == p["sizes"]
        assert meta["n_chunks"] == -(-p["total"] // 48)
        assert len(meta["chunk_sha256"]) == meta["n_chunks"]
        with open(os.path.join(p["art"], "ORACLE")) as f:
            manifest = json.load(f)
        assert manifest["version"] == 1 and manifest["format"] == 1
        assert os.path.isdir(os.path.join(p["art"], "v000001"))

    def test_refuses_wrong_histogram(self, published6, tmp_path):
        p = published6
        bad = list(p["sizes"])
        bad[2] += 1
        with pytest.raises(O.OracleError, match="refusing to publish"):
            O.publish_oracle(str(tmp_path / "bad"), p["total"], [p["start"]],
                             P.neighbors(p["n"]), level_sizes=bad,
                             chunk_elems=48, device=CPU)
        assert not os.path.exists(str(tmp_path / "bad" / "ORACLE"))

    def test_refuses_wrong_level_count(self, published6, tmp_path):
        p = published6
        with pytest.raises(O.OracleError, match="levels"):
            O.publish_oracle(str(tmp_path / "bad2"), p["total"],
                             [p["start"]], P.neighbors(p["n"]),
                             level_sizes=p["sizes"] + [5], chunk_elems=48,
                             device=CPU)
        with pytest.raises(O.OracleError, match="<end>"):
            O.publish_oracle(str(tmp_path / "bad3"), p["total"],
                             [p["start"]], P.neighbors(p["n"]),
                             level_sizes=p["sizes"][:3], chunk_elems=48,
                             device=CPU)

    def test_refuses_what_cannot_be_labelled(self, tmp_path):
        with pytest.raises(O.OracleError, match="empty start"):
            O.publish_oracle(str(tmp_path / "e"), 24, [], P.neighbors(4),
                             device=CPU)
        with pytest.raises(ValueError, match="multiple of 4"):
            O.publish_oracle(str(tmp_path / "c"), 24, [0], P.neighbors(4),
                             chunk_elems=6, device=CPU)

    def test_republish_bumps_version_keeps_old(self, published6, tmp_path):
        p = published6
        art = str(tmp_path / "vv")
        for want in (1, 2):
            meta = O.publish_oracle(art, p["total"], [p["start"]],
                                    P.neighbors(p["n"]),
                                    level_sizes=p["sizes"], chunk_elems=96,
                                    device=CPU)
            assert meta["version"] == want
        assert os.path.isdir(os.path.join(art, "v000001"))
        with O.DistanceOracle(art, cache_bytes=1 << 20, device=CPU) as orc:
            assert orc.version == 2
        with O.DistanceOracle(art, cache_bytes=1 << 20, version=1,
                              device=CPU) as orc:
            np.testing.assert_array_equal(
                orc.codes(torch.arange(p["total"])).numpy(), _codes_of(p))


class TestIntegrity:
    """Tamper / version mismatch → loud OracleError, never wrong data."""

    def _republish(self, p, tmp_path, name="t", compress=False):
        art = str(tmp_path / name)
        O.publish_oracle(art, p["total"], [p["start"]], P.neighbors(p["n"]),
                         level_sizes=p["sizes"], chunk_elems=48,
                         compress=compress, device=CPU)
        return art

    @staticmethod
    def _edit_meta(art, fn, drop_manifest=True):
        if drop_manifest:
            os.remove(os.path.join(art, "ORACLE"))
        mpath = os.path.join(art, "v000001", "META.json")
        meta = json.load(open(mpath))
        fn(meta)
        json.dump(meta, open(mpath, "w"), sort_keys=True)

    def test_tampered_chunk_never_serves(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        chunk = os.path.join(art, "v000001", "b000003.npy")
        raw = bytearray(open(chunk, "rb").read())
        raw[-1] ^= 0xFF
        open(chunk, "wb").write(bytes(raw))
        orc = O.DistanceOracle(art, cache_bytes=1 << 20, device=CPU)
        with pytest.raises(O.OracleError, match="sha256"):
            orc.codes(torch.arange(published6["total"]))

    def test_tampered_compressed_chunk_never_serves(self, published6,
                                                    tmp_path):
        art = self._republish(published6, tmp_path, compress=True)
        chunk = os.path.join(art, "v000001", "b000002.rmz")
        raw = bytearray(open(chunk, "rb").read())
        raw[len(raw) // 2] ^= 0x04
        open(chunk, "wb").write(bytes(raw))
        orc = O.DistanceOracle(art, cache_bytes=1 << 20, device=CPU)
        with pytest.raises(O.OracleError, match="fails to decode"):
            orc.codes(torch.arange(published6["total"]))

    def test_wrong_chunk_shape_and_missing_chunk(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        np.save(os.path.join(art, "v000001", "b000001.npy"),
                np.zeros(5, np.uint8))
        os.remove(os.path.join(art, "v000001", "b000004.npy"))
        orc = O.DistanceOracle(art, cache_bytes=1 << 20, device=CPU)
        with pytest.raises(O.OracleError, match="has shape"):
            orc.codes(torch.tensor([48]))
        with pytest.raises(O.OracleError, match="unreadable"):
            orc.codes(torch.tensor([4 * 48]))

    def test_rewritten_meta_detected(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        self._edit_meta(art, lambda m: m["level_sizes"].__setitem__(0, 7),
                        drop_manifest=False)
        with pytest.raises(O.OracleError, match="fingerprint"):
            O.DistanceOracle(art, cache_bytes=1 << 20, device=CPU)

    def test_manifest_names_missing_version(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        with open(os.path.join(art, "ORACLE"), "w") as f:
            json.dump({"format": 1, "version": 9, "meta_sha256": "x"}, f)
        with pytest.raises(O.OracleError, match="no such sealed"):
            O.DistanceOracle(art, device=CPU)
        with pytest.raises(O.OracleError, match="is not sealed"):
            O.DistanceOracle(art, version=4, device=CPU)

    def test_format_mismatch(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        with open(os.path.join(art, "ORACLE"), "w") as f:
            json.dump({"format": 99, "version": 1}, f)
        with pytest.raises(O.OracleError, match="supported formats"):
            O.DistanceOracle(art, device=CPU)
        # ... and a future META format is refused even via fallback
        self._edit_meta(art, lambda m: m.__setitem__("format", 99))
        with pytest.raises(O.OracleError, match="supported formats"):
            O.DistanceOracle(art, device=CPU)

    def test_chunk_codec_must_fit_the_format(self, published6, tmp_path):
        art = self._republish(published6, tmp_path, "f1")
        self._edit_meta(art, lambda m: m.__setitem__("chunk_codec", "rle2"))
        with pytest.raises(O.OracleError, match="unexpectedly names"):
            O.DistanceOracle(art, device=CPU)
        art = self._republish(published6, tmp_path, "f2", compress=True)
        self._edit_meta(art, lambda m: m.__setitem__("chunk_codec", "zstd"))
        with pytest.raises(O.OracleError, match="only decodes 'rle2'"):
            O.DistanceOracle(art, device=CPU)

    def test_meta_version_must_match_its_dir(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        self._edit_meta(art, lambda m: m.__setitem__("version", 3))
        with pytest.raises(O.OracleError, match="carries META version"):
            O.DistanceOracle(art, device=CPU)

    def test_corrupt_manifest_raises(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        open(os.path.join(art, "ORACLE"), "w").write("{truncated")
        with pytest.raises(O.OracleError, match="corrupt"):
            O.DistanceOracle(art, device=CPU)

    def test_missing_manifest_adopts_newest_sealed(self, published6,
                                                   tmp_path):
        p = published6
        art = self._republish(p, tmp_path)
        os.remove(os.path.join(art, "ORACLE"))
        with O.DistanceOracle(art, cache_bytes=1 << 20, device=CPU) as orc:
            assert orc.version == 1
            np.testing.assert_array_equal(
                orc.codes(torch.arange(p["total"])).numpy(), _codes_of(p))

    def test_empty_root_raises(self, tmp_path):
        with pytest.raises(O.OracleError, match="no oracle artifact"):
            O.DistanceOracle(str(tmp_path / "nothing"), device=CPU)
        os.makedirs(str(tmp_path / "empty"))
        with pytest.raises(O.OracleError, match="no sealed"):
            O.DistanceOracle(str(tmp_path / "empty"), device=CPU)

    def test_owner_goldens_are_checked(self, published6, tmp_path):
        art = self._republish(published6, tmp_path)
        self._edit_meta(art, lambda m: m["owner_golden"].__setitem__(
            "2", [1] * len(m["owner_probe"])))
        O.ShardedOracle(art, 4, device=CPU).close()      # 4 still agrees
        with pytest.raises(O.OracleError, match="published golden"):
            O.ShardedOracle(art, 2, device=CPU)
        with pytest.raises(ValueError, match="nshards"):
            O.ShardedOracle(art, 0, device=CPU)

    def test_corrupt_codes_stop_the_descent(self, published6, tmp_path):
        """A relabelled chunk whose fingerprint was forged: the descent
        fails loudly rather than return a wrong distance."""
        p = published6
        art = self._republish(p, tmp_path)
        path = os.path.join(art, "v000001", "b000002.npy")
        packed = np.load(path)
        packed[:] = 0x55                              # every field code 1
        np.save(path, packed)
        sha = O._sha256_bytes(packed.tobytes())
        self._edit_meta(art, lambda m: m["chunk_sha256"].__setitem__("2",
                                                                     sha))
        with O.DistanceOracle(art, device=CPU,
                              gen_neighbors=P.neighbors(6)) as orc:
            with pytest.raises(O.OracleError, match="artifact corrupt"):
                orc.distance(torch.arange(p["total"]))


class TestLRUCache:

    @staticmethod
    def _loader(nbytes=10):
        def load(key):
            return O.Chunk(torch.full((nbytes,), key % 251), nbytes)
        return load

    def test_eviction_order_is_recency(self):
        O.reset_stats()
        cache = O.LRUChunkCache(30, self._loader(10))     # holds 3 chunks
        for k in (0, 1, 2):
            cache.get(k)
        assert cache.keys() == [0, 1, 2]
        cache.get(0)                                      # refresh 0
        assert cache.keys() == [1, 2, 0]
        cache.get(3)                                      # evicts LRU = 1
        assert cache.keys() == [2, 0, 3]
        cache.get(1)                                      # evicts LRU = 2
        assert cache.keys() == [0, 3, 1]

    def test_exact_counters(self):
        O.reset_stats()
        cache = O.LRUChunkCache(30, self._loader(10))
        for k in (0, 1, 2):                               # 3 cold misses
            cache.get(k)
        for k in (0, 1, 2):                               # 3 hits
            cache.get(k)
        cache.get(3)                                      # miss + eviction
        cache.get(0)                                      # miss (was evicted)
        assert O.STATS["hits"] == 3
        assert O.STATS["misses"] == 5
        assert O.STATS["chunk_loads"] == 5
        assert O.STATS["evictions"] == 2
        assert O.STATS["bytes_read"] == 50
        assert O.STATS["resident_bytes"] == 30
        assert O.STATS["resident_peak"] == 30
        cache.close()
        assert O.STATS["resident_bytes"] == 0

    def test_counters_match_the_reference_cache(self):
        keys = np.random.default_rng(4).integers(0, 9, 200).tolist()
        J.reset_stats()
        O.reset_stats()
        jc = J.LRUChunkCache(45, lambda k: np.full(10 + k % 3, k, np.uint8))
        tc = O.LRUChunkCache(45, lambda k: O.Chunk(torch.zeros(3),
                                                   10 + k % 3))
        for k in keys:
            jc.get(k)
            tc.get(k)
            assert tc.keys() == jc.keys()
        assert dict(O.STATS) == dict(J.STATS)

    def test_budget_enforced_and_oversized_uncached(self):
        O.reset_stats()
        cache = O.LRUChunkCache(25, self._loader(10))     # holds 2 of 10B
        for k in range(7):
            arr = cache.get(k)
            assert arr.nbytes == 10
            assert cache.resident <= 25
            assert O.STATS["resident_bytes"] <= 25
        big_cache = O.LRUChunkCache(5, self._loader(10))  # chunk > budget
        arr = big_cache.get(0)
        assert arr.nbytes == 10 and big_cache.resident == 0
        assert big_cache.keys() == []                     # served uncached
        assert O.STATS["resident_peak"] <= 25

    def test_threaded_readers_under_eviction_pressure(self, published6):
        # 8 threads hammer a cache holding ~2 of 15 chunks; every returned
        # code must still be exact, and the counters must balance.
        p = published6
        O.reset_stats()
        orc = O.DistanceOracle(p["art"], cache_bytes=40, device=CPU)
        want = _codes_of(p)
        errors = []

        def reader(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(60):
                    ranks = rng.integers(0, p["total"], 64)
                    got = orc.codes(torch.from_numpy(ranks)).numpy()
                    if not (got == want[ranks]).all():
                        raise AssertionError("wrong code under pressure")
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert O.STATS["lookups"] == 8 * 60 * 64
        assert O.STATS["batches"] == 8 * 60
        assert O.STATS["misses"] == O.STATS["chunk_loads"]
        assert O.STATS["misses"] > 0 and O.STATS["evictions"] > 0
        assert O.STATS["resident_peak"] <= 40
        assert O.STATS["resident_bytes"] == orc.cache.resident <= 40
        orc.close()
        assert O.STATS["resident_bytes"] == 0

    def test_untraced_search_books_nothing(self):
        O.reset_stats()
        sizes, _ = TC.implicit_bfs(24, [0], P.neighbors(4), device=CPU)
        assert sum(sizes) == 24
        assert all(v == 0 for v in O.STATS.values()), O.STATS


# ============================================================ the app

@pytest.mark.parametrize("compress", [False, True])
def test_cli_publishes_and_checks_n7(tmp_path, capsys, compress):
    art = str(tmp_path / "o7")
    P.main(["--n", "7", "--device", "cpu", "--publish", art, "--check"]
           + (["--compress"] if compress else []))
    out = capsys.readouterr().out
    assert "published distance oracle v000001" in out
    assert "check: oracle distances match the in-memory BFS on 5040" in out
    total = math.factorial(7)
    want = J.publish_oracle(str(tmp_path / "ref"), total, [P.start_rank(7)],
                            neighbors_np(7),
                            chunk_elems=P.oracle_chunk_elems(total),
                            compress=compress,
                            codec={**CODEC, "n": 7})
    assert _files(os.path.join(art, "v000001")) == \
        _files(str(tmp_path / "ref" / "v000001"))
    assert want["n_chunks"] == 16


def test_cli_refusals():
    with pytest.raises(SystemExit):
        P.main(["--n", "9", "--device", "cpu", "--check"])
    with pytest.raises(SystemExit):
        P.main(["--n", "5", "--device", "cpu", "--compress"])


@pytest.mark.parametrize("n", [4, 6, 8])
def test_ram_distances_match_the_reference(n):
    total = math.factorial(n)
    got = P.ram_distances(n, CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), _ram_distances(n, P.start_rank(n), total))
