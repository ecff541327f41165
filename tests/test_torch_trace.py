"""Port parity: the observability layer of Tier D's sharded runtime —
``repro_torch.core.obs`` (the registry snapshots, span buffering and
shard tags) and ``repro_torch.core.disk.trace`` — against
``repro.core.obs`` and ``repro.core.disk.trace``.

Tolerance: none, times excepted.  The same counter bumps, histogram
observations and spans go through both packages' ``obs``: snapshots,
merges, counter deltas, drained and ingested spans (shard tags included)
are equal, and ``enable(shard=, sink=)`` / ``ENV_VAR`` behave alike.  A
sharded implicit search (pancake n = 6, 2 shards, inline) traced by
each package gives the same ``report_json`` level rows once the wall
times are dropped, every level's worker spans are tagged with every
shard, the printed report has the reference's columns, and
``export_chrome`` writes one track per shard; ``python -m
repro_torch.core.disk.trace`` reads the port's file.  A traced spawn run
brings the workers' spans and counters back to the coordinator.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import obs as jobs
from repro.core.disk import bfs as JD
from repro.core.disk import config as jconfig
from repro.core.disk import trace as jtrace
from repro_torch.apps import pancake_bits as P
from repro_torch.core import obs as tobs
from repro_torch.core.disk import bfs as TD
from repro_torch.core.disk import trace as ttrace
from repro_torch.core.disk.config import ClusterConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT / "examples"))
N = 6
SIZES = [1, 5, 20, 79, 199, 281, 133, 2]


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    for mod in (tobs, jobs):
        mod.disable()
    os.environ.pop(tobs.ENV_VAR, None)


def drive_obs(obs):
    """The same registry and span traffic through one package's obs."""
    d = obs.counters("t_parity", {"a": 0, "b": 0})
    d["a"], d["b"] = 0, 0
    before = obs.snapshot()
    obs.enable(shard=3)
    with obs.span("outer", x=1):
        d["a"] += 5
        with obs.span("inner", shard=7):
            d["b"] += 2
    spans = obs.drain_spans()
    after = obs.snapshot()
    for s in spans:
        s.pop("ts_us"), s.pop("dur_us")
    snaps = [{"counters": {"n": {"x": 1}}},
             {"counters": {"n": {"x": 2, "y": 1}, "m": {"z": 4}}}]
    out = {
        "spans": spans,
        "again": obs.drain_spans(),
        "deltas": obs.counter_deltas(after, before),
        "counters": after["counters"]["t_parity"],
        "merge": obs.merge(*snaps)["counters"],
        "merge_id": obs.merge({}, snaps[1])["counters"],
    }
    sink = []
    obs.enable(sink=sink.append)
    obs.ingest([{"type": "span", "sid": "w", "shard": None},
                {"type": "span", "sid": "v", "shard": 1}], shard=4)
    out["ingested"] = sink
    obs.disable()
    out["null"] = obs.span("x") is obs._NULL
    return out


def test_obs_additions_are_the_references():
    got, want = drive_obs(tobs), drive_obs(jobs)
    assert got == want
    assert [s["shard"] for s in got["spans"]] == [7, 3]
    assert got["deltas"] == {"t_parity.a": 5, "t_parity.b": 2}
    assert got["merge"] == {"n": {"x": 3, "y": 1}, "m": {"z": 4}}
    assert [s["shard"] for s in got["ingested"]] == [4, 1]
    assert tobs.ENV_VAR == jobs.ENV_VAR == "ROOMY_TRACE"


def test_add_is_the_plain_sum():
    d = tobs.counters("t_add", {"k": 0})
    d["k"] = 0
    tobs.add(d, "k", 3)
    tobs.add(d, "new", 2)
    assert d == {"k": 3, "new": 2}


def traced_search(pkg, tmp_path, path, nshards=2, mode="inline"):
    trace = jtrace if pkg == "ref" else ttrace
    trace.start(str(path), meta={"example": "parity", "n": N})
    try:
        if pkg == "ref":
            from pancake_bits import NeighborsNp
            sizes, bits = JD.implicit_bfs(
                str(tmp_path / pkg), math.factorial(N), [P.start_rank(N)],
                NeighborsNp(N), chunk_elems=128,
                cluster=jconfig.ClusterConfig(nshards=nshards, mode=mode))
        else:
            sizes, bits = TD.implicit_bfs(
                str(tmp_path / pkg), math.factorial(N), [P.start_rank(N)],
                P.neighbors(N), chunk_elems=128, device="cpu",
                cluster=ClusterConfig(nshards=nshards, mode=mode,
                                      timeout=120.0))
        bits.destroy()
    finally:
        trace.stop()
    assert sizes == SIZES
    return trace.report_json(str(path))


def timeless(rep):
    rows = []
    for r in rep["levels"]:
        r = dict(r)
        r["shard_us"] = sorted(r.pop("shard_us"))
        r.pop("wall_us")
        r.pop("skew_pct")
        rows.append(r)
    return rows


def test_report_json_levels_are_the_references(tmp_path):
    want = traced_search("ref", tmp_path, tmp_path / "ref.jsonl")
    got = traced_search("port", tmp_path, tmp_path / "port.jsonl")
    assert timeless(got) == timeless(want)
    assert [r["level"] for r in got["levels"]] == list(range(len(SIZES) +
                                                             1))
    for r in got["levels"]:
        assert sorted(r["shard_us"]) == [0, 1]       # every shard tagged
        assert r["passes"] > 0 and r["bytes"] > 0
    assert got["totals"]["passes"] == want["totals"]["passes"]
    assert got["totals"]["bytes"] == want["totals"]["bytes"]
    assert got["replayed_levels"] == [] and got["rollback_spans"] == 0
    meta, spans, summary = ttrace.read(str(tmp_path / "port.jsonl"))
    assert meta["example"] == "parity" and meta["type"] == "meta"
    assert {s["shard"] for s in spans} == {None, 0, 1}
    assert summary["counters"]["bits"]["sync_passes"] > 0


def test_report_prints_the_references_table(tmp_path, capsys):
    path = tmp_path / "port.jsonl"
    traced_search("port", tmp_path, path)
    capsys.readouterr()
    rows = ttrace.report(str(path))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("trace: parity") and "shards=2" in out[0]
    assert out[1].split() == ["level", "wall_s", "passes", "bytes",
                              "bytes/s", "retries", "recov", "skew%"]
    assert out[-1].split()[0] == "total"
    assert len(rows) == len(SIZES) + 1
    jtrace.report(str(path))          # the reference reads the port's file
    assert capsys.readouterr().out.splitlines()[2:] == out[2:]


def test_export_chrome_and_cli(tmp_path):
    path = tmp_path / "port.jsonl"
    traced_search("port", tmp_path, path)
    out = ttrace.export_chrome(str(path))
    assert out == str(tmp_path / "port.chrome.json")
    doc = json.load(open(out))
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"coordinator", "shard 0", "shard 1"}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert min(e["ts"] for e in xs) == 0
    assert {e["pid"] for e in xs} == {0, 1, 2}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.disk.trace", "report",
         str(path), "--json"], capture_output=True, text=True, env=env,
        timeout=120)
    assert res.returncode == 0, res.stderr
    # JSON has no int keys: shard_us keys come back as strings
    assert json.loads(res.stdout)["levels"] == json.loads(json.dumps(
        ttrace.report_json(str(path))["levels"]))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.disk.trace",
         "export-chrome", str(path), "-o", str(tmp_path / "c.json")],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0 and "wrote" in res.stdout


def test_start_twice_raises_and_stop_is_idempotent(tmp_path):
    ttrace.start(str(tmp_path / "a.jsonl"))
    assert os.environ[tobs.ENV_VAR] == "1" and tobs.ACTIVE
    with pytest.raises(RuntimeError, match="already active"):
        ttrace.start(str(tmp_path / "b.jsonl"))
    assert ttrace.stop() == str(tmp_path / "a.jsonl")
    assert ttrace.stop() is None
    assert tobs.ENV_VAR not in os.environ and not tobs.ACTIVE


def test_spawn_trace_brings_worker_spans_home(tmp_path):
    rep = traced_search("port", tmp_path, tmp_path / "spawn.jsonl",
                        mode="spawn")
    inline = traced_search("port", tmp_path, tmp_path / "inline.jsonl")
    assert timeless(rep) == timeless(inline)
    _, spans, _ = ttrace.read(str(tmp_path / "spawn.jsonl"))
    worker = [s for s in spans if s.get("shard") is not None]
    assert {s["shard"] for s in worker} == {0, 1}
    assert any(s["sid"] == "pass.rw" for s in worker)
