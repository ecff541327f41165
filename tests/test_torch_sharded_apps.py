"""The sharded flags of the port's apps on the CPU, against the
reference's examples.

Tolerance: none (level sizes and printed tables are integers).
``apps.pancake_bits --tier disk --shards N`` over every wire and
exchange prints the level table the reference's
``examples/pancake_bits.py`` prints with the same flags; ``--trace``
writes a JSONL trace whose report has one row a level and spans from
every shard; ``--chaos`` with spawned shards kills a worker mid-search
and heals to the exact level sizes; ``apps.pancake_bfs`` and
``apps.cayley_bfs`` run their disk engine over shards with the
reference's level sizes.
"""
import os
import sys
from pathlib import Path

import pytest

from repro_torch.apps import cayley_bfs as CB
from repro_torch.apps import pancake_bfs as PB
from repro_torch.apps import pancake_bits as P
from repro_torch.core.disk import faults as tfaults
from repro_torch.core.disk import trace as ttrace

sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))
SIZES_6 = [1, 5, 20, 79, 199, 281, 133, 2]


def table(out):
    """The ``flips states cumulative`` rows of a printed level table."""
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.split()[:1] == ["flips"])
    rows = []
    for ln in lines[i + 1:]:
        parts = ln.split()
        if len(parts) != 3 or not parts[0].isdigit():
            break
        rows.append(tuple(int(x) for x in parts))
    return rows


@pytest.mark.parametrize("wire,exchange", [
    ("fs", "barrier"), ("tcp", "pipelined"), ("loopback", "barrier"),
    ("loopback", "pipelined")])
def test_pancake_bits_sharded_table_is_the_references(capsys, monkeypatch,
                                                      wire, exchange):
    import pancake_bits as jbits
    flags = ["--n", "6", "--tier", "disk", "--chunk-elems", "64",
             "--shards", "3", "--shard-mode", "inline", "--transport", wire,
             "--exchange", exchange]
    monkeypatch.setattr(sys, "argv", ["pancake_bits.py"] + flags)
    jbits.main()
    want = table(capsys.readouterr().out)
    P.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "shards=3" in out
    assert table(out) == want
    assert [r[1] for r in want] == SIZES_6


def test_pancake_bits_sharded_trace(tmp_path, capsys):
    path = tmp_path / "run.jsonl"
    P.main(["--n", "6", "--tier", "disk", "--device", "cpu",
            "--chunk-elems", "64", "--shards", "2", "--shard-mode",
            "inline", "--trace", str(path), "--check"])
    out = capsys.readouterr().out
    assert "trace: pancake_bits" in out and "shards=2" in out
    assert "match the sorted-list BFS" in out
    rep = ttrace.report_json(str(path))
    assert [r["level"] for r in rep["levels"]] == list(range(len(SIZES_6)
                                                             + 1))
    assert all(sorted(r["shard_us"]) == [0, 1] for r in rep["levels"])
    assert rep["meta"]["nshards"] == 2


def test_pancake_bits_sharded_chaos_heals(capsys, monkeypatch):
    monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    P.main(["--n", "6", "--tier", "disk", "--device", "cpu",
            "--chunk-elems", "100", "--shards", "2", "--chaos", "4"])
    out = capsys.readouterr().out
    assert table(out) and [r[1] for r in table(out)] == SIZES_6
    assert "worker_level:kill:shard=1:level=2" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("chaos: io_retries="))
    got = dict(kv.split("=") for kv in line.split()[1:])
    assert got["recoveries"] == "1" and got["io_giveups"] == "0"
    assert int(got["replayed_levels"]) >= 1
    assert not tfaults.ACTIVE and tfaults.ENV_VAR not in os.environ


def test_pancake_and_cayley_bfs_sharded(tmp_path, capsys, monkeypatch):
    import pancake_bfs as jbfs
    flags = ["--n", "6", "--tier", "disk", "--shards", "2",
             "--shard-mode", "inline", "--transport", "loopback"]
    monkeypatch.setattr(sys, "argv", ["pancake_bfs.py"] + flags)
    jbfs.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("level sizes:")]
    PB.main(flags + ["--trace", str(tmp_path / "p.jsonl")])
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines()
            if ln.startswith("level sizes:")] == want
    assert want == [f"level sizes: {SIZES_6}"]
    assert "trace: pancake_bfs" in out
    CB.run(6, device="cpu", tier="disk", shards=2, shard_mode="inline",
           trace_path=str(tmp_path / "c.jsonl"))
    out = capsys.readouterr().out
    assert "Mahonian numbers T(6,k)" in out and "trace: cayley_bfs" in out
    assert len(ttrace.report_json(str(tmp_path / "c.jsonl"))["levels"]) \
        == 6 * 5 // 2 + 2


def test_sharded_flag_errors():
    for bad in (["--shards", "2"], ["--trace", "x"],
                ["--transport", "tcp"], ["--exchange", "pipelined"]):
        with pytest.raises(SystemExit):
            P.main(["--device", "cpu", "--n", "6"] + bad)
        with pytest.raises(SystemExit):
            PB.main(["--n", "6"] + bad)
    for bad in (["--shards", "2"], ["--trace", "x"]):
        with pytest.raises(SystemExit):
            CB.main(["--n", "6"] + bad)
    with pytest.raises(SystemExit):
        P.main(["--device", "cpu", "--n", "6", "--tier", "disk", "--unfused",
                "--shards", "2"])
    with pytest.raises(SystemExit):
        PB.main(["--n", "6", "--tier", "disk", "--unfused", "--shards", "2"])
