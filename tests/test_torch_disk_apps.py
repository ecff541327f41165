"""The ``--tier disk`` paths of the port's apps on the CPU, against the
reference's examples and known answers.

Tolerance: none (level sizes, set sizes and printed lines are integers).
``apps.pancake_bits --tier disk`` runs the disk implicit BFS with
``--check`` (the sorted engines, on the device and on disk, and an
in-memory distance table), stops after a level with a checkpoint and
resumes, and heals under ``--chaos``; ``apps.pancake_bfs`` and
``apps.cayley_bfs`` run the disk sorted engine over the port's row
encoding with a host generator that is the reference's rows and order at
n ≤ 8; ``apps.outofcore_setops`` and ``quickstart.tier_d_tour`` print
the reference's numbers.  The default tier stays ``j``.
"""
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import cayley_bfs as CB
from repro_torch.apps import outofcore_setops as OS
from repro_torch.apps import pancake_bfs as PB
from repro_torch.apps import pancake_bits as P
from repro_torch.apps import quickstart as Q
from repro_torch.core.disk import faults as tfaults

sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))
import cayley_bfs as jcayley  # noqa: E402
import pancake_bfs as jpancake  # noqa: E402

SIZES_6 = [1, 5, 20, 79, 199, 281, 133, 2]


@pytest.mark.parametrize("n", [4, 6, 8])
def test_host_moves_are_the_reference_generators(n):
    rows = np.array([[jpancake.start_code(n)]], np.uint32)
    assert np.array_equal(PB.start_code(n)[None], rows)
    pan = PB.HostMoves(n, P.prefix_flip_table(n))
    cay = PB.HostMoves(n, CB.adjacent_swaps(n).table.tolist())
    for _ in range(2):
        assert np.array_equal(pan(rows), jpancake.GenNextNp(n)(rows))
        assert np.array_equal(cay(rows), jcayley.GenNextNp(n)(rows))
        rows = jpancake.GenNextNp(n)(rows)


@pytest.mark.parametrize("n", [9, 12])
def test_host_moves_match_the_device_moves(n):
    """Two words a row past n = 8: the host generator gives the device
    generator's rows, move-major."""
    host = PB.HostMoves(n, P.prefix_flip_table(n))
    rows = host(host(PB.start_code(n)[None]))
    dev_rows, ok = PB.prefix_flips(n)(torch.from_numpy(rows.view(np.int32)))
    want = dev_rows.numpy().view(np.uint32).transpose(1, 0, 2).reshape(
        -1, PB.words(n))
    assert ok.all() and np.array_equal(host(rows), want)


def test_pancake_bits_disk_check(capsys):
    P.main(["--n", "6", "--tier", "disk", "--device", "cpu", "--check",
            "--chunk-elems", "100"])
    out = capsys.readouterr().out
    assert "on disk" in out and "diameter (pancake number): 7" in out
    assert "match the disk sorted-list BFS" in out
    assert "match the in-memory BFS distance table" in out


@pytest.mark.parametrize("unfused", [False, True])
def test_pancake_bits_disk_sizes(unfused, capsys):
    args = ["--n", "6", "--tier", "disk", "--device", "cpu",
            "--chunk-elems", "64", "--compress"]
    P.main(args + (["--unfused"] if unfused else []))
    sizes, _ = P.run_disk(6, chunk_elems=64, fused=not unfused,
                          device="cpu")
    assert sizes == SIZES_6
    assert "(unfused)" in capsys.readouterr().out or not unfused


def test_pancake_bits_stop_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    common = ["--n", "7", "--tier", "disk", "--device", "cpu",
              "--chunk-elems", "1000", "--checkpoint-dir", ck]
    P.main(common + ["--stop-after", "4", "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "stopped after level 4" in out
    assert "level sizes so far: [1, 6, 30, 149, 543]" in out
    P.main(common + ["--resume"])
    out = capsys.readouterr().out
    assert "diameter (pancake number): 8" in out


def test_pancake_bits_chaos_heals(capsys, monkeypatch):
    monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    P.main(["--n", "6", "--tier", "disk", "--device", "cpu",
            "--chunk-elems", "100", "--chaos", "4"])
    out = capsys.readouterr().out
    assert "diameter (pancake number): 7" in out
    retries = int(out.split("io_retries=")[1].split()[0])
    assert retries > 0 and "io_giveups=0" in out
    assert not tfaults.ACTIVE and tfaults.ENV_VAR not in os.environ


def test_pancake_bits_flag_errors():
    for bad in (["--checkpoint-dir", "x"], ["--tier", "disk", "--resume"],
                ["--tier", "disk", "--checkpoint-dir", "x", "--stop-after",
                 "2", "--check", "--n", "6"], ["--compress"]):
        with pytest.raises(SystemExit):
            P.main(["--device", "cpu"] + bad)


def test_pancake_and_cayley_bfs_disk(capsys):
    PB.main(["--n", "7", "--tier", "disk"])
    out = capsys.readouterr().out
    assert "level sizes: [1, 6, 30, 149, 543, 1357, 1903, 1016, 35]" in out
    sizes, _ = PB.run_disk(6, chunk_rows=64, compress=True)
    assert sizes == SIZES_6
    assert PB.run_disk(6, chunk_rows=64, fused=False)[0] == SIZES_6
    CB.main(["--n", "6", "--tier", "disk"])
    assert "Mahonian numbers T(6,k)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        PB.main(["--n", "6", "--compress"])


def test_outofcore_setops_and_tour(capsys):
    import quickstart as jquick
    got = OS.run(n=20_000, chunk_rows=512)
    assert got["union"] + got["intersection"] == (
        got["a_minus_b"] + got["b_minus_a"] + 2 * got["intersection"])
    out = capsys.readouterr().out
    assert "verified against in-RAM oracle" in out
    jquick.tier_d_tour()
    want = capsys.readouterr().out
    Q.tier_d_tour()
    assert capsys.readouterr().out == want
    assert math.factorial(6) == sum(SIZES_6)
