"""Port parity: ``repro_torch.launch.roofline`` and the collective algebra
of ``repro_torch.launch.dryrun`` vs ``repro.launch.roofline`` and
``repro.launch.dryrun.collective_stats`` (host-side logic only).

* the algebra: records (kind, result bytes, group size) parsed from
  ``tests/test_roofline.py``'s HLO with the reference's own regexes give
  the reference's ``collective_stats`` of that HLO, number for number, at
  several device counts;
* ``analyze`` and ``table`` equal the reference's on the same cells, with
  the reference module's constants patched to the port's H100 ones;
* the constants, a failed cell's row, and ``main`` over a directory.
"""
import json

import numpy as np
import pytest

from repro.launch import dryrun as JD
from repro.launch import roofline as JR
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from test_roofline import HLO

MORE_HLO = """
  %ar2 = bf16[8,128]{1,0} all-reduce-start(%a), replica_groups={{0,1}}, to_apply=%add
  %ag2 = (f32[64]{0}, f32[64]{0}) all-gather(%b, %c), replica_groups=[256,2]<=[512], dimensions={0}
  %a2a2 = s32[512,4]{1,0} all-to-all(%d), replica_groups={{0,1,2,3,4,5,6,7}}
  %rs2 = bf16[1]{0} reduce-scatter(%e), replica_groups=[1,512]<=[512], dimensions={0}
"""


def _records(hlo: str, n_devices: int):
    """The reference's own parse of ``hlo`` as (kind, bytes, group) records
    (``repro/launch/dryrun.py:84-93``)."""
    out = []
    for line in hlo.splitlines():
        m = JD._COLL_RE.search(line)
        if not m:
            continue
        b = JD._shape_bytes(m.group(1))
        gm = JD._GROUPS_IOTA_RE.search(line)
        if gm:
            g = int(gm.group(2))
        else:
            gl = JD._GROUPS_LIST_RE.search(line)
            g = len(gl.group(1).split(",")) if gl else n_devices
        out.append((m.group(2), b, g))
    return out


@pytest.mark.parametrize("n_devices", [1, 8, 256, 512])
@pytest.mark.parametrize("hlo", [HLO, MORE_HLO, HLO + MORE_HLO, ""],
                         ids=["roofline_test", "more", "both", "empty"])
def test_collective_algebra_matches_the_reference(hlo, n_devices):
    want = JD.collective_stats(hlo, n_devices)
    got = D.collective_stats(_records(hlo, n_devices))
    assert set(got) == set(want)
    for kind in D.COLLECTIVE_KINDS:
        assert got[kind]["count"] == want[kind]["count"], kind
        assert got[kind]["operand_bytes"] == want[kind]["operand_bytes"]
        assert got[kind]["wire_bytes"] == want[kind]["wire_bytes"], kind
    assert got["total_operand_bytes"] == want["total_operand_bytes"]
    assert got["total_wire_bytes"] == want["total_wire_bytes"]


def test_the_c10d_ops_map_onto_the_hlo_kinds():
    assert set(D._C10D_KINDS.values()) <= set(D.COLLECTIVE_KINDS)
    assert len(set(D._C10D_KINDS.values())) == len(D._C10D_KINDS)


def test_h100_constants():
    assert R.PEAK_FLOPS == 989e12
    assert R.HBM_BW == 3.35e12
    assert R.LINK_BW == 450e9


def _cells():
    base = {"arch": "x", "shape": "train_4k", "mesh": "16x16",
            "kind": "train", "seq_len": 4096, "global_batch": 256,
            "devices": 256, "active_params": 1_000_000_000,
            "flops_per_device_counted": 1e14, "bytes_per_device": 1e11,
            "collectives": {"total_wire_bytes": 1e10}}
    decode = {**base, "shape": "decode_32k", "kind": "decode",
              "global_batch": 128, "flops_per_device_counted": 1e9,
              "bytes_per_device": 1e12}
    uncounted = {k: v for k, v in base.items()
                 if k != "flops_per_device_counted"}
    uncounted["flops_per_device"] = 3e13
    wired = {**base, "mesh": "2x16x16", "devices": 512,
             "collectives": {"total_wire_bytes": 5e13}}
    zero = {**base, "flops_per_device_counted": 0.0}
    skipped = {"arch": "y", "shape": "long_500k", "mesh": "16x16",
               "skipped": "full attention"}
    return [base, decode, uncounted, wired, zero, skipped]


@pytest.fixture
def ref_at_h100(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JR, name, getattr(R, name))
    return JR


@pytest.mark.parametrize("i", range(len(_cells())))
def test_analyze_matches_the_reference(ref_at_h100, i):
    cell = _cells()[i]
    got, want = R.analyze(cell), ref_at_h100.analyze(cell)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=0)
        else:
            assert got[k] == w, k


def test_table_matches_the_reference(ref_at_h100):
    assert R.table(_cells()) == ref_at_h100.table(_cells())


def test_terms_use_the_h100_constants():
    r = R.analyze(_cells()[0])
    np.testing.assert_allclose(r["t_compute_s"], 1e14 / 989e12)
    np.testing.assert_allclose(r["t_memory_s"], 1e11 / 3.35e12)
    np.testing.assert_allclose(r["t_collective_s"], 1e10 / 450e9)
    assert r["dominant"] == "compute"


def test_a_failed_cell_has_a_row():
    failed = {"arch": "z", "shape": "train_4k", "mesh": "16x16",
              "failed": True, "timeout_s": 1200}
    assert R.analyze(failed)["dominant"] == "failed"
    assert R.table([failed]).splitlines()[-1] == (
        "| z | train_4k | 16x16 | — | — | — | FAIL | — | — |")


def test_main_reads_a_directory(tmp_path, capsys, monkeypatch):
    for i, cell in enumerate(_cells()):
        (tmp_path / f"c{i}.json").write_text(json.dumps(cell))
    out = tmp_path / "table.md"
    monkeypatch.setattr("sys.argv", ["roofline", "--in-dir", str(tmp_path),
                                     "--out", str(out)])
    R.main()
    printed = capsys.readouterr().out.strip()
    assert printed == out.read_text().strip() == R.table(_cells())
