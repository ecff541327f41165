"""Port parity for the whole slice: ``repro_torch`` implicit BFS on the CPU
vs ``repro.core.constructs.implicit_bfs(impl="ref")`` and
``repro.core.disk.implicit_bfs`` on pancake n = 4..7, fused and unfused;
plus the entry points' device rule, the launch counters, the obs spans
and the import rule of the port.

Tolerance: none — level sizes are integers and the final packed words are
compared bit for bit.
"""
import ast
import math
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitarray as JB
from repro.core import constructs as JC
from repro.core import ranking as JR
from repro.core.disk import implicit_bfs as disk_implicit_bfs
from repro_torch import convert
from repro_torch.apps import pancake_bits as P
from repro_torch.core import bitarray as TB
from repro_torch.core import constructs as TC
from repro_torch.core import obs
from repro_torch.kernels import bitpack as tbp

REPO = Path(__file__).resolve().parents[1]
sys.path.append(str(REPO / "examples"))
from pancake_bits import neighbor_jnp, neighbors_np  # noqa: E402


def _start_rows(n):
    return np.asarray(JR.rank_jnp(jnp.arange(n)[None, :]))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", [4, 5, 6, 7])
def test_matches_jax_and_disk(n, fused, tmp_path):
    total = math.factorial(n)
    rows = _start_rows(n)
    start = convert.ranks_from_rows(rows, device="cpu")
    tbp.reset_launches()
    sizes, bits = TC.implicit_bfs(total, start, P.neighbors(n), fused=fused,
                                  device="cpu")
    assert tbp.LAUNCHES == {"mark_rotate_count": 0, "scatter_mark": 0,
                            "lut_count": 0, "gather2": 0}
    jsizes, jbits = JC.implicit_bfs(total, JR.rows_to_ranks(rows).tolist(),
                                    neighbor_jnp(n), impl="ref", fused=fused)
    assert sizes == jsizes
    np.testing.assert_array_equal(convert.words_to_numpy(bits.data),
                                  np.asarray(jbits.data))
    dsizes, dbits = disk_implicit_bfs(str(tmp_path), total,
                                      [int(start[0])], neighbors_np(n),
                                      chunk_elems=256, fused=fused)
    dvals = dbits.read_all()
    dbits.destroy()
    assert sizes == dsizes
    np.testing.assert_array_equal(TB.unpack_values(bits.data).numpy()[:total],
                                  dvals)
    assert len(sizes) - 1 == P.DIAMETERS[n] and sum(sizes) == total


def test_start_from_jax_state_continues_identically():
    # Run the JAX search two levels, carry its array across, and finish
    # both from there: every later level and the final words agree.
    n, total = 6, math.factorial(6)
    start = int(JR.rank_np(np.arange(n)[None, :])[0])
    jfull, _ = JC.implicit_bfs(total, [start], neighbor_jnp(n), impl="ref")
    _, jpart = JC.implicit_bfs(total, [start], neighbor_jnp(n), impl="ref",
                               max_levels=2)
    data = convert.bitarray_from_jax(jpart, device="cpu").data
    sizes = []
    n_cur = TB.count_value(TB.RoomyBitArray(data), TB.CUR, total)
    while n_cur:
        data, cnt = TC._implicit_level(data, n_cur, n_states=total,
                                       neighbor_fn=P.neighbors(n),
                                       impl="auto", fused=True)
        n_cur = int(cnt)
        sizes.append(n_cur)
    assert sizes[:-1] == jfull[3:] and sizes[-1] == 0
    assert (TB.unpack_values(data)[:total] == TB.DONE).all()


def test_frontier_targets_chunking_is_invisible():
    n, total = 7, math.factorial(7)
    _, jpart = JC.implicit_bfs(total, [0], neighbor_jnp(n), impl="ref",
                               max_levels=4)
    data = convert.bitarray_from_jax(jpart, device="cpu").data
    n_cur = TB.count_value(TB.RoomyBitArray(data), TB.CUR, total)
    whole = TC.frontier_targets(data, total, n_cur, P.neighbors(n))
    parts = TC.frontier_targets(data, total, n_cur, P.neighbors(n),
                                batch=7, scan_words=3)
    assert whole.dtype == torch.int32 and whole.shape == (n_cur * (n - 1),)
    assert torch.equal(whole, parts)
    cur = np.nonzero(np.asarray(JB.unpack_values(jpart.data))[:total]
                     == JB.CUR)[0]
    np.testing.assert_array_equal(whole.numpy(),
                                  neighbors_np(n)(cur).reshape(-1))


@pytest.mark.parametrize("n", [8, 12])
def test_pancake_neighbors_match_numpy(n):
    states = np.random.default_rng(n).integers(0, math.factorial(n), 200)
    got = P.neighbors(n)(torch.from_numpy(states))
    np.testing.assert_array_equal(got.numpy(), neighbors_np(n)(states))
    assert P.start_rank(n) == int(JR.rank_np(np.arange(n)[None, :])[0])


def test_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.implicit_bfs(24, [0], P.neighbors(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.run(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.words_to_torch(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="n <= 12"):
        P.run(13, device="cpu")


def test_bfs_level_spans_carry_tier_torch():
    spans = []
    obs.enable(sink=spans.append)
    try:
        sizes, _ = TC.implicit_bfs(24, [0], P.neighbors(4), device="cpu")
    finally:
        obs.disable()
    levels = [s for s in spans if s["sid"] == "bfs.level"]
    expands = [s for s in spans if s["sid"] == "bfs.expand"]
    assert len(spans) == 2 * len(sizes)
    assert [s["attrs"]["level"] for s in levels] == \
        list(range(1, len(sizes) + 1))
    assert all(s["attrs"]["tier"] == "torch" for s in levels)
    assert [s["attrs"]["n_cur"] for s in expands] == sizes
    assert all(s["parent"] == "bfs.level" for s in expands)
    assert obs.span("bfs.level") is obs._NULL          # off again


def test_cli_runs_on_cpu(capsys):
    P.main(["--n", "5", "--device", "cpu", "--unfused"])
    out = capsys.readouterr().out
    assert "diameter (pancake number): 5" in out and "unfused" in out


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    names = {os.path.relpath(p, REPO) for p in files}
    assert {"src/repro_torch/models/ssm.py",
            "src/repro_torch/kernels/mamba_scan.py",
            "src/repro_torch/kernels/paged_decode.py",
            "src/repro_torch/configs/nemotron4_15b.py",
            "src/repro_torch/configs/minicpm_2b.py",
            "src/repro_torch/configs/granite_34b.py",
            "src/repro_torch/core/disk/oracle.py",
            "src/repro_torch/core/disk/codec.py",
            "src/repro_torch/core/disk/buckets.py",
            "src/repro_torch/kernels/bucket_scatter.py",
            "src/repro_torch/core/types.py",
            "src/repro_torch/core/array.py",
            "src/repro_torch/core/hashtable.py",
            "src/repro_torch/core/sharding.py",
            "src/repro_torch/core/delayed.py"} <= names
    for path in files:
        for mod, level in _imports(path):
            top = mod.split(".")[0]
            assert level or top not in ("jax", "jaxlib", "repro"), \
                f"{os.path.relpath(path, REPO)} imports {mod}"
