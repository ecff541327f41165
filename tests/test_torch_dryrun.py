"""``python -m repro_torch.launch.dryrun`` at the real mesh sizes (a fake
world of 256 or 512 ranks, no card), held to what the reference's specs
give at the same mesh sizes, computed without a compile.

Four cells, each a subprocess with a timeout of its own, all started
together: gemma2-2b ``train_4k`` on the single pod, granite-moe-3b
``prefill_32k`` on two pods (the roomy MoE exchange; params sharded in
serving), zamba2-1.2b ``long_500k`` on the single pod (the twin FLOP
count and its scan correction too), and nemotron-4-15b ``long_500k``,
which gives the reference's skip record.  Each imports neither ``jax``
nor ``repro``.  For each: ``params``, ``active_params``, the meta fields
and ``sharding_notes`` equal the reference's (its config's counts, its
``ShardingRules`` over a stand-in mesh after the same ``param_specs``
calls), and rank 0's argument bytes equal the bytes the reference's
specs place on one device, with the differences the port keeps on
purpose: serving takes the global batch on every rank (the reference
shards it over dp), each rank's SSM states hold its model rank's
``d_inner`` channels (``h`` as the reference's batch-1 ``cache_specs``
split it over ``model``; ``conv`` as [its x channels | B | C], where the
reference cuts the channel dim contiguously), and AdamW's step count is a
Python int (the reference's is a 4-byte array).
"""
import json
import math
import os
import subprocess
import sys

import jax
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import inputs as JI
from repro.configs import shapes as JS
from repro.distributed import sharding_rules as JSR
from repro.launch import dryrun as JD
from repro.models import lm as jlm

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CELLS = {  # (arch, shape, mesh, extra flags, timeout s)
    "gemma2": ("gemma2-2b", "train_4k", "single", ["--skip-flops"], 300),
    "granite": ("granite-moe-3b-a800m", "prefill_32k", "multi",
                ["--skip-flops"], 300),
    "zamba2": ("zamba2-1.2b", "long_500k", "single", [], 300),
    "nemotron": ("nemotron-4-15b", "long_500k", "multi", [], 120),
}
RUN = """
import runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
finally:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, f"the dry run imported {bad[:5]}"
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for key, (arch, shape, mesh, extra, _) in CELLS.items():
        procs[key] = subprocess.Popen(
            [sys.executable, "-c", RUN, "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--out-dir", str(out_dir)] + extra,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    res = {}
    try:
        for key, proc in procs.items():
            arch, shape, mesh, _, timeout = CELLS[key]
            _, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, err[-3000:]
            with open(out_dir / f"{arch}__{shape}__{mesh}.json") as f:
                res[key] = json.load(f)
    finally:
        for proc in procs.values():
            proc.kill()
    return res


class FakeMesh:
    """The reference's stand-in mesh: axis sizes only."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _shard_bytes(leaf, spec, mesh) -> int:
    """The bytes of ``leaf`` one device holds under ``spec``."""
    div = 1
    for entry in tuple(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            div *= mesh[axis]
    n = math.prod(leaf.shape) * jax.numpy.dtype(leaf.dtype).itemsize
    assert n % div == 0
    return n // div


def _tree_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_shard_bytes(a, s, mesh) for a, s in zip(leaves, spec_leaves))


def _whole_bytes(tree) -> int:
    return sum(math.prod(a.shape) * jax.numpy.dtype(a.dtype).itemsize
               for a in jax.tree.leaves(tree))


def _reference(key):
    """(meta fields, sharding notes, rank 0's argument bytes) from the
    reference's config and specs at the cell's mesh size."""
    arch, shape_name, mesh_name, extra, _ = CELLS[key]
    shape = JS.SHAPES[shape_name]
    cfg = j_get_config(arch).replace(kernels="ref")
    mesh = MESHES[mesh_name]
    meta = {"arch": arch, "shape": shape_name, "microbatches": 1,
            "mesh": "2x16x16" if mesh_name == "multi" else "16x16",
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "moe_dispatch": cfg.moe_dispatch,
            "embed_dispatch": cfg.embedding_dispatch, "remat": cfg.remat,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    rules = JSR.ShardingRules(cfg, FakeMesh(mesh))
    pshape = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    pspecs = rules.param_specs(pshape)
    if "--skip-flops" not in extra:          # the twin lowerings' specs too
        for k in JD._flops_points(cfg):
            ck = cfg.replace(n_layers=k, scan_layers=False)
            rules.param_specs(jax.eval_shape(
                lambda: jlm.init_params(ck, jax.random.PRNGKey(0))))
    params = _tree_bytes(pshape, pspecs, mesh)
    specs_in = JI.input_specs(cfg, shape)
    if shape.kind == "train":
        dp = math.prod(mesh[a] for a in rules.dp_axes)
        rows = shape.global_batch // dp
        batch = _whole_bytes(specs_in) * rows // shape.global_batch
        args = 3 * params + batch        # params, m, v; the step a Python int
    else:
        args = params + _whole_bytes(specs_in["inputs"])   # global batch
    if shape.kind == "decode":
        caches = specs_in["caches"]
        cspecs = rules.cache_specs(caches, shape.global_batch)
        if "kv" in caches:
            args += _tree_bytes(caches["kv"], cspecs["kv"], mesh)
        if "ssm" in caches:
            args += _ssm_channel_bytes(caches["ssm"], cfg, mesh["model"])
    return meta, rules.describe(), args


def _ssm_channel_bytes(ssm, cfg, tp: int) -> int:
    """The bytes of the (L, B, …) SSM states a model rank holds: its
    ``d_inner / tp`` channels of ``h``, and of ``conv`` those channels with
    mamba2's B and C (every channel reads them)."""
    conv, h = ssm.conv, ssm.h
    di, n = cfg.d_inner, cfg.ssm_state
    extra = conv.shape[-1] - di                 # 2N for mamba2, 0 for mamba1
    assert di % tp == 0 and h.shape[-2] == di
    per_h = math.prod(h.shape) // di * (di // tp)
    per_conv = math.prod(conv.shape) // conv.shape[-1] * (di // tp + extra)
    return (per_h * jax.numpy.dtype(h.dtype).itemsize
            + per_conv * jax.numpy.dtype(conv.dtype).itemsize)


@pytest.mark.parametrize("key", ["gemma2", "granite", "zamba2"])
def test_cell_matches_the_reference_specs(results, key):
    got = results[key]
    meta, notes, args = _reference(key)
    for k, v in meta.items():
        assert got[k] == v, k
    assert got["sharding_notes"] == notes
    assert got["devices"] == (512 if got["mesh"] == "2x16x16" else 256)
    assert got["memory"]["argument_bytes"] == args
    peak = got["memory"]["peak_estimate_bytes"]
    assert peak >= args > 0
    assert got["flops_per_device"] > 0 and got["bytes_per_device"] > 0
    coll = got["collectives"]
    assert coll["total_wire_bytes"] > 0
    assert coll["all-gather"]["count"] > 0        # the params' gathers


def test_train_cell_reduces_its_gradients(results):
    coll = results["gemma2"]["collectives"]
    assert coll["reduce-scatter"]["count"] > 0    # each gather's backward
    assert results["gemma2"]["memory"]["donated"] == ["params", "opt_state"]


def test_roomy_moe_exchanges_on_two_pods(results):
    coll = results["granite"]["collectives"]
    assert coll["all-to-all"]["count"] > 0
    assert coll["reduce-scatter"]["count"] == 0   # serving: no backward


def test_long_500k_decode_counts_its_scan_and_twin(results):
    z = results["zamba2"]
    assert z["memory"]["donated"] == ["caches"]
    assert z["scan_time_correction"] == 0.0       # decode: no time scan
    assert z["flops_k2"] > z["flops_k1"] > 0
    assert z["flops_per_device_counted"] > 0


def test_full_attention_long_500k_is_the_references_skip(results):
    arch, shape, mesh, _, _ = CELLS["nemotron"]
    want = JD.run_cell(arch, shape, mesh == "multi")
    assert results["nemotron"] == want
    assert "skipped" in want


SPLIT = """
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.configs.inputs import input_specs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding_rules import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import lm
D.fake_world(16)
mesh = M.make_host_mesh(tp=4, device="cpu")
D.build_groups(mesh)
cfg = get_config("minicpm-2b", smoke=True).replace(kernels="ref")
shape = ShapeSpec("p", 64, 16, "prefill")
counted = D._counted_flops(cfg, shape, mesh, ShardingRules(cfg, mesh))
with D._fake_mode():
    params = D._fake_like(lm.init_params(cfg, 0, device="meta"))
    inputs = D._fake_like(input_specs(cfg, shape)["inputs"])
    flops = FlopCounterMode(display=False)
    with flops, torch.no_grad():
        lm.prefill(params, inputs, cfg)
json.dump({"mesh": counted["flops_per_device_counted"],
           "one": float(flops.get_total_flops())}, open(sys.argv[1], "w"))
"""


def test_prefill_flops_a_rank_split_over_a_4x4_mesh(tmp_path):
    """A fake world of 16 ranks as 4 x 4, minicpm SMOKE (4 heads, 4 kv
    heads) prefilling 16 rows of 64: a rank's twin-counted FLOPs are at
    most 1.3/16 of the same prefill's with no mesh (its rows over the
    data axes, its heads, ff and vocab columns over ``model``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    out = tmp_path / "split.json"
    proc = subprocess.run([sys.executable, "-c", SPLIT, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        got = json.load(f)
    assert 0 < got["mesh"] <= 1.3 / 16 * got["one"], got


SEQ_RANK = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding_rules import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
D.fake_world(16, int(sys.argv[2]))
mesh = M.make_host_mesh(tp=4, device="cpu")
D.build_groups(mesh)
cfg = get_config("minicpm-2b", smoke=True).replace(
    kernels="ref", n_heads=3, n_kv_heads=3)
shape = ShapeSpec("p", 64, 4, "prefill")
counted = D._counted_flops(cfg, shape, mesh, ShardingRules(cfg, mesh))
json.dump(counted["flops_per_device_counted"], open(sys.argv[1], "w"))
"""


def test_the_sequence_split_loads_the_last_model_rank_most(tmp_path):
    """``fake_world``'s rank: minicpm SMOKE with 3 heads on a fake 4 x 4
    world, 4 rows of 64 (the batch does not tile the grid, so prefill
    splits the sequence over ``model``): model rank 3's query block sees
    every key and counts more FLOPs than rank 0's, which sees a quarter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    got = {}
    for rank in (0, 3):
        out = tmp_path / f"rank{rank}.json"
        proc = subprocess.run([sys.executable, "-c", SEQ_RANK, str(out),
                               str(rank)], env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out) as f:
            got[rank] = json.load(f)
    assert 0 < got[0] < got[3], got
