"""The dry run's fake world against real gloo worlds, and serving from
param shards (``lm.prefill`` / ``lm.decode_step`` on a mesh).

* A SMOKE train step (granite-moe with the roomy MoE and the roomy
  embedding: all-gathers, reduce-scatters, all-reduces and all-to-alls),
  a context-parallel SMOKE decode step (minicpm at batch 1) and a
  batch-sharded one (gemma2 at batch 4), traced by
  ``dryrun.trace_cell`` as rank 0 of a ``fake`` world of 4 on fake
  tensors, record the same collectives, in the same order, as rank 0 of
  a gloo world of 4 running the same step on real zeros: kind, result
  bytes, group size and the group's ranks.
* The full-depth FLOP count equals the twin extrapolation
  (``dryrun._counted_flops``) within 1e-6 on a homogeneous stack.
* Serving from param shards, each rank computing its share (its rows,
  heads, ff and vocab columns), equals serving the whole params on one
  device, logits within 2e-4 in float32 (the all-reduces over ``model``
  sum in another order) and the greedy tokens identical, for gemma2-2b,
  granite-moe (at capacity factor 8: neither MoE dispatch drops a pair)
  and zamba2 SMOKE in gloo worlds of 2 ((1, 2)) and 4 ((2, 2)); every
  rank gets the same back.

Each world is one spawn of ``torch.multiprocessing`` (a file store under
tmp_path; the ranks import this module, which imports nothing of the
reference); the fake world is one subprocess.
"""
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding_rules as SR
from repro_torch.distributed.sharding_rules import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import lm

WORLD_TIMEOUT_S = 180

# (name, arch, config overrides, shape, tp): the steps whose collectives
# a fake world and a gloo world of 4 must record alike
STEPS = {
    "train": ("granite-moe-3b-a800m", {"embedding_dispatch": "roomy"},
              ShapeSpec("t", 32, 4, "train"), 2),
    "decode": ("minicpm-2b", {}, ShapeSpec("d", 512, 1, "decode"), 2),
    "decode_rows": ("gemma2-2b", {}, ShapeSpec("d", 256, 4, "decode"), 2),
}


def step_cfg(name):
    arch, over, shape, tp = STEPS[name]
    return get_config(arch, smoke=True).replace(kernels="ref", **over), shape


def record_step(name, mesh, fake: bool) -> dict:
    """The step ``name``'s collectives on ``mesh`` as this rank records
    them: on fake tensors (``dryrun.trace_cell``) or on real zeros."""
    cfg, shape = step_cfg(name)
    D.build_groups(mesh)
    rules = ShardingRules(cfg, mesh)
    if fake:
        tr = D.trace_cell(cfg, shape, mesh, rules)
        return {"collectives": tr["collectives"], "groups": tr["groups"]}
    args = D.make_args(cfg, shape, mesh, rules)
    rec = D.StepRecorder()
    with rec:
        D.run_step(cfg, shape, mesh, args)
    return {"collectives": rec.collectives, "groups": rec.groups}


def _init(rank, world, root):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))


def gloo_steps_rank(rank, world, root):
    """One rank of a gloo world of ``world``: every step of STEPS on
    real zero tensors, its records to ``root/gloo_<rank>.json``."""
    _init(rank, world, root)
    try:
        out = {}
        for name, (_, _, _, tp) in STEPS.items():
            out[name] = record_step(name, M.make_host_mesh(
                tp=tp, device="cpu"), fake=False)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"gloo_{rank}.json"), "w") as f:
        json.dump(out, f)


# ------------------------------------------------------ sharded serving

SERVE_ARCHS = ("gemma2-2b", "granite-moe-3b-a800m", "zamba2-1.2b")
# capacity factor 8: no (token, choice) pair drops in the roomy MoE on the
# mesh nor in the einsum MoE on one device, so the two dispatches agree
SERVE_OVER = {"granite-moe-3b-a800m": {"capacity_factor": 8.0}}
SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_LEN = 2, 6, 3, 128


def greedy(cfg, params, prompt, mesh):
    """prefill, then SERVE_STEPS greedy decode steps: (the last logits of
    every call (1 + T, B, V), the tokens chosen (B, T))."""
    b, s = prompt.shape
    pos = torch.arange(s)[None].expand(b, s)
    with torch.no_grad():
        lg, caches = lm.prefill(params, {"tokens": prompt, "positions": pos},
                                cfg, mesh, max_len=SERVE_MAX_LEN)
        logits, toks = [lg[:, -1]], []
        for _ in range(SERVE_STEPS):
            tok = lg[:, -1:].argmax(-1)
            toks.append(tok)
            lg, caches = lm.decode_step(
                params, {"tokens": tok, "positions": torch.zeros_like(tok)},
                caches, cfg, mesh)
            logits.append(lg[:, -1])
    return torch.stack(logits), torch.cat(toks, 1)


def serve_rank(rank, world, tp, root):
    """One rank of a gloo world on a (world / tp, tp) mesh: each of
    SERVE_ARCHS served from this rank's param shards on the mesh and from
    the whole params on one device, results to ``root/serve_<rank>.npz``."""
    _init(rank, world, root)
    out = {}
    try:
        mesh = M.make_host_mesh(tp=tp, device="cpu")
        rng = np.random.default_rng(33)
        for i, arch in enumerate(SERVE_ARCHS):
            cfg = get_config(arch, smoke=True).replace(
                kernels="ref", dtype="float32", **SERVE_OVER.get(arch, {}))
            whole = lm.init_params(cfg, 40 + i, device="cpu")
            specs = SR.config_specs(cfg, mesh)
            shards = SR.shard_params(whole, specs, mesh)
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)))
            out[f"{arch}|sharded"], out[f"{arch}|sharded_toks"] = greedy(
                cfg, shards, prompt, mesh)
            out[f"{arch}|whole"], out[f"{arch}|whole_toks"] = greedy(
                cfg, whole, prompt, None)
            out[f"{arch}|smaller"] = np.array(sum(
                a.numel() for a in T.leaves(shards)) < sum(
                a.numel() for a in T.leaves(whole)))
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(root, f"serve_{rank}.npz"),
             **{k: v.numpy() if torch.is_tensor(v) else v
                for k, v in out.items()})


TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")

FAKE_SIDE = """
import json, sys
import test_torch_dryrun_worlds as H
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding_rules import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
D.fake_world(4)
out = {name: H.record_step(name, M.make_host_mesh(tp=tp, device="cpu"),
                             fake=True)
       for name, (_, _, _, tp) in H.STEPS.items()}
mesh = M.make_host_mesh(tp=2, device="cpu")
for arch, shape in (("minicpm-2b", ShapeSpec("t", 32, 4, "train")),
                    ("gemma2-2b", ShapeSpec("p", 64, 2, "prefill"))):
    cfg = get_config(arch, smoke=True).replace(kernels="ref", n_layers=8)
    rules = ShardingRules(cfg, mesh)
    full = D.trace_cell(cfg, shape, mesh, rules)["flops"]
    out["twin_" + arch] = {"full": full, **D._counted_flops(
        cfg, shape, mesh, rules)}
json.dump(out, open(sys.argv[1], "w"))
"""


def _spawn(fn, world, args, what):
    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{what} did not finish in {WORLD_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The fake world's records (a subprocess, started first) and the
    gloo world of 4's (spawned meanwhile)."""
    root = tmp_path_factory.mktemp("dryrun_worlds")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, TESTS,
                                         env.get("PYTHONPATH", "")])
    fake = subprocess.Popen(
        [sys.executable, "-c", FAKE_SIDE, str(root / "fake.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _spawn(gloo_steps_rank, 4, (str(root),), "the gloo world of 4")
        _, err = fake.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        fake.kill()
    assert fake.returncode == 0, err[-3000:]
    with open(root / "fake.json") as f:
        fake_out = json.load(f)
    with open(root / "gloo_0.json") as f:
        gloo_out = json.load(f)
    return fake_out, gloo_out


@pytest.mark.parametrize("name", list(STEPS))
def test_fake_world_records_the_gloo_worlds_collectives(worlds, name):
    fake, gloo = worlds[0][name], worlds[1][name]
    want = [tuple(r) for r in gloo["collectives"]]
    got = [tuple(r) for r in fake["collectives"]]
    assert len(want) > 0
    assert got == want
    assert fake["groups"] == gloo["groups"]
    kinds = {k for k, _, _ in want}
    if name == "train":
        assert {"all-gather", "reduce-scatter", "all-reduce",
                "all-to-all"} <= kinds
    else:
        assert "all-reduce" in kinds or "all-gather" in kinds


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma2-2b"])
def test_full_depth_flops_equal_the_twin_extrapolation(worlds, arch):
    rec = worlds[0]["twin_" + arch]
    assert rec["scan_time_correction"] == 0.0
    assert rec["flops_k2"] > rec["flops_k1"] > 0
    np.testing.assert_allclose(rec["flops_per_device_counted"], rec["full"],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = {}
    for world, tp in ((2, 2), (4, 2)):
        root = tmp_path_factory.mktemp(f"serve_{world}")
        _spawn(serve_rank, world, (tp, str(root)),
               f"the serving world of {world}")
        out[world] = [dict(np.load(root / f"serve_{r}.npz"))
                      for r in range(world)]
    return out


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_serving_equals_whole_params(served, world, arch):
    ranks = served[world]
    r0 = ranks[0]
    assert bool(r0[f"{arch}|smaller"])           # the shards are shards
    sharded, whole = r0[f"{arch}|sharded"], r0[f"{arch}|whole"]
    assert sharded.shape == (1 + SERVE_STEPS, SERVE_B, whole.shape[-1])
    np.testing.assert_allclose(sharded, whole, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(r0[f"{arch}|sharded_toks"],
                                  r0[f"{arch}|whole_toks"])
    for r in ranks[1:]:                          # every rank the same
        np.testing.assert_array_equal(r[f"{arch}|sharded"], sharded)
        np.testing.assert_array_equal(r[f"{arch}|sharded_toks"],
                                      r0[f"{arch}|sharded_toks"])
