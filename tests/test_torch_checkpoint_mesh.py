"""Checkpoints on a device mesh: ``checkpoint/manager.py``'s save from a
mesh and its elastic restore onto another mesh (or none), and the train
loop's crash → restore → replay on a mesh.

The port runs gemma2-2b at SMOKE in float32 in gloo worlds of spawned
processes ("data", "model"), one spawn a world for every case, each under
a world timeout.  A world of 4 ((2, 2)) trains two steps from the seed's
params, sharded, and saves: the blocking ``save`` and the
``AsyncCheckpointer`` with the state's placements, and rank 0 the
gathered whole tree with no placements.  The three directories must be
byte for byte the same (the format is unchanged), and each leaf's array
the reference's ``repro.checkpoint.save`` of the same logical tree (its
stacked layout cut by layer) bit for bit.  Worlds of 2 ((1, 2)) and 8
((2, 4)) and the test process with no mesh restore it: the logical trees
bit for bit (``tests/test_checkpoint.py:57-90``'s elastic restore).  On
(2, 2) a run that crashes at step 4 with a checkpoint every 2 steps
replays to the losses of the uninterrupted run bit for bit; and from that
run's checkpoint the train loop resumes on (1, 2) and with no mesh,
within 2e-5 of its losses.
"""
import datetime
import math
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.distributed import sharding_rules as SR

from test_torch_mesh_train import run_world

WORLD_TIMEOUT_S = 180
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "2x4": (2, 4)}
STEP = 2                          # the saved state: after two steps
RESUME = 3                        # the elastic resume's checkpoint
SETTINGS = dict(batch=4, seq=16, steps=6, lr=1e-3, warmup_steps=1,
                log_every=100)


def _cfg():
    return get_config("gemma2-2b", smoke=True).replace(
        kernels="ref", dtype="float32")


def _settings(root, name, every=2):
    from repro_torch.runtime import TrainSettings
    return TrainSettings(**SETTINGS, ckpt_every=every,
                         ckpt_dir=os.path.join(root, name))


def _state_tree(params, opt):
    return {"params": params, "opt": opt}


def _save_job(root, mesh, rank, out):
    """Two steps on the mesh, then the three saves."""
    from repro_torch.runtime import train_loop as TL
    from repro_torch.data.pipeline import batch_to_torch, make_batch
    cfg = _cfg()
    s = _settings(root, "unused", every=0)
    params, opt, res = TL.init_state(cfg, s, "cpu", mesh)
    step_fn = TL.make_train_step(cfg, s, mesh)
    for step in range(STEP):
        batch = batch_to_torch(TL.data_rows(make_batch(
            cfg, s.seed, step, s.batch, s.seq), mesh), "cpu")
        params, opt, res, _ = step_fn(params, opt, res, batch, step)
    place = TL.state_shardings(cfg, mesh)
    tree = _state_tree(params, opt)
    ckpt.save(os.path.join(root, "mesh"), STEP, tree, place)
    writer = ckpt.AsyncCheckpointer(os.path.join(root, "async"))
    writer.save(STEP, tree, place)
    writer.wait()
    writer.close()
    specs = SR.config_specs(cfg, mesh)
    whole = _state_tree(SR.gather_params(params, specs, mesh),
                        opt._replace(m=SR.gather_params(opt.m, specs, mesh),
                                     v=SR.gather_params(opt.v, specs, mesh)))
    if rank == 0:
        ckpt.save(os.path.join(root, "whole"), STEP, whole)
    # crash → restore → replay, and the uninterrupted run
    crashed = TL.train(cfg, _settings(root, "replay"), TL.FaultInjector(4),
                       verbose=False, device="cpu", mesh=mesh)
    clean = TL.train(cfg, _settings(root, "clean"), TL.FaultInjector(-1),
                     verbose=False, device="cpu", mesh=mesh)
    out["crashed"] = np.array(crashed["losses"])
    out["restarts"] = np.array(crashed["restarts"])
    out["clean"] = np.array(clean["losses"])


def _restore_job(root, mesh, rank, out):
    """The (2, 2) checkpoint restored onto this mesh, gathered; and the
    train loop resumed here from the uninterrupted run's step 3."""
    from repro_torch.runtime import train_loop as TL
    cfg = _cfg()
    params, opt, _ = TL.init_state(cfg, _settings(root, "unused", 0), "cpu",
                                   mesh)
    got = ckpt.restore(os.path.join(root, "mesh"), STEP,
                       _state_tree(params, opt),
                       TL.state_shardings(cfg, mesh))
    specs = SR.config_specs(cfg, mesh)
    out["opt_step"] = np.array(got["opt"].step)
    out["shard_numel"] = np.array(sum(x.numel() for x in T.leaves(
        got["params"])))
    for key, tree in (("params", got["params"]), ("m", got["opt"].m),
                      ("v", got["opt"].v)):
        whole = SR.gather_params(tree, specs, mesh)
        for path, x in T.flatten_with_path(whole):
            out[f"{key}|{'__'.join(path)}"] = x
    tag = "x".join(map(str, mesh.mesh.shape))
    res = TL.train(cfg, _settings(root, f"resume_{tag}"), TL.FaultInjector(-1),
                   verbose=False, device="cpu", mesh=mesh)
    out["resumed"] = np.array(res["losses"])


def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{tag}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        mesh = M.make_host_mesh(tp=MESHES[tag][1], device="cpu")
        out = {}
        (_save_job if tag == "2x2" else _restore_job)(root, mesh, rank, out)
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def _resume_dir(root, name):
    """A copy of the uninterrupted run's checkpoints up to RESUME."""
    dst = os.path.join(root, name)
    src = os.path.join(root, "clean")
    os.makedirs(dst)
    for d in os.listdir(src):
        if d.startswith("step_") and int(d.split("_")[1]) <= RESUME:
            shutil.copytree(os.path.join(src, d), os.path.join(dst, d))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("ckpt_mesh"))
    run_world(_torch_rank, "2x2", 4, root, WORLD_TIMEOUT_S)
    out = {"2x2": [dict(np.load(f"{root}/torch_2x2_{r}.npz"))
                   for r in range(4)]}
    for tag in ("1x2", "2x4"):
        _resume_dir(root, f"resume_{tag}")
        n = math.prod(MESHES[tag])
        run_world(_torch_rank, tag, n, root, WORLD_TIMEOUT_S)
        out[tag] = [dict(np.load(f"{root}/torch_{tag}_{r}.npz"))
                    for r in range(n)]
    return root, out


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("kind", ["mesh", "async"])
def test_mesh_save_is_the_whole_trees_save_byte_for_byte(kind, worlds):
    root, _ = worlds
    step = f"step_{STEP:08d}"
    a, b = os.path.join(root, kind, step), os.path.join(root, "whole", step)
    assert _files(a) == _files(b) and "manifest.json" in _files(a)
    for name in _files(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    assert not any(d.endswith(".tmp") for d in os.listdir(
        os.path.join(root, kind)))


def test_leaves_are_the_reference_save_of_the_logical_tree(worlds, tmp_path):
    """The reference's ``save`` of the same logical params (stacked over
    layers, gemma2's local/global pairs) holds the port's files' arrays,
    layer by layer, bit for bit; its other leaves' files are the port's
    byte for byte."""
    import jax.numpy as jnp
    from repro.checkpoint import save as jsave
    root, _ = worlds
    cfg = _cfg()
    d = os.path.join(root, "whole", f"step_{STEP:08d}")
    mine = ckpt.restore(os.path.join(root, "whole"), STEP,
                        {"params": _template_params(cfg)})["params"]

    def stack(*layers):
        a = np.stack([x.numpy() for x in layers])
        return jnp.asarray(a.reshape((cfg.n_layers // 2, 2)
                                     + a.shape[1:]))
    ref = {"embed": T.tree_map(lambda x: jnp.asarray(x.numpy()),
                               mine["embed"]),
           "final_norm": jnp.asarray(mine["final_norm"].numpy()),
           "blocks": T.tree_map(stack, *mine["blocks"])}
    jdir = jsave(str(tmp_path), STEP, {"params": ref})
    for path, x in T.flatten_with_path(mine):
        name = "__".join(("params",) + path)
        if path[0] == "blocks":
            i = int(path[1])
            jname = "__".join(("params", "blocks") + path[2:])
            arr = np.load(os.path.join(jdir, jname + ".npy"))
            assert np.array_equal(arr[i // 2, i % 2], np.load(
                os.path.join(d, name + ".npy"))), name
        else:
            with open(os.path.join(jdir, name + ".npy"), "rb") as fa, \
                    open(os.path.join(d, name + ".npy"), "rb") as fb:
                assert fa.read() == fb.read(), name


def _template_params(cfg):
    from repro_torch.models import lm
    return lm.init_params(cfg, 0, device="cpu")


def _logical(root):
    """The saved state, restored with no mesh: {key|path: array}."""
    from repro_torch import optim
    cfg = _cfg()
    p = _template_params(cfg)
    got = ckpt.restore(os.path.join(root, "mesh"), STEP,
                       _state_tree(p, optim.init(p)))
    out = {"opt_step": got["opt"].step}
    for key, tree in (("params", got["params"]), ("m", got["opt"].m),
                      ("v", got["opt"].v)):
        for path, x in T.flatten_with_path(tree):
            out[f"{key}|{'__'.join(path)}"] = x.numpy()
    return out


@pytest.mark.parametrize("tag", ["1x2", "2x4"])
def test_elastic_restore_onto_another_mesh_bit_for_bit(tag, worlds):
    root, out = worlds
    want = _logical(root)
    assert want["opt_step"] == STEP
    cfg = _cfg()
    total = sum(x.numel() for x in T.leaves(_template_params(cfg)))
    for res in out[tag]:
        assert int(res["opt_step"]) == STEP
        assert int(res["shard_numel"]) < total
    ranks = out[tag]
    for key, arr in want.items():
        if key == "opt_step":
            continue
        assert np.array_equal(ranks[0][key], arr), key


def test_restore_with_no_mesh_is_the_whole_tree(worlds):
    root, _ = worlds
    want = _logical(root)
    whole = os.path.join(root, "whole", f"step_{STEP:08d}")
    for key, arr in want.items():
        if key == "opt_step":
            continue
        kind, path = key.split("|")
        name = ("params__" if kind == "params" else f"opt__{kind}__") + path
        assert np.array_equal(np.load(os.path.join(whole, name + ".npy")),
                              arr), key


def test_crash_restore_replay_on_a_mesh_matches_uninterrupted(worlds):
    """(2, 2): a crash at step 4, a checkpoint every 2 steps: the replay's
    losses are the uninterrupted run's bit for bit (the replayed step
    appears twice), on every rank."""
    _, out = worlds
    for res in out["2x2"]:
        assert int(res["restarts"]) == 1
        crashed, clean = res["crashed"], res["clean"]
        assert len(clean) == SETTINGS["steps"]
        assert np.array_equal(crashed[:4], clean[:4])
        assert np.array_equal(crashed[-(len(clean) - 3):], clean[3:])


@pytest.mark.parametrize("tag", ["1x2", "2x4", "none"])
def test_train_loop_resumes_on_another_mesh(tag, worlds):
    """The (2, 2) run's checkpoint of step 3, resumed on (1, 2), (2, 4)
    and with no mesh: the same losses for steps 3-5 within 2e-5."""
    from repro_torch.runtime import train_loop as TL
    root, out = worlds
    clean = out["2x2"][0]["clean"]
    if tag == "none":
        _resume_dir(root, "resume_none")
        got = TL.train(_cfg(), _settings(root, "resume_none"),
                       TL.FaultInjector(-1), verbose=False,
                       device="cpu")["losses"]
    else:
        got = out[tag][0]["resumed"]
    assert len(got) == SETTINGS["steps"] - RESUME
    np.testing.assert_allclose(got, clean[RESUME:], rtol=2e-5)
