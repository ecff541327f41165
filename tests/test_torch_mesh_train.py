"""Port parity: training on a device mesh (``lm.loss_fn`` / the train step
with ``mesh=``, params and AdamW state as ShardingRules shards, the
differentiable roomy exchanges) vs the JAX package.

The reference runs once, in one subprocess with 8 fake CPU devices (the
``multidev`` fixture), with ``kernels="ref"`` and float32: the host's
``jax.value_and_grad(loss_fn(p, batch, cfg, None))`` of each arch, its
``jit(loss_fn(p, batch, cfg, mesh))`` with ShardingRules-placed params on
each mesh (``tests/test_distributed.py:193-225``), and three host train
steps (``jit(make_train_step(cfg, s, None))``: AdamW, WSD, clip 1.0, the
batches of ``make_batch`` with uneven label masks) with
``grad_compression`` none and int8 (whose codec inputs it records) and
with two microbatches (each data rank's part of each global microbatch,
``train_loop.data_rows``).  The
port runs each mesh ("data", "model") as a gloo world of spawned
processes, one spawn a world for every case, each under a world timeout:
its params are each rank's shards of the reference's
(``convert.lm_params_shard_from_jax``), its batch each data rank's rows.

Tolerances: the loss within rtol 2e-5 of both (the reference's own); each
gradient leaf, gathered, within ‖Δ‖ ≤ 1e-4 ‖g‖ of the host gradient; over
the three steps the losses within 2e-5 and each param leaf within 1e-4 of
its norm (with int8 both codecs quantize the reference's input, checked
against the port's own at 1e-4 a leaf, as ``tests/test_torch_train.py``
does: a one-ulp difference moves an element a whole level).  Each rank's
params + m + v hold exactly the bytes the specs give its shards.  The
planted faults must fail these checks: ``tp`` left out of the loss share
on (1, 2); the local mask count on (4, 1), whose data ranks' label masks
are uneven; the reverse all-to-all's backward returning zeros (the
experts' and the router's gradients); a shard's own int8 blocks; and a
replicated dim counted on each rank in the global norm.

Archs at SMOKE: musicgen-medium (the reference's own case, embeds),
granite-moe-3b-a800m with the roomy embedding at capacity factor 8 (no
pair drops) and at 0.25 (the loss alone, with each layer's dropped pairs
equal to a numpy count), gemma2-2b (local/global pairs, softcap, tied),
falcon-mamba-7b (ssm: data-parallel only).
"""
import datetime
import math
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import sharding_rules as SR

WORLD_TIMEOUT_S = 240
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "4x1": (4, 1), "2x4": (2, 4)}
TRAIN_MESHES = ("2x2", "4x1")
B, S = 8, 16
ARCHS = {"musicgen-medium": {},
         "granite-moe-3b-a800m": {"embedding_dispatch": "roomy",
                                  "capacity_factor": 8.0},
         "gemma2-2b": {}, "falcon-mamba-7b": {}}
DROP = ("granite-moe-3b-a800m", 0.25)        # pairs drop: the loss alone
TRAIN = {"musicgen-medium": ("none", "int8", "micro2"),
         "granite-moe-3b-a800m": ("none", "int8"), "gemma2-2b": ("none",)}
STEPS = dict(batch=B, seq=16, steps=3, lr=1e-3, warmup_steps=1)
LOSS_RTOL, GRAD_REL, PARAM_REL = 2e-5, 1e-4, 1e-4


def _step_settings(case) -> dict:
    """A train case's settings: "micro2" is two microbatches with no
    compression, the others the codec named."""
    if case == "micro2":
        return dict(STEPS, grad_compression="none", num_microbatches=2)
    return dict(STEPS, grad_compression=case)


def _cfg(arch, **kw):
    return get_config(arch, smoke=True).replace(
        kernels="ref", dtype="float32", **{**ARCHS.get(arch, {}), **kw})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- inputs

def _uneven(b: dict) -> dict:
    """``b`` with uneven label masks: row r drops its first 2r labels, so
    the data ranks' (and the microbatches') mask counts differ."""
    labels = b["labels"].copy()
    for r in range(labels.shape[0]):
        labels[r, :2 * r] = -1
    return {"inputs": dict(b["inputs"]), "labels": labels}


def _batch(arch) -> dict:
    """The loss cases' numpy batch of B × S, masked unevenly."""
    return _uneven(make_batch(_cfg(arch), 31, 0, B, S))


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}|{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflat(store: dict, prefix: str) -> dict:
    tree = {}
    for key, val in store.items():
        if not key.startswith(prefix + "|"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("|")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _inputs() -> dict:
    out = {}
    for arch in ARCHS:
        _flat(_batch(arch), f"batch|{arch}", out)
    return out


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from repro import optim
from repro.configs import get_config
from repro.data.pipeline import make_batch
from repro.distributed.sharding_rules import ShardingRules, named
from repro.models import lm
from repro.runtime import train_loop as jtrain

ARCHS, MESHES, DROP = {archs}, {meshes}, {drop}
TRAIN, STEPS = {train}, {steps}
def cfg_of(arch, **kw):
    return get_config(arch, smoke=True).replace(
        kernels="ref", dtype="float32", **{{**ARCHS[arch], **kw}})

def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, prefix + "|" + k, out)
    else:
        out[prefix] = np.asarray(tree)

def unflat(store, prefix):
    tree = {{}}
    for key, val in store.items():
        if key.startswith(prefix + "|"):
            node = tree
            parts = key[len(prefix) + 1:].split("|")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = jnp.asarray(val)
    return tree

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

g = dict(np.load("{root}/inputs.npz"))
out = {{}}
host_grad = jax.jit(jax.value_and_grad(lm.loss_fn), static_argnums=(2, 3))
mesh_loss = jax.jit(lm.loss_fn, static_argnums=(2, 3))
cases = [(a, cfg_of(a)) for a in ARCHS] + [
    ("drop", cfg_of(DROP[0], capacity_factor=DROP[1]))]
for arch, cfg in cases:
    name = DROP[0] if arch == "drop" else arch
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    batch = unflat(g, "batch|" + name)
    if arch != "drop":
        flat(params, "params|" + arch, out)
        loss, grads = host_grad(params, batch, cfg, None)
        out["loss|" + arch] = loss
        flat(grads, "grad|" + arch, out)
    for tag, shape in MESHES.items():
        mesh = mesh_of(shape)
        specs = ShardingRules(cfg, mesh).param_specs(
            jax.eval_shape(lambda: params))
        placed = jax.tree.map(jax.device_put, params, named(mesh, specs))
        out[f"mesh_loss|{{arch}}|{{tag}}"] = mesh_loss(placed, batch, cfg,
                                                      mesh)

seen = []
orig = jtrain.compress_lib.int8_compress
def codec(grads, residual):
    jax.debug.callback(lambda *x: seen.append(x), grads, residual,
                       ordered=True)
    return orig(grads, residual)
jtrain.compress_lib.int8_compress = codec
for arch, comps in TRAIN.items():
    cfg = cfg_of(arch)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    for comp in comps:
        s = jtrain.TrainSettings(**STEPS, **(
            dict(grad_compression="none", num_microbatches=2)
            if comp == "micro2" else dict(grad_compression=comp)))
        step_fn = jax.jit(jtrain.make_train_step(cfg, s))
        p, opt = params, optim.init(params)
        res = (jax.tree.map(lambda x: jnp.zeros_like(x, jnp.float32), p)
               if s.grad_compression != "none" else jnp.zeros(()))
        key = f"train|{{arch}}|{{comp}}"
        for step in range(s.steps):
            batch = make_batch(cfg, s.seed, step, s.batch, s.seq)
            batch["labels"] = batch["labels"].copy()  # the port's _uneven
            for r in range(s.batch):
                batch["labels"][r, :2 * r] = -1
            batch = jax.tree.map(jnp.asarray, batch)
            p, opt, res, m = step_fn(p, opt, res, batch,
                                     jnp.asarray(step, jnp.int32))
            out[f"{{key}}|loss|{{step}}"] = m["loss"]
            out[f"{{key}}|gnorm|{{step}}"] = m["gnorm"]
            if comp == "int8":
                jax.effects_barrier()
                cg, cr = seen.pop()
                flat(cg, f"{{key}}|codec_g|{{step}}", out)
                flat(cr, f"{{key}}|codec_r|{{step}}", out)
        flat(p, key + "|params", out)
np.savez("{root}/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("jax side ok")
"""


# --------------------------------------------------------- the port side

def _port_batch(g: dict, arch: str):
    from repro_torch.data.pipeline import batch_to_torch
    return batch_to_torch(_unflat(g, f"batch|{arch}"), "cpu")


class _Drops:
    """Every ``moe_roomy`` call's routing ids and dropped pairs (a forward
    reading, so taken with grad off)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.rec = moe, moe.moe_roomy, []

    def __enter__(self):
        def counted(p, x, cfg, mesh):
            y, dropped = self.orig(p, x, cfg, mesh)
            self.rec.append((self.moe._route(p, x, cfg)[1], dropped))
            return y, dropped
        self.moe.moe_roomy = counted
        return self.rec

    def __exit__(self, *exc):
        self.moe.moe_roomy = self.orig


def _faulty(name):
    """The planted fault ``name`` installed (a context manager)."""
    import contextlib
    from repro_torch.core import delayed
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    @contextlib.contextmanager
    def patch(obj, attr, value):
        orig = getattr(obj, attr)
        setattr(obj, attr, value)
        try:
            yield
        finally:
            setattr(obj, attr, orig)

    orig = lm._loss_denominator

    def no_tp(mask, mesh):
        return orig(mask, mesh) // lm.SH.mesh_axes(mesh).get("model", 1)

    def local_count(mask, mesh):
        return mask.sum() * lm.SH.mesh_axes(mesh).get("model", 1)

    def zero_backward(ctx, g):
        return torch.zeros_like(g), None
    return {"no_tp": lambda: patch(lm, "_loss_denominator", no_tp),
            "local_count": lambda: patch(lm, "_loss_denominator",
                                         local_count),
            "a2a_zero_bwd": lambda: patch(delayed._Exchange, "backward",
                                          staticmethod(zero_backward)),
            "norm_every_rank": lambda: patch(adamw, "_counted",
                                             lambda spec, coord: True),
            }[name]()


FAULTS = {"1x2": {"no_tp": "musicgen-medium"},
          "4x1": {"local_count": "gemma2-2b"},
          "2x2": {"a2a_zero_bwd": "granite-moe-3b-a800m"}}


def _loss_grads(store, g, arch, cfg, mesh, specs):
    from repro_torch.runtime.train_loop import data_rows, loss_and_grads
    params = convert.lm_params_shard_from_jax(
        _unflat(store, f"params|{arch}"), cfg, mesh, device="cpu")
    params = T.tree_map(lambda p: p.requires_grad_(True), params)
    loss, grads = loss_and_grads(params, data_rows(_port_batch(g, arch),
                                                   mesh), cfg, mesh)
    return loss, SR.gather_params(T.unflatten(params, grads), specs, mesh)


def _train_case(store, g, arch, comp, mesh, out):
    """Three steps on ``mesh`` from the reference's params; int8 quantizes
    the reference's codec input after checking the port's against it."""
    from repro_torch import optim
    from repro_torch.data.pipeline import batch_to_torch
    from repro_torch.optim import compress
    from repro_torch.runtime import TrainSettings
    from repro_torch.runtime import train_loop as TL
    cfg = _cfg(arch)
    specs = SR.config_specs(cfg, mesh)
    key = f"train|{arch}|{comp}"
    params = T.tree_map(lambda p: p.requires_grad_(True),
                        convert.lm_params_shard_from_jax(
                            _unflat(store, f"params|{arch}"), cfg, mesh,
                            device="cpu"))
    opt = optim.init(params)
    s = TrainSettings(**_step_settings(comp))
    res = (T.tree_map(torch.zeros_like, T.tree_map(torch.Tensor.detach,
                                                   params))
           if s.grad_compression != "none" else None)
    step_fn = TL.make_train_step(cfg, s, mesh)
    orig, worst = compress.int8_compress, [0.0]

    def fed(step):
        def codec(grads, residual):
            want = [convert.lm_params_from_jax(_unflat(
                store, f"{key}|codec_{w}|{step}"), cfg, "cpu")
                for w in ("g", "r")]
            for got, w in zip((grads, residual), want):
                for a, b in zip(T.leaves(got), T.leaves(w)):
                    worst[0] = max(worst[0], _rel(a, b))
            return orig(*want)
        return codec
    for step in range(s.steps):
        batch = batch_to_torch(TL.data_rows(_uneven(make_batch(
            cfg, s.seed, step, s.batch, s.seq)), mesh, s.num_microbatches),
            "cpu")
        compress.int8_compress = fed(step)
        try:
            params, opt, res, m = step_fn(params, opt, res, batch, step)
        finally:
            compress.int8_compress = orig
        out[f"{key}|loss|{step}"] = m["loss"]
        out[f"{key}|gnorm|{step}"] = m["gnorm"]
    out[f"{key}|codec_worst"] = np.array(worst[0])
    whole = SR.gather_params(params, specs, mesh)
    for path, x in T.flatten_with_path(whole):
        out[f"{key}|params|{'/'.join(path)}"] = x.detach()


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).detach().float(), torch.as_tensor(b).float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    """One rank of a gloo world on the mesh ``tag``: every case, results
    to ``root/torch_<tag>_<rank>.npz`` (gathered trees on rank 0 only)."""
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.launch import mesh as M
    from repro_torch.optim import compress
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{tag}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        mesh = M.make_host_mesh(tp=MESHES[tag][1], device="cpu")
        g = dict(np.load(f"{root}/inputs.npz"))
        store = dict(np.load(f"{root}/jax_out.npz"))
        out = {}

        def keep(key, tree):
            if rank == 0:
                for path, x in T.flatten_with_path(tree):
                    out[f"{key}|{'/'.join(path)}"] = x.detach()
        for arch in ARCHS:
            cfg = _cfg(arch)
            specs = SR.config_specs(cfg, mesh)
            loss, grads = _loss_grads(store, g, arch, cfg, mesh, specs)
            out[f"loss|{arch}"] = loss
            keep(f"grad|{arch}", grads)
        for fault, arch in FAULTS.get(tag, {}).items():
            cfg = _cfg(arch)
            with _faulty(fault):
                loss, grads = _loss_grads(store, g, arch, cfg, mesh,
                                          SR.config_specs(cfg, mesh))
            out[f"fault|{fault}|loss"] = loss
            keep(f"fault|{fault}|grad", grads)
        arch, cf = DROP
        cfg = _cfg(arch, capacity_factor=cf)
        with torch.no_grad(), _Drops() as rec:
            params = convert.lm_params_shard_from_jax(
                _unflat(store, f"params|{arch}"), cfg, mesh, device="cpu")
            from repro_torch.models import lm
            from repro_torch.runtime.train_loop import data_rows
            out["drop|loss"] = lm.loss_fn(
                params, data_rows(_port_batch(g, arch), mesh), cfg, mesh)
        for i, (ids, dropped) in enumerate(rec):
            out[f"drop|ids|{i}"], out[f"drop|dropped|{i}"] = ids, dropped
        if tag == "2x2":
            # the codec on logical leaves vs a shard's own blocks, and the
            # global norm counting each element once
            arch = "granite-moe-3b-a800m"
            cfg = _cfg(arch)
            specs = SR.config_specs(cfg, mesh)
            whole = convert.lm_params_from_jax(
                _unflat(store, f"grad|{arch}"), cfg, "cpu")
            shards = SR.shard_params(whole, specs, mesh)
            for codec, name, fn in (
                    ("int8", "logical", compress.mesh_round_trip),
                    ("int8", "shard_blocks", _shard_blocks),
                    ("topk", "logical", compress.mesh_round_trip)):
                dec, res = fn(codec, shards, None, specs, mesh)
                keep(f"codec|{codec}|{name}|dec",
                     SR.gather_params(dec, specs, mesh))
                keep(f"codec|{codec}|{name}|res",
                     SR.gather_params(res, specs, mesh))
            out["norm|mesh"] = optim.global_norm(shards, mesh, specs)
            with _faulty("norm_every_rank"):
                out["norm|fault"] = optim.global_norm(shards, mesh, specs)
        if tag in TRAIN_MESHES:
            for arch, comps in TRAIN.items():
                for comp in comps:
                    _train_case(store, g, arch, comp, mesh, out)
            for arch in ARCHS:
                cfg = _cfg(arch)
                from repro_torch.runtime import TrainSettings
                from repro_torch.runtime.train_loop import init_state
                p, opt, _ = init_state(cfg, TrainSettings(), "cpu", mesh)
                out[f"bytes|{arch}"] = np.array(sum(
                    x.numel() * x.element_size()
                    for x in T.leaves((p, opt.m, opt.v))))
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.detach().numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def _shard_blocks(codec, grads, residual, specs, mesh):
    """The planted codec fault: each shard encoded on its own."""
    from repro_torch.optim import compress
    msg, res = compress.int8_compress(grads, residual)
    return compress.int8_decompress(msg, grads), res


def run_world(fn, tag: str, world: int, root: str, timeout: float) -> None:
    """``fn(rank, world, tag, root)`` on ``world`` spawned processes; a
    world that does not finish within ``timeout`` seconds is killed and
    the test fails."""
    ctx = mp.start_processes(fn, args=(world, tag, root), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo world {tag} did not finish in {timeout} s")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    from conftest import run_multidev
    root = tmp_path_factory.mktemp("mesh_train")
    np.savez(root / "inputs.npz", **_inputs())
    code = JAX_SIDE.format(archs=ARCHS, meshes=MESHES, drop=DROP,
                           train=TRAIN, steps=STEPS, root=root)
    run_multidev(code, n_devices=8, timeout=600)
    return root, dict(np.load(root / "jax_out.npz")), dict(
        np.load(root / "inputs.npz"))


@pytest.fixture(scope="module")
def world(jax_side):
    """The port's results on a mesh, a list by rank; each world runs once
    for the module."""
    done = {}

    def get(tag):
        if tag not in done:
            root = jax_side[0]
            n = math.prod(MESHES[tag])
            run_world(_torch_rank, tag, n, str(root), WORLD_TIMEOUT_S)
            done[tag] = [dict(np.load(root / f"torch_{tag}_{r}.npz"))
                         for r in range(n)]
        return done[tag]
    return get


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key
    return ranks[0][key]


def _ref_tree(want: dict, prefix: str, cfg) -> list:
    """The reference's tree saved under ``prefix`` in the port's layout."""
    return list(T.flatten_with_path(convert.lm_params_from_jax(
        _unflat(want, prefix), cfg, "cpu")))


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("tag", list(MESHES))
def test_loss_matches_host_and_mesh_reference(tag, arch, world, jax_side):
    _, want, _ = jax_side
    got = float(_same_on_every_rank(world(tag), f"loss|{arch}"))
    np.testing.assert_allclose(got, float(want[f"loss|{arch}"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, float(want[f"mesh_loss|{arch}|{tag}"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("tag", list(MESHES))
def test_gradient_matches_host(tag, arch, world, jax_side):
    """Each leaf of the gathered gradient against the host's."""
    _, want, _ = jax_side
    res = world(tag)[0]
    leaves = _ref_tree(want, f"grad|{arch}", _cfg(arch))
    assert len(leaves) == sum(k.startswith(f"grad|{arch}|") for k in res)
    for path, w in leaves:
        got = res[f"grad|{arch}|{'/'.join(path)}"]
        assert _rel(got, w) <= GRAD_REL, (path, _rel(got, w))


def test_drops_match_numpy_count_and_reference_loss(world, jax_side):
    """granite-moe at capacity factor 0.25 on (2, 2): the loss within 2e-5
    of the reference's mesh loss (both dispatch by the roomy engine), and
    each layer's dropped pairs at both levels those of the numpy count over
    the global routing (each data rank's rows, joined in order)."""
    from test_torch_mesh import _roomy_drops_oracle
    _, want, _ = jax_side
    ranks = world("2x2")
    arch, cf = DROP
    got = float(_same_on_every_rank(ranks, "drop|loss"))
    np.testing.assert_allclose(got, float(want[f"mesh_loss|drop|2x2"]),
                               rtol=LOSS_RTOL)
    cfg = _cfg(arch, capacity_factor=cf)
    layers = sum(1 for k in ranks[0] if k.startswith("drop|ids|"))
    assert layers == cfg.n_layers
    total = np.zeros(2, int)
    for i in range(layers):
        ids = np.concatenate([r[f"drop|ids|{i}"] for r in ranks[::2]])
        dropped = _same_on_every_rank(ranks, f"drop|dropped|{i}")
        assert dropped.tolist() == _roomy_drops_oracle(ids, cfg, (2, 2))
        total += dropped
    assert total.sum() > 0


@pytest.mark.parametrize("arch,comp", [(a, c) for a, cs in TRAIN.items()
                                       for c in cs])
@pytest.mark.parametrize("tag", TRAIN_MESHES)
def test_three_train_steps_match_host(tag, arch, comp, world, jax_side):
    _, want, _ = jax_side
    ranks = world(tag)
    key = f"train|{arch}|{comp}"
    for step in range(STEPS["steps"]):
        got = float(_same_on_every_rank(ranks, f"{key}|loss|{step}"))
        np.testing.assert_allclose(got, float(want[f"{key}|loss|{step}"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            float(_same_on_every_rank(ranks, f"{key}|gnorm|{step}")),
            float(want[f"{key}|gnorm|{step}"]), rtol=1e-5)
    if comp == "int8":
        assert float(ranks[0][f"{key}|codec_worst"]) <= 1e-4
    cfg = _cfg(arch)
    for path, w in _ref_tree(want, f"{key}|params", cfg):
        got = ranks[0][f"{key}|params|{'/'.join(path)}"]
        assert _rel(got, w) <= PARAM_REL, (path, _rel(got, w))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("tag", TRAIN_MESHES)
def test_rank_holds_its_shards_bytes(tag, arch, world):
    """params + m + v on each rank: 1/k of a leaf sharded over k ranks,
    the whole of a replicated one (float32)."""
    class Stand:                       # mesh_axes reads a ``shape``
        shape = dict(zip(("data", "model"), MESHES[tag]))
    cfg = _cfg(arch)
    specs = SR.config_specs(cfg, Stand())
    from repro_torch.core import sharding as SH
    from repro_torch.models import lm
    shapes = lm.init_params(cfg, 0, device="meta")
    want = []
    T.tree_map(lambda x, spec: want.append(
        x.numel() // math.prod(Stand.shape[a] for a in SH.spec_axes(spec))),
        shapes, specs)
    assert math.prod(MESHES[tag]) == len(world(tag))
    for r in world(tag):
        assert int(r[f"bytes|{arch}"]) == 3 * 4 * sum(want)
    assert sum(want) < sum(x.numel() for x in T.leaves(shapes))


# ------------------------------------------------------ planted faults

def _worst(res, want, arch, prefix) -> float:
    cfg = _cfg(arch)
    return max(_rel(res[f"{prefix}|{'/'.join(p)}"], w)
               for p, w in _ref_tree(want, f"grad|{arch}", cfg))


def test_fault_tp_left_out_doubles_the_gradient(world, jax_side):
    """(1, 2): without ``tp`` in the share every gradient is ×2."""
    _, want, _ = jax_side
    res = world("1x2")[0]
    assert _worst(res, want, "musicgen-medium", "grad|musicgen-medium") \
        <= GRAD_REL
    for p, w in _ref_tree(want, "grad|musicgen-medium",
                          _cfg("musicgen-medium")):
        got = res[f"fault|no_tp|grad|{'/'.join(p)}"]
        assert _rel(got, 2 * w) <= GRAD_REL and _rel(got, w) > 0.5, p


def test_fault_local_mask_count_is_caught(world, jax_side):
    """(4, 1) with uneven masks: the local count gives another loss and
    other gradients."""
    _, want, _ = jax_side
    res = world("4x1")[0]
    got = float(res["fault|local_count|loss"])
    assert abs(got / float(want["loss|gemma2-2b"]) - 1) > 100 * LOSS_RTOL
    assert _worst(res, want, "gemma2-2b", "fault|local_count|grad") \
        > 100 * GRAD_REL


def test_fault_reverse_all_to_all_zero_backward_is_caught(world, jax_side):
    """(2, 2): the reverse all-to-all's backward returning zeros leaves
    every expert's gradient wrong, and the router's below the last layer
    (the last router's gradient comes through the combine alone; the
    layers under it see a wrong gradient of their output)."""
    _, want, _ = jax_side
    res = world("2x2")[0]
    arch = "granite-moe-3b-a800m"
    cfg = _cfg(arch)
    bad = {p: _rel(res[f"fault|a2a_zero_bwd|grad|{'/'.join(p)}"], w)
           for p, w in _ref_tree(want, f"grad|{arch}", cfg)}
    checked = 0
    for path, e in bad.items():
        last = path[:2] == ("blocks", str(cfg.n_layers - 1))
        if path[-2:-1] == ("moe",) and (path[-1] != "router" or not last):
            assert e > 100 * GRAD_REL, (path, e)
            checked += 1
    assert checked == 4 * cfg.n_layers - 1


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codec_sees_the_logical_leaf(codec, world, jax_side):
    """(2, 2): the sharded round trip equals the round trip of the whole
    tree bit for bit (decoded gradient and residual); for int8, a shard's
    own blocks do not."""
    from repro_torch.optim import compress
    _, want, _ = jax_side
    res = world("2x2")[0]
    arch = "granite-moe-3b-a800m"
    cfg = _cfg(arch)
    whole = convert.lm_params_from_jax(_unflat(want, f"grad|{arch}"), cfg,
                                       "cpu")
    encode, decode = {"int8": (compress.int8_compress,
                               compress.int8_decompress),
                      "topk": (compress.topk_compress,
                               compress.topk_decompress)}[codec]
    msg, r = encode(whole, None)
    dec = decode(msg, whole)
    differs = 0
    for (path, d), (_, rr) in zip(T.flatten_with_path(dec),
                                  T.flatten_with_path(r)):
        key = "/".join(path)
        assert np.array_equal(res[f"codec|{codec}|logical|dec|{key}"],
                              d.numpy())
        assert np.array_equal(res[f"codec|{codec}|logical|res|{key}"],
                              rr.numpy())
        if codec == "int8":
            differs += not np.array_equal(
                res[f"codec|int8|shard_blocks|dec|{key}"], d.numpy())
    assert differs > 0 or codec == "topk"


def test_global_norm_counts_each_element_once(world, jax_side):
    """(2, 2): the sharded global norm is the whole tree's; counting a
    replicated dim on every rank gives a larger one."""
    from repro_torch import optim
    _, want, _ = jax_side
    ranks = world("2x2")
    arch = "granite-moe-3b-a800m"
    whole = convert.lm_params_from_jax(_unflat(want, f"grad|{arch}"),
                                       _cfg(arch), "cpu")
    norm = float(optim.global_norm(whole))
    got = float(_same_on_every_rank(ranks, "norm|mesh"))
    np.testing.assert_allclose(got, norm, rtol=1e-6)
    assert float(ranks[0]["norm|fault"]) > norm * (1 + 1e-3)


# ------------------------------------------------ shards without a world

class _Coordinate:
    """A ("data", "model") mesh seen from one coordinate: what
    ``shard_param`` reads (no process group)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.mesh = torch.empty(shape)
        self.coord = list(coord)

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("tag", ["2x2", "2x4"])
def test_reference_opt_state_shards_rebuild_the_whole(tag, jax_side):
    """``convert.opt_state_shard_from_jax`` gives each coordinate its
    block of the reference's moments (as ``lm_params_shard_from_jax``
    cuts params), and the blocks of every coordinate, placed back by
    their specs, rebuild the whole tree bit for bit."""
    from collections import namedtuple
    _, want, _ = jax_side
    arch = "granite-moe-3b-a800m"
    cfg = _cfg(arch)
    ref = _unflat(want, f"params|{arch}")
    state = namedtuple("State", "step m v")(np.int32(3), ref, ref)
    whole = convert.lm_params_from_jax(ref, cfg, "cpu")
    specs = SR.config_specs(cfg, _Coordinate(MESHES[tag], (0, 0)))
    rebuilt = T.tree_map(torch.zeros_like, whole)
    dp, tp = MESHES[tag]
    for d in range(dp):
        for m in range(tp):
            mesh = _Coordinate(MESHES[tag], (d, m))
            got = convert.opt_state_shard_from_jax(state, cfg, mesh,
                                                   device="cpu")
            assert got.step == 3
            cut = convert.lm_params_shard_from_jax(ref, cfg, mesh,
                                                   device="cpu")
            for a, b in zip(T.leaves(got.m), T.leaves(cut)):
                assert torch.equal(a, b)
            T.tree_map(lambda r, x, spec: _place(r, x, spec, mesh), rebuilt,
                       got.v, specs)
    for a, b in zip(T.leaves(rebuilt), T.leaves(whole)):
        assert torch.equal(a, b)


def _place(whole, block, spec, mesh):
    """Write ``block`` where ``shard_param`` cut it from ``whole``."""
    from repro_torch.core import sharding as SH
    SH.shard_param(whole, spec, mesh).copy_(block)
