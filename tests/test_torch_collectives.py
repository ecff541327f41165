"""Port parity: ``distributed/collectives.py`` (the cross-pod int8 and
float32 means) vs the JAX package, the differentiable collectives of
``core/sharding.py`` and ``core/delayed.py``, and ``launch/train.py
--tp 2`` under ``torchrun``.

The reference runs in one subprocess with 8 fake CPU devices (the
``multidev`` fixture), as ``tests/test_distributed.py:227-278`` sets it
up: musicgen-medium at SMOKE in float32, a (2, 2, 2) ("pod", "data",
"model") mesh, each pod's gradient from its half of the batch, reduced
inside ``shard_map`` manual over ``pod``.  It saves each pod's gradient,
the int8 mean and each pod's residual, and the float32 mean.  The port
runs the same mesh as a gloo world of 8 spawned processes: each rank
feeds its pod's gradient (carried with ``convert.lm_params_from_jax``)
to ``crosspod_int8_mean`` over ``axis_group(mesh, "pod")``.  The mean and
the residual match the reference's ``shard_map`` run eagerly bit for bit,
and what reaches the all-gather must be int8 blocks and float32 scales.
Under ``jit`` XLA rewrites the scale's division by 127 and fuses the
pods' sum into a fused multiply-add, so the jitted reference differs
from its own eager run by an ulp in places: the port is held to it
within 1e-6 of each leaf's largest value for the mean, and 1e-4 for the
residual (a scale an ulp off moves a block's residual by up to 127
ulps of the scale, ~1.6e-5 of the residual's largest value).

The same world holds the collectives' adjoints: ``gather_param`` and
``shard_param`` are inverse under every kind of spec, the gradient of a
shard through ``gather_param`` is its cut of the gradient summed over the
whole mesh, and ``delayed.exchange``'s backward is the reverse
all-to-all.
"""
import datetime
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_config

from test_torch_mesh_train import _unflat, run_world

WORLD_TIMEOUT_S = 180
SHAPE = (2, 2, 2)
NAMES = ("pod", "data", "model")
B, S = 8, 16
SPECS = {"data_model": ("data", "model"),
         "flat_dim1": (None, ("data", "model")),
         "pod_data": (("pod", "data"), None),
         "replicated": ()}
WHOLE = (8, 12)


def _cfg():
    return get_config("musicgen-medium", smoke=True).replace(
        kernels="ref", dtype="float32")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    cfg = _cfg()
    return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.models import init_params, loss_fn
from repro.distributed.collectives import (crosspod_int8_mean,
                                           crosspod_f32_mean)

def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, prefix + "|" + k, out)
    else:
        out[prefix] = np.asarray(tree)

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
cfg = get_config("musicgen-medium", smoke=True).replace(
    kernels="ref", dtype="float32")
params = init_params(cfg, jax.random.PRNGKey(0))
g = dict(np.load("{root}/inputs.npz"))
b, s = g["embeds"].shape[:2]
out = {{}}
pods = []
for pod in range(2):
    rows = slice(pod * b // 2, (pod + 1) * b // 2)
    batch = {{"inputs": {{"embeds": jnp.asarray(g["embeds"][rows]),
                         "positions": jnp.tile(jnp.arange(s)[None],
                                               (b // 2, 1))}},
             "labels": jnp.asarray(g["labels"][rows])}}
    grads = jax.grad(lambda p: loss_fn(p, batch, cfg, None))(params)
    flat(grads, f"grad|{{pod}}", out)
    pods.append(grads)
stacked = jax.tree.map(lambda *x: jnp.stack(x), *pods)

def per_pod(reducer, mesh=mesh):
    def fn(g):
        mean, res = reducer(jax.tree.map(lambda x: x[0], g), "pod")
        res = (jax.tree.map(lambda x: x[None], res) if res is not None
               else jax.tree.map(lambda x: jnp.zeros((1,), x.dtype), g))
        return mean, res
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(jax.tree.map(lambda _: P("pod"), stacked),),
        out_specs=(jax.tree.map(lambda _: P(), params),
                   jax.tree.map(lambda _: P("pod"), params)),
        axis_names={{"pod"}}, check_vma=False)
# eagerly (each op compiled alone) on the pod axis by itself, which an
# eager shard_map needs manual; under jit on the reference test's mesh
pods_mesh = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2],
                          axis_types=(jax.sharding.AxisType.Auto,))
for tag, run in (("eager", per_pod(crosspod_int8_mean, pods_mesh)),
                 ("jit", jax.jit(per_pod(crosspod_int8_mean)))):
    mean, res = run(stacked)
    flat(mean, f"int8_mean|{{tag}}", out)
    for pod in range(2):
        flat(jax.tree.map(lambda x: x[pod], res), f"int8_res|{{tag}}|{{pod}}",
             out)
mean32, _ = jax.jit(per_pod(crosspod_f32_mean))(stacked)
flat(mean32, "f32_mean", out)
flat(params, "params", out)
np.savez("{root}/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("jax side ok")
"""


def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import delayed
    from repro_torch.core import sharding as SH
    from repro_torch.distributed.collectives import (crosspod_f32_mean,
                                                     crosspod_int8_mean)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{tag}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=NAMES)
        store = dict(np.load(f"{root}/jax_out.npz"))
        cfg = _cfg()
        group, pod, _ = SH.axis_group(mesh, "pod")
        grads = convert.lm_params_from_jax(_unflat(store, f"grad|{pod}"),
                                           cfg, "cpu")
        wire, orig = [], SH._ALL_GATHER

        def seen(out_t, in_t, group=None):
            wire.append((str(in_t.dtype), in_t.numel() * in_t.element_size()))
            return orig(out_t, in_t, group=group)
        SH._ALL_GATHER = seen
        try:
            mean, res = crosspod_int8_mean(grads, group)
        finally:
            SH._ALL_GATHER = orig
        mean32, none = crosspod_f32_mean(grads, group)
        out = {"pod": np.array(pod), "f32_none": np.array(none is None),
               "wire_dtypes": np.array([d for d, _ in wire]),
               "wire_bytes": np.array([n for _, n in wire])}
        for key, tree in (("int8_mean", mean), ("int8_res", res),
                          ("f32_mean", mean32)):
            for path, x in T.flatten_with_path(tree):
                out[f"{key}|{'|'.join(path)}"] = x.numpy()
        # the adjoints: gather_param / shard_param and exchange
        gen = torch.Generator().manual_seed(rank)
        index = torch.arange(math.prod(WHOLE), dtype=torch.float32).reshape(
            WHOLE)
        common = torch.randn(WHOLE, generator=torch.Generator().manual_seed(
            99))
        for name, spec in SPECS.items():
            shard = SH.shard_param(index, spec, mesh)
            out[f"same|{name}"] = np.array(torch.equal(
                SH.gather_param(shard, spec, mesh), index))
            out[f"cut|{name}"] = shard.long()
            x = SH.shard_param(common, spec, mesh).clone().requires_grad_(True)
            y = torch.randn(WHOLE, generator=gen)
            full = SH.gather_param(x, spec, mesh)
            (gx,) = torch.autograd.grad((full * y).sum(), x)
            out[f"full|{name}"], out[f"y|{name}"] = full.detach(), y
            out[f"grad|{name}"] = gx
        # reduce_scatter: this coordinate's block of the sum over "data",
        # its backward the all-gather of the gradient
        z = torch.randn((4, 6), generator=gen).requires_grad_(True)
        part = SH.reduce_scatter(z, mesh, "data", 1)
        (gz,) = torch.autograd.grad((part * part.detach()).sum(), z)
        out["rs|z"], out["rs|part"] = z.detach(), part.detach()
        out["rs|grad"] = gz
        out["rs|data"] = np.array(SH.axis_index(mesh, "data"))
        xs = torch.randn((8, 3, 5), generator=gen).requires_grad_(True)
        ys = torch.randn((8, 3, 5), generator=gen)
        sent = delayed.exchange(xs, None)
        (gx,) = torch.autograd.grad((sent * ys).sum(), xs)
        out["exchange|grad_is_reverse"] = np.array(torch.equal(
            gx, delayed.exchange(ys, None)))
        out["exchange|adj"] = np.array([float((sent * ys).sum()),
                                        float((xs * gx).sum())])
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from conftest import run_multidev
    root = tmp_path_factory.mktemp("collectives")
    np.savez(root / "inputs.npz", **_inputs())
    run_multidev(JAX_SIDE.format(root=root), n_devices=8, timeout=600)
    run_world(_torch_rank, "2x2x2", 8, str(root), WORLD_TIMEOUT_S)
    return (dict(np.load(root / "jax_out.npz")),
            [dict(np.load(root / f"torch_2x2x2_{r}.npz")) for r in range(8)])


def _tree(store, prefix):
    return convert.lm_params_from_jax(_unflat(store, prefix), _cfg(), "cpu")


@pytest.mark.parametrize("rank", range(8))
def test_int8_mean_and_residual_bit_for_bit(rank, sides):
    want, ranks = sides
    res = ranks[rank]
    pod = int(res["pod"])
    assert pod == rank // 4
    for key, ref in (("int8_mean", "int8_mean|eager"),
                     ("int8_res", f"int8_res|eager|{pod}")):
        for path, w in T.flatten_with_path(_tree(want, ref)):
            got = res[f"{key}|{'|'.join(path)}"]
            assert got.dtype == np.float32
            assert np.array_equal(got, w.numpy()), (key, path)


@pytest.mark.parametrize("rank", [0, 7])
def test_int8_mean_and_residual_match_jitted_reference(rank, sides):
    want, ranks = sides
    res = ranks[rank]
    pod = int(res["pod"])
    for key, ref, tol in (("int8_mean", "int8_mean|jit", 1e-6),
                          ("int8_res", f"int8_res|jit|{pod}", 1e-4)):
        for path, w in T.flatten_with_path(_tree(want, ref)):
            got = res[f"{key}|{'|'.join(path)}"]
            top = float(np.abs(w.numpy()).max())
            assert np.abs(got - w.numpy()).max() <= tol * top, (key, path)


def test_int8_wire_carries_int8_blocks_and_f32_scales(sides):
    """Each leaf of the reference's layout puts its int8 blocks of 256 and
    its float32 scales, one a block, on the pod all-gather: about a
    quarter of the bytes of the float32 gradient."""
    want, ranks = sides
    n = [int(np.asarray(v).size) for k, v in want.items()
         if k.startswith("params|")]
    blocks = [-(-m // 256) for m in n]
    for res in ranks:
        dtypes, nbytes = list(res["wire_dtypes"]), list(res["wire_bytes"])
        assert dtypes == ["torch.int8", "torch.float32"] * len(n)
        assert sorted(nbytes[0::2]) == sorted(256 * b for b in blocks)
        assert sorted(nbytes[1::2]) == sorted(4 * b for b in blocks)
        assert sum(nbytes) < 0.27 * 4 * sum(n)


@pytest.mark.parametrize("rank", range(8))
def test_f32_mean_matches_reference(rank, sides):
    want, ranks = sides
    res = ranks[rank]
    assert bool(res["f32_none"])
    for path, w in T.flatten_with_path(_tree(want, "f32_mean")):
        np.testing.assert_allclose(res[f"f32_mean|{'|'.join(path)}"],
                                   w.numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", list(SPECS))
def test_gather_param_inverts_shard_param_and_sums_the_mesh(name, sides):
    """Every rank rebuilds the whole leaf from its shard (1/k of it over k
    ranks); and the gradient of a shard through ``gather_param`` is that
    shard's cut of the gradient summed over the whole mesh: rank r's
    ∂⟨gather(x), y_r⟩ summed over r, the rule every train-step gradient
    rests on."""
    _, ranks = sides
    k = math.prod(dict(zip(NAMES, SHAPE))[a] for e in SPECS[name]
                  for a in ((e,) if isinstance(e, str) else e or ()))
    total = sum(r[f"y|{name}"].astype(np.float64) for r in ranks)
    full = ranks[0][f"full|{name}"]
    for res in ranks:
        assert bool(res[f"same|{name}"])
        cut = res[f"cut|{name}"]
        assert cut.size == math.prod(WHOLE) // k
        assert np.array_equal(res[f"full|{name}"], full)
        np.testing.assert_allclose(res[f"grad|{name}"],
                                   total.reshape(-1)[cut], rtol=1e-5,
                                   atol=1e-5)


def test_reduce_scatter_sums_and_its_backward_gathers(sides):
    """``reduce_scatter`` over "data" along dim 1: each coordinate's block
    of the sum of its data group's inputs; the gradient of ⟨block, c⟩ is
    c's blocks gathered back, the same on every rank of the group."""
    _, ranks = sides
    for r, res in enumerate(ranks):
        group = [q for q in range(8) if q // 4 == r // 4 and q % 2 == r % 2]
        total = sum(ranks[q]["rs|z"] for q in group)
        i = int(res["rs|data"])
        np.testing.assert_allclose(res["rs|part"], total[:, 3 * i:3 * i + 3],
                                   rtol=1e-6)
        whole = np.concatenate([ranks[q]["rs|part"] for q in group], 1)
        np.testing.assert_allclose(res["rs|grad"], whole, rtol=1e-6)


def test_exchange_backward_is_the_reverse_all_to_all(sides):
    _, ranks = sides
    lhs = sum(float(r["exchange|adj"][0]) for r in ranks)
    rhs = sum(float(r["exchange|adj"][1]) for r in ranks)
    for res in ranks:
        assert bool(res["exchange|grad_is_reverse"])
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


# ------------------------------------------------ the launcher, --tp 2

def test_launch_train_tp2_under_torchrun_matches_no_mesh(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --tp 2
    --device cpu --smoke``: a gloo world of 2 on a (1, 2) mesh trains,
    and its final loss is the run with no mesh's within 1e-5."""
    from repro_torch.launch import train as tlaunch
    args = ["--arch", "gemma2-2b", "--smoke", "--steps", "3", "--batch",
            "4", "--seq", "16", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *args, "--tp", "2"], capture_output=True, text=True, timeout=300,
        env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    finals = [float(line.split()[2]) for line in proc.stdout.splitlines()
              if line.startswith("final loss")]
    assert len(finals) == 2 and finals[0] == finals[1]
    one = tlaunch.main(args)
    np.testing.assert_allclose(finals[0], one["losses"][-1], rtol=1e-5)


def test_launch_train_tp2_needs_a_process_group():
    from repro_torch.launch import train as tlaunch
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
           if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="process group"):
            tlaunch.main(["--arch", "gemma2-2b", "--smoke", "--tp", "2",
                          "--device", "cpu"])
    finally:
        os.environ.update(env)
