"""Training on a mesh with the reference's split of the work: ``lm.loss_fn``
on a mesh computes each rank's heads, ff columns, ``d_inner`` channels and
vocab columns (K6-LSE / K7 and K9 / K9-bwd on the rank's share, the
vocab-parallel cross-entropy), held to the JAX package.

The reference runs once, in one subprocess with 8 fake CPU devices,
``kernels="ref"`` and float32: for each case the host's
``jax.value_and_grad(loss_fn(p, batch, cfg, None))``, its
``jit(loss_fn(p, batch, cfg, mesh))`` with params placed under
``ShardingRules.param_specs`` on each world the case runs on, and three
host train steps (``jit(make_train_step(cfg, s))``).  The port runs each
mesh ("data", "model") as a gloo world of spawned processes, each rank
with its shards of the reference's params and its data rank's rows.

Cases (SMOKE configs): the eight trained families (gemma2, minicpm,
nemotron, granite-moe with the roomy embedding at capacity factor 8 so no
pair drops, falcon-mamba, zamba2, musicgen, qwen2-vl) on (1, 2), (1, 4)
and (2, 2), where every family's heads split over ``model``; on (1, 8),
where 4 heads do not divide 8, minicpm at a batch that tiles the grid
(``_attn_act_spec``'s batch branch) and gemma2 at 4 rows (the sequence
branch: its local layers' window, the softcap and the offset join under a
gradient).

Tolerances: the loss within rtol 2e-5 of the host's and of the
reference's mesh loss; each gradient leaf, gathered, within ‖Δ‖ ≤ 1e-4
‖g‖ of the host's; three train steps on (2, 2): the losses within 2e-5,
each param leaf within 1e-4.  Spies show the split: the plain versions of
K6-LSE and K7 see n_heads / tp heads (or the act-spec share), K9's and
K9-bwd's d_inner / tp channels, no block leaf is gathered over ``model``
(``gather_param`` is not called, and no ``all_gather`` over ``model``
takes a block leaf's shard), and the logits a rank holds are V / tp wide.
Planted faults must read past the gates: the row-parallel all-reduce's
backward made the identity, ``gather_fsdp``'s sum over ``model`` left
out, and the sequence join's backward fed each piece its own O and LSE.
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
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "1x8": (1, 8)}
FAMILIES = ("gemma2", "minicpm", "nemotron", "granite_moe", "falcon_mamba",
            "zamba2", "musicgen", "qwen2_vl")
# case: (arch, config overrides, batch rows)
CASES = {"gemma2": ("gemma2-2b", {}, 8),
         "minicpm": ("minicpm-2b", {}, 8),
         "nemotron": ("nemotron-4-15b", {}, 8),
         "granite_moe": ("granite-moe-3b-a800m",
                         {"embedding_dispatch": "roomy",
                          "capacity_factor": 8.0}, 8),
         "falcon_mamba": ("falcon-mamba-7b", {}, 8),
         "zamba2": ("zamba2-1.2b", {}, 8),
         "musicgen": ("musicgen-medium", {}, 8),
         "qwen2_vl": ("qwen2-vl-2b", {}, 8),
         "gemma2_seq": ("gemma2-2b", {}, 4)}
ON = {"1x2": FAMILIES, "1x4": FAMILIES, "2x2": FAMILIES,
      "1x8": ("minicpm", "gemma2_seq")}
S = 16
STEPS = dict(batch=8, seq=16, steps=3, lr=1e-3, warmup_steps=1,
             grad_compression="none")
LOSS_RTOL, GRAD_REL, PARAM_REL = 2e-5, 1e-4, 1e-4
# planted fault: (mesh, case)
FAULTS = {"identity_all_reduce_bwd": ("1x2", "gemma2"),
          "fsdp_no_model_sum": ("1x2", "gemma2"),
          "join_own_o_lse": ("1x8", "gemma2_seq")}


def _cfg(case):
    arch, over, _ = CASES[case]
    return get_config(arch, smoke=True).replace(kernels="ref",
                                                dtype="float32", **over)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uneven(b: dict) -> dict:
    """Row r drops its first 2r labels: the data ranks' mask counts
    differ."""
    labels = b["labels"].copy()
    for r in range(labels.shape[0]):
        labels[r, :2 * r] = -1
    return {"inputs": dict(b["inputs"]), "labels": labels}


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
    for case, (_, _, b) in CASES.items():
        _flat(_uneven(make_batch(_cfg(case), 35, 0, b, S)), f"batch|{case}",
              out)
    return out


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from repro import optim
from repro.configs import get_config
from repro.data.pipeline import make_batch
from repro.distributed.sharding_rules import ShardingRules, named
from repro.models import lm
from repro.runtime import train_loop as jtrain

CASES, MESHES, ON, FAMILIES, STEPS = {cases}, {meshes}, {on}, {families}, {steps}
def cfg_of(case):
    arch, over, _ = CASES[case]
    return get_config(arch, smoke=True).replace(kernels="ref",
                                                dtype="float32", **over)

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
meshes = {{tag: mesh_of(shape) for tag, shape in MESHES.items()}}
for case in CASES:
    cfg = cfg_of(case)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    batch = unflat(g, "batch|" + case)
    flat(params, "params|" + case, out)
    loss, grads = host_grad(params, batch, cfg, None)
    out["loss|" + case] = loss
    flat(grads, "grad|" + case, out)
    for tag in MESHES:
        if case not in ON[tag]:
            continue
        mesh = meshes[tag]
        specs = ShardingRules(cfg, mesh).param_specs(
            jax.eval_shape(lambda: params))
        placed = jax.tree.map(jax.device_put, params, named(mesh, specs))
        out[f"mesh_loss|{{case}}|{{tag}}"] = mesh_loss(placed, batch, cfg,
                                                      mesh)
for case in FAMILIES:
    cfg = cfg_of(case)
    s = jtrain.TrainSettings(**STEPS)
    step_fn = jax.jit(jtrain.make_train_step(cfg, s))
    p = lm.init_params(cfg, jax.random.PRNGKey(0))
    opt, res = optim.init(p), jnp.zeros(())
    for step in range(s.steps):
        batch = make_batch(cfg, s.seed, step, s.batch, s.seq)
        batch["labels"] = batch["labels"].copy()
        for r in range(s.batch):
            batch["labels"][r, :2 * r] = -1
        batch = jax.tree.map(jnp.asarray, batch)
        p, opt, res, m = step_fn(p, opt, res, batch,
                                 jnp.asarray(step, jnp.int32))
        out[f"train|{{case}}|loss|{{step}}"] = m["loss"]
    flat(p, f"train|{{case}}|params", out)
np.savez("{root}/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("jax side ok")
"""


# --------------------------------------------------------- the port side

class Spy:
    """During the loss and its backward: the plain versions' calls of
    K6-LSE and K7 ((name, batch rows, q heads, kv heads)) and of K9 and
    K9-bwd ((name, batch rows, channels)); every ``all_gather`` over
    ``model`` (its input's shape and dim); the calls of
    ``gather_param``; the width of every logits tensor ``lm_head``
    returns."""

    def __init__(self):
        from repro_torch.core import sharding as SH
        from repro_torch.kernels import ref
        from repro_torch.models import lm
        self.patches = []
        self.attn, self.scan, self.gathers = [], [], []
        self.gather_param, self.logits = [], []

        def attn(name, fn):
            def call(q, k, *a, **kw):
                self.attn.append((name, q.shape[0], q.shape[1], k.shape[1]))
                return fn(q, k, *a, **kw)
            return call

        def scan(name, fn):
            def call(x, *a, **kw):
                self.scan.append((name, x.shape[0], x.shape[-1]))
                return fn(x, *a, **kw)
            return call

        def gather(fn):
            def call(x, mesh, axes, dim=0):
                if "model" in ((axes,) if isinstance(axes, str) else axes):
                    self.gathers.append((tuple(x.shape), dim))
                return fn(x, mesh, axes, dim)
            return call

        def head(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                self.logits.append(out.shape[-1])
                return out
            return call

        def param(fn):
            def call(*a, **kw):
                self.gather_param.append(1)
                return fn(*a, **kw)
            return call
        for mod, name, wrap in (
                (ref, "attention_lse_ref", attn("lse", ref.attention_lse_ref)),
                (ref, "flash_attention_bwd_ref",
                 attn("bwd", ref.flash_attention_bwd_ref)),
                (ref, "mamba_scan_chunks_plain",
                 scan("scan", ref.mamba_scan_chunks_plain)),
                (ref, "mamba_scan_bwd_plain",
                 scan("scan_bwd", ref.mamba_scan_bwd_plain)),
                (SH, "all_gather", gather(SH.all_gather)),
                (SH, "gather_param", param(SH.gather_param)),
                (lm, "lm_head", head(lm.lm_head))):
            self.patches.append((mod, name, getattr(mod, name), wrap))

    def __enter__(self):
        for mod, name, _, wrap in self.patches:
            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for mod, name, orig, _ in self.patches:
            setattr(mod, name, orig)

    def record(self) -> dict:
        names = ["lse", "bwd", "scan", "scan_bwd"]
        return {"attn": np.array([(names.index(n), b, h, k) for n, b, h, k
                                  in self.attn]).reshape(-1, 4),
                "scan": np.array([(names.index(n), b, c) for n, b, c
                                  in self.scan]).reshape(-1, 3),
                "gathers": np.array([list(s) + [-1] * (4 - len(s)) + [d]
                                     for s, d in self.gathers]
                                    ).reshape(-1, 5),
                "gather_param": np.array(len(self.gather_param)),
                "logits": np.array(self.logits)}


def _faulty(name):
    """The planted fault ``name`` installed (a context manager)."""
    import contextlib
    from repro_torch.core import sharding as SH
    from repro_torch.kernels import ops, ref

    @contextlib.contextmanager
    def patch(obj, attr, value):
        orig = getattr(obj, attr)
        setattr(obj, attr, value)
        try:
            yield
        finally:
            setattr(obj, attr, orig)

    def identity(ctx, g):
        return g, None

    def fsdp_no_model_sum(shard, spec, mesh):
        axes = tuple(a for a in SH._replicated_axes(mesh, spec)
                     if a != "model")
        x = SH.sum_grad(shard, mesh, axes)
        for dim, entry in enumerate(spec):
            ax = SH._entry_axes(entry)
            if ax and "model" not in ax:
                x = SH.all_gather(x, mesh, ax, dim)
        return x

    def own_o_lse(ctx, do):
        q, k, v, _, _ = ctx.saved_tensors
        s0, window, softcap, scale, _ = ctx.args
        dq, dk, dv = 0, torch.zeros_like(k), torch.zeros_like(v)
        for a, b, causal, w in ops.join_pieces(s0, window):
            kw = dict(causal=causal, window=w, softcap=softcap, scale=scale)
            o, lse = ref.attention_lse_ref(q, k[:, :, a:b], v[:, :, a:b],
                                           **kw)
            g = ref.flash_attention_bwd_ref(q, k[:, :, a:b], v[:, :, a:b],
                                            o, lse, do, **kw)
            dq = dq + g[0]
            dk[:, :, a:b] += g[1]
            dv[:, :, a:b] += g[2]
        return dq, dk, dv, None, None, None, None, None
    return {"identity_all_reduce_bwd": lambda: patch(
                SH._AllReduce, "backward", staticmethod(identity)),
            "fsdp_no_model_sum": lambda: patch(SH, "gather_fsdp",
                                               fsdp_no_model_sum),
            "join_own_o_lse": lambda: patch(ops._FlashJoin, "backward",
                                            staticmethod(own_o_lse))}[name]()


def _port_batch(g: dict, case: str):
    from repro_torch.data.pipeline import batch_to_torch
    return batch_to_torch(_unflat(g, f"batch|{case}"), "cpu")


def _loss_grads(store, g, case, mesh, spy=None):
    """(loss, the gradient gathered whole, the param shards) of ``case`` on
    ``mesh``; ``spy`` (a ``Spy``) watches the loss and its backward."""
    import contextlib
    from repro_torch.runtime.train_loop import data_rows, loss_and_grads
    cfg = _cfg(case)
    params = convert.lm_params_shard_from_jax(
        _unflat(store, f"params|{case}"), cfg, mesh, device="cpu")
    params = T.tree_map(lambda p: p.requires_grad_(True), params)
    batch = data_rows(_port_batch(g, case), mesh)
    with spy or contextlib.nullcontext():
        loss, grads = loss_and_grads(params, batch, cfg, mesh)
    whole = SR.gather_params(T.unflatten(params, grads),
                             SR.config_specs(cfg, mesh), mesh)
    return loss, whole, params


def _train(store, case, mesh, out):
    """Three train steps on ``mesh`` from the reference's params."""
    from repro_torch import optim
    from repro_torch.data.pipeline import batch_to_torch
    from repro_torch.runtime import TrainSettings
    from repro_torch.runtime import train_loop as TL
    cfg = _cfg(case)
    params = T.tree_map(lambda p: p.requires_grad_(True),
                        convert.lm_params_shard_from_jax(
                            _unflat(store, f"params|{case}"), cfg, mesh,
                            device="cpu"))
    opt = optim.init(params)
    s = TrainSettings(**STEPS)
    step_fn = TL.make_train_step(cfg, s, mesh)
    for step in range(s.steps):
        batch = batch_to_torch(TL.data_rows(_uneven(make_batch(
            cfg, s.seed, step, s.batch, s.seq)), mesh), "cpu")
        params, opt, _, m = step_fn(params, opt, None, batch, step)
        out[f"train|{case}|loss|{step}"] = m["loss"]
    whole = SR.gather_params(params, SR.config_specs(cfg, mesh), mesh)
    for path, x in T.flatten_with_path(whole):
        out[f"train|{case}|params|{'/'.join(path)}"] = x.detach()


def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    """One rank of the gloo world of mesh ``tag``: every case of
    ``ON[tag]`` (gathered gradients on rank 0 only), the faults planted
    on it, and on (2, 2) the train steps; results to
    ``root/torch_<tag>_<rank>.npz``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
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
        for case in ON[tag]:
            spy = Spy()
            loss, grads, shards = _loss_grads(store, g, case, mesh, spy)
            out[f"loss|{case}"] = loss
            keep(f"grad|{case}", grads)
            for k, v in spy.record().items():
                out[f"spy|{case}|{k}"] = v
            out[f"shards|{case}"] = np.array(sorted(
                {tuple(x.shape) + (-1,) * (3 - x.dim())
                 for x in T.leaves(shards["blocks"])}))
        for fault, (ftag, case) in FAULTS.items():
            if ftag == tag:
                with _faulty(fault):
                    loss, grads, _ = _loss_grads(store, g, case, mesh)
                out[f"fault|{fault}|loss"] = loss
                keep(f"fault|{fault}|grad", grads)
        if tag == "2x2":
            for case in FAMILIES:
                _train(store, case, mesh, out)
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.detach().numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    from conftest import run_multidev
    root = tmp_path_factory.mktemp("mesh_tp_train")
    np.savez(root / "inputs.npz", **_inputs())
    code = JAX_SIDE.format(cases=CASES, meshes=MESHES, on=ON,
                           families=FAMILIES, steps=STEPS, root=root)
    run_multidev(code, n_devices=8, timeout=600)
    return root, dict(np.load(root / "jax_out.npz"))


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Every mesh's gloo world, all spawned at once; each rank's results
    by mesh."""
    root = str(jax_side[0])
    ctxs = {tag: mp.start_processes(_torch_rank, args=(
        math.prod(shape), tag, root), nprocs=math.prod(shape), join=False,
        start_method="spawn") for tag, shape in MESHES.items()}
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for tag, ctx in ctxs.items():
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for p in c.processes:
                        p.kill()
                pytest.fail(f"gloo world {tag} did not finish in "
                            f"{WORLD_TIMEOUT_S} s")
    return {tag: [dict(np.load(f"{root}/torch_{tag}_{r}.npz"))
                  for r in range(math.prod(shape))]
            for tag, shape in MESHES.items()}


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _ref_tree(want: dict, prefix: str, case: str) -> list:
    """The reference's tree saved under ``prefix`` in the port's layout."""
    return list(T.flatten_with_path(convert.lm_params_from_jax(
        _unflat(want, prefix), _cfg(case), "cpu")))


def _worst(res: dict, want: dict, case: str, prefix: str) -> float:
    return max(_rel(res[f"{prefix}|{'/'.join(p)}"], w)
               for p, w in _ref_tree(want, f"grad|{case}", case))


PAIRS = [(tag, case) for tag in MESHES for case in ON[tag]]


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("tag,case", PAIRS)
def test_loss_matches_host_and_mesh_reference(tag, case, worlds, jax_side):
    _, want = jax_side
    ranks = worlds[tag]
    got = float(ranks[0][f"loss|{case}"])
    for r in ranks[1:]:
        assert float(r[f"loss|{case}"]) == got
    np.testing.assert_allclose(got, float(want[f"loss|{case}"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, float(want[f"mesh_loss|{case}|{tag}"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("tag,case", PAIRS)
def test_gradient_matches_host(tag, case, worlds, jax_side):
    """Each leaf of the gathered gradient within 1e-4 of the host's."""
    _, want = jax_side
    res = worlds[tag][0]
    leaves = _ref_tree(want, f"grad|{case}", case)
    assert len(leaves) == sum(k.startswith(f"grad|{case}|") for k in res)
    for path, w in leaves:
        got = res[f"grad|{case}|{'/'.join(path)}"]
        assert _rel(got, w) <= GRAD_REL, (path, _rel(got, w))


@pytest.mark.parametrize("case", FAMILIES)
def test_three_train_steps_match_host(case, worlds, jax_side):
    """(2, 2): three AdamW steps from the reference's params, the losses
    within 2e-5 and every param leaf within 1e-4 of the host's."""
    _, want = jax_side
    ranks = worlds["2x2"]
    for step in range(STEPS["steps"]):
        key = f"train|{case}|loss|{step}"
        got = float(ranks[0][key])
        assert all(float(r[key]) == got for r in ranks)
        np.testing.assert_allclose(got, float(want[key]), rtol=LOSS_RTOL)
    for path, w in _ref_tree(want, f"train|{case}|params", case):
        got = ranks[0][f"train|{case}|params|{'/'.join(path)}"]
        assert _rel(got, w) <= PARAM_REL, (path, _rel(got, w))


def _branch(case, tag):
    """The prefill branch attention takes: "heads", "batch" or "seq"."""
    from repro_torch.models import attention as A

    class Shape:
        shape = dict(zip(("data", "model"), MESHES[tag]))
    cfg, b = _cfg(case), CASES[case][2]
    dp, tp = MESHES[tag]
    if cfg.n_heads % tp == 0:
        return "heads"
    spec = A._attn_act_spec(cfg, Shape(), b, S)
    return "batch" if isinstance(spec[0][0], tuple) else "seq"


@pytest.mark.parametrize("tag,case", [(t, c) for t, c in PAIRS
                                      if _cfg(c).family != "ssm"])
def test_attention_kernels_see_the_ranks_share(tag, case, worlds):
    """The plain versions of K6-LSE (forward and the remat recompute) and
    K7: n_heads / tp q heads over the kv heads they read, on the data
    rank's rows; on (1, 8) the act-spec share: a block of the rows
    (batch), or of the query rows (sequence: K6-LSE on the diagonal block
    and on the keys before it, K7 on each)."""
    cfg = _cfg(case)
    dp, tp = MESHES[tag]
    rows = CASES[case][2] // dp
    hybrid = cfg.family == "hybrid"       # its shared block is not rematted
    layers = (cfg.n_layers if not hybrid else
              sum(1 for i in range(cfg.n_layers)
                  if (i + 1) % cfg.shared_attn_every == 0))
    fwd = layers * (1 if hybrid else 2)   # the forward and the recompute
    branch = _branch(case, tag)
    g = cfg.n_heads // cfg.n_kv_heads
    for m, res in enumerate(worlds[tag]):
        calls = res[f"spy|{case}|attn"]
        lse, bwd = calls[calls[:, 0] == 0], calls[calls[:, 0] == 1]
        if branch == "heads":
            hq = cfg.n_heads // tp
            assert len(lse) == fwd and len(bwd) == layers
            assert (calls[:, 1] == rows).all() and (calls[:, 2] == hq).all()
            assert (calls[:, 3] == max(1, hq // g)).all()
        elif branch == "batch":
            assert len(lse) == fwd and len(bwd) == layers
            assert (calls[:, 1] == rows // tp).all()
            assert (calls[:, 2] == cfg.n_heads).all()
        else:
            pieces = 1 if m % tp == 0 else 2
            assert len(lse) == fwd * pieces
            assert len(bwd) == layers * pieces
            assert (calls[:, 1] == rows).all()
            assert (calls[:, 2] == cfg.n_heads).all()


@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
def test_scan_kernels_see_the_ranks_channels(tag, worlds):
    """falcon-mamba: K9's plain version (forward and the remat recompute)
    and K9-bwd's on d_inner / tp channels of the data rank's rows."""
    cfg = _cfg("falcon_mamba")
    dp, tp = MESHES[tag]
    for res in worlds[tag]:
        calls = res["spy|falcon_mamba|scan"]
        assert (calls[:, 0] == 2).sum() == 2 * cfg.n_layers
        assert (calls[:, 0] == 3).sum() == cfg.n_layers
        assert (calls[:, 1] == CASES["falcon_mamba"][2] // dp).all()
        assert (calls[:, 2] == cfg.d_inner // tp).all()


@pytest.mark.parametrize("tag", list(MESHES))
def test_no_block_leaf_is_gathered_over_model(tag, worlds):
    """No ``gather_param`` in the loss, and no ``all_gather`` over
    ``model`` of a tensor shaped as a block leaf's shard (a block is
    gathered over its data axes alone; what ``model`` gathers are
    activations and, for the roomy embedding, the table)."""
    for res in worlds[tag]:
        for case in ON[tag]:
            assert int(res[f"spy|{case}|gather_param"]) == 0
            shards = {tuple(s[s >= 0]) for s in res[f"shards|{case}"]}
            for row in res[f"spy|{case}|gathers"]:
                shape = tuple(row[:4][row[:4] >= 0])
                assert shape not in shards, (case, shape)


@pytest.mark.parametrize("tag", list(MESHES))
def test_a_rank_holds_its_vocab_columns(tag, worlds):
    """The logits the loss computes are V / tp columns a rank (every
    shipped vocab is padded to a multiple of 256, which 2, 4 and 8
    divide)."""
    tp = MESHES[tag][1]
    for res in worlds[tag]:
        for case in ON[tag]:
            widths = res[f"spy|{case}|logits"]
            assert len(widths) == 1
            assert widths[0] == _cfg(case).vocab_padded // tp


def test_both_act_spec_branches_run_under_a_gradient():
    seen = {_branch(c, t) for t, c in PAIRS if _cfg(c).family != "ssm"}
    assert seen == {"heads", "batch", "seq"}
    assert _cfg("gemma2_seq").local_window < S


def test_fault_identity_all_reduce_backward_is_caught(worlds, jax_side):
    """(1, 2), gemma2: the row-parallel all-reduce's backward made the
    identity (Megatron's convention, mixed into this one) leaves the
    gradients below the last block's far from the host's; the loss, a
    forward, stays."""
    _, want = jax_side
    res = worlds["1x2"][0]
    assert _worst(res, want, "gemma2", "grad|gemma2") <= GRAD_REL
    assert _worst(res, want, "gemma2",
                  "fault|identity_all_reduce_bwd|grad") > 100 * GRAD_REL


def test_fault_fsdp_without_the_model_sum_is_caught(worlds, jax_side):
    """(1, 2), gemma2: ``gather_fsdp``'s backward without its sum over
    ``model`` leaves every replicated leaf (the norms) with one rank's
    part of its gradient."""
    _, want = jax_side
    res = worlds["1x2"][0]
    bad = {"/".join(p): _rel(res[f"fault|fsdp_no_model_sum|grad|"
                                 f"{'/'.join(p)}"], w)
           for p, w in _ref_tree(want, "grad|gemma2", "gemma2")}
    norms = [k for k in bad if k.split("/")[-1].startswith(
        ("ln", "post_ln", "final_norm"))]
    assert norms and all(bad[k] > 100 * GRAD_REL for k in norms), bad


def test_fault_join_fed_each_pieces_own_o_and_lse_is_caught(worlds,
                                                           jax_side):
    """(1, 8), gemma2 at 4 rows (the sequence branch): the join's
    backward fed each piece its own O and LSE drops the LSE's gradient
    where both pieces carry weight."""
    _, want = jax_side
    res = worlds["1x8"][0]
    assert _worst(res, want, "gemma2_seq", "grad|gemma2_seq") <= GRAD_REL
    assert _worst(res, want, "gemma2_seq",
                  "fault|join_own_o_lse|grad") > 100 * GRAD_REL
