"""The mamba mixers split over ``model`` by ``d_inner`` channels in
serving: falcon-mamba (mamba1, K9) and zamba2 (mamba2, the SSD form)
served from each rank's param shards (``lm.prefill`` / ``lm.decode_step``
with ``mesh=``), vs the reference's ``jax.jit(lm.prefill /
lm.decode_step)`` with its params placed under
``ShardingRules.param_specs`` and its inputs over the data axes, on fake
CPU devices.

The reference runs once, in one subprocess with 8 fake CPU devices,
``kernels="ref"`` and float32: each case's prefill, then ``STEPS`` greedy
decode steps fed its own argmax; its global caches after the prefill.
The port runs each mesh ("data", "model") as a gloo world (spawned, all
at once), each rank passing the same global inputs with its
``shard_params`` shards.  Meshes: (1, 2), (1, 4), (2, 2).

Tolerances: the logits of the prefill and of each step within 2e-4 (abs
+ rel) of the reference's, the greedy tokens identical; each rank's
prefill state of every layer within 1e-4 of its cut of the reference's
global one: its data rank's rows, its model rank's channels of ``h``,
and of ``conv`` its channels (mamba1) or its x channels with B and C
(mamba2), the layout ``lm.make_cache`` allocates.  Spies show the split:
K9's plain version sees d_inner / tp channels (falcon-mamba), the SSD
form H / tp heads (zamba2), and no block leaf is gathered over
``model``.  A planted fault, mamba1's ``x_proj`` all-reduce skipped,
reads far past the tolerance.
"""
import datetime
import math
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import sharding_rules as SR

WORLD_TIMEOUT_S = 240
STEPS = 4
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
# case: (arch, batch, prompt length, max_len)
CASES = {"falcon_mamba": ("falcon-mamba-7b", 4, 8, 128),
         "zamba2": ("zamba2-1.2b", 4, 6, 128)}
PAIRS = [(tag, case) for tag in MESHES for case in CASES]


def _cfg(case):
    return get_config(CASES[case][0], smoke=True).replace(kernels="ref",
                                                          dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs() -> dict:
    rng = np.random.default_rng(35)
    return {case: rng.integers(0, _cfg(case).vocab_size, (b, s))
            for case, (_, b, s, _) in CASES.items()}


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding_rules import ShardingRules, named
from repro.models import lm

prefill = jax.jit(lm.prefill, static_argnums=(2, 3),
                  static_argnames=("max_len",))
decode_step = jax.jit(lm.decode_step, static_argnums=(3, 4))
CASES, MESHES, STEPS = {cases}, {meshes}, {steps}
def cfg_of(case):
    return get_config(CASES[case][0], smoke=True).replace(kernels="ref",
                                                          dtype="float32")

def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, prefix + "|" + k, out)
    else:
        out[prefix] = np.asarray(tree)

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

def rows(x, mesh):
    spec = P("data") if x.shape[0] % mesh.shape["data"] == 0 else P()
    return jax.device_put(x, NamedSharding(mesh, spec))

g = dict(np.load("{root}/inputs.npz"))
out = {{}}
for case in CASES:
    cfg, (_, b, s, max_len) = cfg_of(case), CASES[case]
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    flat(params, "params|" + case, out)
    pos = jnp.tile(jnp.arange(s)[None], (b, 1))
    for tag, shape in MESHES.items():
        mesh = mesh_of(shape)
        specs = ShardingRules(cfg, mesh).param_specs(
            jax.eval_shape(lambda: params))
        placed = jax.tree.map(jax.device_put, params, named(mesh, specs))
        lg, caches = prefill(placed, {{"tokens": rows(jnp.asarray(g[case]),
                                                      mesh),
                                      "positions": rows(pos, mesh)}},
                             cfg, mesh, max_len=max_len)
        if case + "|conv" not in out:          # the global states, once
            out[case + "|conv"] = caches["ssm"].conv
            out[case + "|h"] = caches["ssm"].h
        res, toks = [np.asarray(lg)[:, -1]], []
        for t in range(STEPS):
            tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            lg, caches = decode_step(
                placed, {{"tokens": rows(tok, mesh),
                          "positions": rows(jnp.zeros_like(tok), mesh)}},
                caches, cfg, mesh)
            res.append(np.asarray(lg)[:, -1])
        out[f"{{case}}|{{tag}}"] = np.stack(res)
        out[f"{{case}}|{{tag}}|toks"] = np.concatenate(toks, 1)
np.savez("{root}/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("jax side ok")
"""


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


def serve(params, cfg, prompt, max_len, mesh=None, steps=STEPS):
    """prefill, then ``steps`` greedy donated decode steps: (the last
    logits of every call (1 + T, B, V), the tokens chosen (B, T), the
    prefill's SSM states)."""
    from repro_torch.models import lm
    b, s = prompt.shape
    pos = torch.arange(s)[None].expand(b, s)
    with torch.no_grad():
        lg, caches = lm.prefill(params, {"tokens": prompt, "positions": pos},
                                cfg, mesh, max_len=max_len)
        first = [tuple(t.clone() for t in st) for st in caches["ssm"]]
        res, toks = [lg[:, -1]], []
        for _ in range(steps):
            tok = lg[:, -1:].argmax(-1)
            toks.append(tok)
            lg, caches = lm.decode_step(
                params, {"tokens": tok, "positions": torch.zeros_like(tok)},
                caches, cfg, mesh, donate=True)
            res.append(lg[:, -1])
    toks = torch.cat(toks, 1) if toks else torch.zeros((b, 0))
    return torch.stack(res), toks, first


class Spy:
    """The plain scan's and the SSD form's calls ((name, batch rows,
    channels or heads)), every ``all_gather`` over ``model`` (its input's
    shape) and the calls of ``gather_param``."""

    def __init__(self):
        from repro_torch.core import sharding as SH
        from repro_torch.kernels import ref
        self.calls, self.gathers, self.params = [], [], []

        def scan(x, *a, **kw):
            self.calls.append((0, x.shape[0], x.shape[-1]))
            return self.orig[1](x, *a, **kw)

        def ssd(x, *a, **kw):
            self.calls.append((1, x.shape[0], x.shape[2]))
            return self.orig[2](x, *a, **kw)

        def gather(x, mesh, axes, dim=0):
            if "model" in ((axes,) if isinstance(axes, str) else axes):
                self.gathers.append(tuple(x.shape))
            return self.orig[3](x, mesh, axes, dim)

        def param(*a, **kw):
            self.params.append(1)
            return self.orig[4](*a, **kw)
        self.where = [(ref, "mamba_scan_plain", scan),
                      (ref, "mamba2_ssd", ssd), (SH, "all_gather", gather),
                      (SH, "gather_param", param)]
        self.orig = [None] + [getattr(m, n) for m, n, _ in self.where]

    def __enter__(self):
        for m, n, fn in self.where:
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.where, self.orig[1:]):
            setattr(m, n, fn)


def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    """One rank of the gloo world of mesh ``tag``: every case; on (1, 2)
    the planted fault too; results to ``root/torch_<tag>_<rank>.npz``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.models import ssm
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{tag}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        mesh = M.make_host_mesh(tp=MESHES[tag][1], device="cpu")
        g = dict(np.load(f"{root}/inputs.npz"))
        store = dict(np.load(f"{root}/jax_out.npz"))
        out = {}
        for case in CASES:
            cfg, max_len = _cfg(case), CASES[case][3]
            whole = convert.lm_params_from_jax(
                _unflat(store, "params|" + case), cfg, device="cpu")
            specs = SR.config_specs(cfg, mesh)
            shards = SR.shard_params(whole, specs, mesh)
            prompt = torch.from_numpy(g[case])
            with Spy() as spy:
                lg, toks, first = serve(shards, cfg, prompt, max_len, mesh)
            out[case], out[f"{case}|toks"] = lg, toks
            for i, (conv, h) in enumerate(first):
                out[f"{case}|conv|{i}"], out[f"{case}|h|{i}"] = conv, h
            out[f"{case}|calls"] = np.array(spy.calls).reshape(-1, 3)
            out[f"{case}|gathers"] = np.array(
                [list(s) + [-1] * (4 - len(s)) for s in spy.gathers]
            ).reshape(-1, 4)
            out[f"{case}|gather_param"] = np.array(len(spy.params))
            out[f"{case}|shards"] = np.array(sorted(
                {tuple(x.shape) + (-1,) * (3 - x.dim())
                 for blk in shards["blocks"] for x in blk["mamba"].values()}))
            if tag == "1x2" and case == "falcon_mamba":
                orig = ssm._x_proj_sum
                ssm._x_proj_sum = lambda x, mesh: x
                try:
                    out["fault"], _, bad = serve(shards, cfg, prompt,
                                                 max_len, mesh, steps=0)
                    out["fault|h|0"] = bad[0][1]
                finally:
                    ssm._x_proj_sum = orig
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    from conftest import run_multidev
    root = tmp_path_factory.mktemp("mesh_tp_ssm")
    np.savez(root / "inputs.npz", **_inputs())
    code = JAX_SIDE.format(cases=CASES, meshes=MESHES, steps=STEPS,
                           root=root)
    run_multidev(code, n_devices=8, timeout=600)
    return root, dict(np.load(root / "jax_out.npz"))


@pytest.fixture(scope="module")
def worlds(jax_side):
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


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("tag,case", PAIRS)
def test_serving_matches_the_sharded_reference(tag, case, worlds, jax_side):
    """The prefill's and every decode step's logits within 2e-4 of the
    reference's jitted, sharded run, the greedy tokens identical, and
    every rank the same."""
    _, want = jax_side
    ranks = worlds[tag]
    for r in ranks:
        _close(r[case], want[f"{case}|{tag}"])
        np.testing.assert_array_equal(r[f"{case}|toks"],
                                      want[f"{case}|{tag}|toks"])
        np.testing.assert_array_equal(r[case], ranks[0][case])


def _channels(case, m, tp, width):
    """The global conv channels model rank m of tp holds: its block of
    d_inner, then for mamba2 (conv over [x | B | C]) all of B and C."""
    di = _cfg(case).d_inner
    mine = list(range(m * di // tp, (m + 1) * di // tp))
    return mine + list(range(di, width))


@pytest.mark.parametrize("tag,case", PAIRS)
def test_each_rank_holds_its_channels_of_the_states(tag, case, worlds,
                                                     jax_side):
    """Every layer's prefill state on every rank: its data rank's rows and
    its model rank's channels of the reference's global ``h`` and
    ``conv``, within 1e-4; the shapes ``lm.make_cache`` allocates."""
    from repro_torch.models import ssm
    _, want = jax_side
    dp, tp = MESHES[tag]
    cfg = _cfg(case)
    conv, h = want[f"{case}|conv"], want[f"{case}|h"]
    b = conv.shape[1]
    per = b // dp
    for rank, res in enumerate(worlds[tag]):
        d, m = divmod(rank, tp)
        rows = slice(d * per, (d + 1) * per)
        cols = _channels(case, m, tp, conv.shape[-1])
        hc = slice(m * cfg.d_inner // tp, (m + 1) * cfg.d_inner // tp)
        for i in range(cfg.n_layers):
            _close(res[f"{case}|conv|{i}"], conv[i][rows][..., cols], 1e-4)
            _close(res[f"{case}|h|{i}"], h[i][rows][:, hc], 1e-4)
        version = 1 if cfg.family == "ssm" else 2
        empty = ssm.init_ssm_state(cfg, per, "cpu", version,
                                   cfg.d_inner // tp)
        assert res[f"{case}|conv|0"].shape == tuple(empty.conv.shape)
        assert res[f"{case}|h|0"].shape == tuple(empty.h.shape)


@pytest.mark.parametrize("tag,case", PAIRS)
def test_the_scan_sees_the_ranks_channels(tag, case, worlds):
    """falcon-mamba: the prefill's K9 (plain version) on d_inner / tp
    channels of the data rank's rows, once a layer; zamba2: the SSD form
    on H / tp heads."""
    dp, tp = MESHES[tag]
    cfg = _cfg(case)
    rows = CASES[case][1] // dp
    for res in worlds[tag]:
        calls = res[f"{case}|calls"]
        assert len(calls) == cfg.n_layers
        assert (calls[:, 1] == rows).all()
        if cfg.family == "ssm":
            assert (calls[:, 0] == 0).all()
            assert (calls[:, 2] == cfg.d_inner // tp).all()
        else:
            heads = cfg.d_inner // cfg.mamba2_head_dim
            assert (calls[:, 0] == 1).all()
            assert (calls[:, 2] == heads // tp).all()


@pytest.mark.parametrize("tag", list(MESHES))
def test_no_mixer_leaf_is_gathered_over_model(tag, worlds):
    """No ``gather_param``, and no ``all_gather`` over ``model`` of a
    tensor shaped as a mixer leaf's shard: the concatenated leaves are
    regrouped by one all-to-all, the others used as they are stored or
    cut."""
    for res in worlds[tag]:
        for case in CASES:
            assert int(res[f"{case}|gather_param"]) == 0
            shards = {tuple(s[s >= 0]) for s in res[f"{case}|shards"]}
            for row in res[f"{case}|gathers"]:
                assert tuple(row[row >= 0]) not in shards, (case, row)


def test_fault_x_proj_all_reduce_skipped_reads_past_the_tolerance(
        worlds, jax_side):
    """falcon-mamba on (1, 2) with ``x_proj``'s all-reduce skipped (each
    rank's dt, B and C from its channels alone): the first layer's scan
    state leaves the reference's by far more than the 1e-4 the sound run
    keeps, and the logits move (at SMOKE's random weights the skip path
    x·D carries most of the output, so they move less)."""
    _, want = jax_side
    res = worlds["1x2"][0]
    cfg = _cfg("falcon_mamba")
    ref = want["falcon_mamba|h"][0][:, :cfg.d_inner // 2]
    _close(res["falcon_mamba|h|0"], ref, 1e-4)
    bad = res["fault|h|0"]
    rel = np.linalg.norm(bad - ref) / np.linalg.norm(ref)
    assert rel > 100 * 1e-4, rel
    assert np.abs(res["fault"] - want["falcon_mamba|1x2"][:1]).max() > 0
