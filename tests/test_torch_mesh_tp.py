"""Serving on a mesh with the reference's split of the work: each data
rank's rows, and heads, ff columns and vocab over ``model`` (``lm.prefill``
/ ``lm.decode_step`` with ``mesh=``), vs the reference's
``jax.jit(lm.prefill / lm.decode_step)`` with its params placed under
``ShardingRules.param_specs`` and its inputs over the data axes, on fake
CPU devices.

The reference runs once, in one subprocess with 8 fake CPU devices,
``kernels="ref"`` and float32: each case's prefill, then ``STEPS`` greedy
decode steps, each step fed the reference's own argmax.  The port runs
every mesh as a gloo world (spawned, all worlds at once, a file store
under tmp_path), each rank passing the same global inputs and its
``shard_params`` shards, and feeds each step its own argmax.  Meshes
("data", "model"): (1, 2), (2, 1), (2, 2), (1, 4), (2, 4), and (1, 3),
where no shipped vocab (a multiple of 256) splits over ``model`` and the
rules put the table's ``d`` there instead.

The cases (SMOKE configs): gemma2 (windowed and softcapped; at batch 1
too, the context-parallel decode on the rank's heads); granite-34b (one
kv head: ``n_kv_heads % tp != 0``, k / v cut from the replicated
weights); minicpm with 3 heads (heads do not divide ``tp``: the
reference's ``_attn_act_spec``, batch over ``model`` where the batch
tiles the grid, else sequence over ``model``; with
``attn_activation_shard="none"`` attention replicated within a model
group, prefill and decode, as the reference leaves it); minicpm on (1, 3) (the
vocab fallback, with both ``_attn_act_spec`` branches); granite-moe (TP
attention with the roomy MoE and the roomy embedding); zamba2 (the shared
block's TP attention, the mamba mixers replicated on the rank's rows).

Tolerances: logits within 2e-4 (abs + rel) of the reference's, the
greedy tokens identical; every model rank's prefill cache (all kv heads)
within 1e-4 of its data rank's cut of the reference's global one.  Proof
that the work is split: a spy on ``ops.flash_attention`` /
``flash_attention_lse`` / ``paged_decode_attention`` records the heads
and rows of each call on each rank; on (1, 4) a rank's
``FlopCounterMode`` count of a prefill with heads that divide 4 is at
most 0.3× the one-device count; a planted fault (``wo``'s all-reduce
skipped) reads far past the tolerance.
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
from repro_torch.core import paged

WORLD_TIMEOUT_S = 300
STEPS = 4
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4),
          "2x4": (2, 4), "1x3": (1, 3)}
# case: (arch, config overrides, batch, prompt length, max_len)
CASES = {
    "gemma2": ("gemma2-2b", {}, 2, 12, 128),
    "gemma2_b1": ("gemma2-2b", {}, 1, 300, 512),
    "kvrep": ("granite-34b", {}, 2, 8, 128),
    "heads3": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3}, 4, 8, 128),
    "heads3_seq": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3}, 2, 12,
                   128),
    "heads3_b1": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3}, 1, 12,
                  128),
    "vocab": ("minicpm-2b", {}, 3, 6, 128),
    "vocab_seq": ("minicpm-2b", {}, 1, 12, 128),
    "granite_moe": ("granite-moe-3b-a800m", {"embedding_dispatch": "roomy"},
                    4, 8, 128),
    "zamba2": ("zamba2-1.2b", {}, 2, 6, 128),
    "minicpm": ("minicpm-2b", {}, 2, 16, 128),
    "heads3_none": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3,
                                   "attn_activation_shard": "none"},
                    4, 8, 128),
}
ON = {"1x2": ("gemma2", "gemma2_b1", "kvrep", "heads3", "heads3_b1",
              "granite_moe", "zamba2", "heads3_none"),
      "2x1": ("gemma2", "kvrep", "granite_moe", "zamba2"),
      "2x2": ("gemma2", "gemma2_b1", "kvrep", "heads3", "heads3_seq",
              "granite_moe", "zamba2"),
      "1x4": ("gemma2", "heads3", "minicpm"),
      "2x4": ("gemma2", "heads3", "granite_moe"),
      "1x3": ("vocab", "vocab_seq")}
# the cases whose prefill caches are held to the reference's, model rank
# by model rank
CACHED = ("gemma2", "kvrep", "heads3_seq", "vocab")


def _cfg(case):
    arch, over, *_ = CASES[case]
    return get_config(arch, smoke=True).replace(kernels="ref",
                                                dtype="float32", **over)


def _act_branch(case, tag):
    """Which ``_attn_act_spec`` branch a case takes on a mesh: "heads"
    (n_heads % tp == 0, or tp 1), "batch", "seq", or None (replicated)."""
    from repro_torch.models import attention as A

    class Shape:
        def __init__(self, dp, tp):
            self.shape = {"data": dp, "model": tp}
    dp, tp = MESHES[tag]
    cfg, b, s = _cfg(case), CASES[case][2], CASES[case][3]
    if tp == 1 or cfg.n_heads % tp == 0:
        return "heads"
    spec = A._attn_act_spec(cfg, Shape(dp, tp), b, s)
    if spec is None:
        return None
    return "batch" if isinstance(spec[0][0], tuple) else "seq"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs() -> dict:
    rng = np.random.default_rng(34)
    return {case: rng.integers(0, _cfg(case).vocab_size, (b, s))
            for case, (_, _, b, s, _) in CASES.items()}


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding_rules import ShardingRules, named
from repro.models import lm

prefill = jax.jit(lm.prefill, static_argnums=(2, 3),
                  static_argnames=("max_len",))
decode_step = jax.jit(lm.decode_step, static_argnums=(3, 4))
CASES, MESHES, ON, STEPS = {cases}, {meshes}, {on}, {steps}
def cfg_of(case):
    arch, over, *_ = CASES[case]
    return get_config(arch, smoke=True).replace(kernels="ref",
                                                dtype="float32", **over)

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
out, params = {{}}, {{}}
for case in CASES:
    params[case] = lm.init_params(cfg_of(case), jax.random.PRNGKey(0))
    flat(params[case], "params|" + case, out)
for tag, shape in MESHES.items():
    mesh = mesh_of(shape)
    for case in ON[tag]:
        cfg, (_, _, b, s, max_len) = cfg_of(case), CASES[case]
        specs = ShardingRules(cfg, mesh).param_specs(
            jax.eval_shape(lambda: params[case]))
        placed = jax.tree.map(jax.device_put, params[case],
                              named(mesh, specs))
        pos = jnp.tile(jnp.arange(s)[None], (b, 1))
        lg, caches = prefill(placed, {{"tokens": rows(jnp.asarray(g[case]),
                                                      mesh),
                                      "positions": rows(pos, mesh)}},
                             cfg, mesh, max_len=max_len)
        key = f"{{case}}|{{tag}}"
        if case + "|cache|k_pages" not in out:   # the global caches, once
            for f in caches["kv"]._fields:
                out[f"{{case}}|cache|{{f}}"] = getattr(caches["kv"], f)
        res, toks = [np.asarray(lg)[:, -1]], []
        for t in range(STEPS):
            tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            lg, caches = decode_step(
                placed, {{"tokens": rows(tok, mesh),
                          "positions": rows(jnp.zeros_like(tok), mesh)}},
                caches, cfg, mesh)
            res.append(np.asarray(lg)[:, -1])
        out[key] = np.stack(res)
        out[key + "|toks"] = np.concatenate(toks, 1)
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


def _params(store: dict, case: str) -> dict:
    return convert.lm_params_from_jax(_unflat(store, "params|" + case),
                                      _cfg(case), device="cpu")


def serve(params, cfg, prompt, max_len, mesh=None, steps=STEPS):
    """prefill, then ``steps`` greedy decode steps with ``donate``: (the
    last logits of every call (1 + T, B, V), the tokens chosen (B, T), the
    caches after the prefill)."""
    from repro_torch.models import lm
    b, s = prompt.shape
    pos = torch.arange(s)[None].expand(b, s)
    with torch.no_grad():
        lg, caches = lm.prefill(params, {"tokens": prompt, "positions": pos},
                                cfg, mesh, max_len=max_len)
        first = [paged.PagedKV(*(t.clone() for t in c))
                 for c in caches["kv"]]
        res, toks = [lg[:, -1]], []
        for _ in range(steps):
            tok = lg[:, -1:].argmax(-1)
            toks.append(tok)
            lg, caches = lm.decode_step(
                params, {"tokens": tok, "positions": torch.zeros_like(tok)},
                caches, cfg, mesh, donate=True)
            res.append(lg[:, -1])
    return torch.stack(res), torch.cat(toks, 1), first


class Spy:
    """Every K6 / K6-LSE / K8 call through ``kernels/ops.py`` of this
    process: (kernel, batch rows, q heads, kv heads)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls = ops, []
        self.orig = {n: getattr(ops, n) for n in (
            "flash_attention", "flash_attention_lse",
            "paged_decode_attention")}

    def __enter__(self):
        for name, fn in self.orig.items():
            def spied(q, k, *a, _fn=fn, _name=name, **kw):
                kvh = k.shape[1] if q.dim() == 4 else k.shape[2]
                self.calls.append((_name, q.shape[0], q.shape[1], kvh))
                return _fn(q, k, *a, **kw)
            setattr(self.ops, name, spied)
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def _flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


# --------------------------------------------------------- the port side

def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    """One rank of the gloo world of mesh ``tag``: every case of
    ``ON[tag]``, results to ``root/torch_<tag>_<rank>.npz``."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding_rules as SR
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention as A
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{tag}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        dp, tp = MESHES[tag]
        mesh = M.make_host_mesh(tp=tp, device="cpu")
        g = dict(np.load(f"{root}/inputs.npz"))
        store = dict(np.load(f"{root}/jax_out.npz"))
        out = {}
        for case in ON[tag]:
            cfg, max_len = _cfg(case), CASES[case][4]
            whole = _params(store, case)
            shards = SR.shard_params(whole, SR.config_specs(cfg, mesh), mesh)
            prompt = torch.from_numpy(g[case])
            with Spy() as calls:
                lg, toks, first = serve(shards, cfg, prompt, max_len, mesh)
            out[f"{case}"], out[f"{case}|toks"] = lg, toks
            out[f"{case}|calls"] = np.array(
                [(["flash_attention", "flash_attention_lse",
                   "paged_decode_attention"].index(n), b, h, k)
                 for n, b, h, k in calls]).reshape(-1, 4)
            if case in CACHED:
                for i, c in enumerate(first):
                    out[f"{case}|k|{i}"], out[f"{case}|v|{i}"] = c[:2]
            if case == "gemma2":
                # the planted fault: wo's partials left unjoined
                orig = A._sum_over_model
                A._sum_over_model = lambda x, mesh: x
                try:
                    out["gemma2|fault"] = serve(shards, cfg, prompt, max_len,
                                                mesh, steps=1)[0]
                finally:
                    A._sum_over_model = orig
            if case == "minicpm":
                b, s = prompt.shape
                inp = {"tokens": prompt,
                       "positions": torch.arange(s)[None].expand(b, s)}
                from repro_torch.models import lm
                with torch.no_grad():
                    out["minicpm|flops"] = np.array([
                        _flops(lambda: lm.prefill(shards, inp, cfg, mesh,
                                                  max_len=max_len)),
                        _flops(lambda: lm.prefill(whole, inp, cfg,
                                                  max_len=max_len))])
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    from conftest import run_multidev
    root = tmp_path_factory.mktemp("mesh_tp")
    np.savez(root / "inputs.npz", **_inputs())
    code = JAX_SIDE.format(cases=CASES, meshes=MESHES, on=ON, steps=STEPS,
                           root=root)
    run_multidev(code, n_devices=8, timeout=900)
    return root, dict(np.load(root / "jax_out.npz")), dict(
        np.load(root / "inputs.npz"))


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Every mesh's gloo world, all spawned at once; a list of each
    rank's results by mesh."""
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


PAIRS = [(tag, case) for tag in MESHES for case in ON[tag]]


@pytest.mark.parametrize("tag,case", PAIRS)
def test_serving_matches_the_sharded_reference(tag, case, worlds, jax_side):
    """The logits of the prefill and of each decode step within 2e-4 of
    the reference's jitted, sharded run, the greedy tokens identical, and
    every rank the same."""
    _, want, _ = jax_side
    ranks = worlds[tag]
    for r in ranks:
        _close(r[case], want[f"{case}|{tag}"])
        np.testing.assert_array_equal(r[f"{case}|toks"],
                                      want[f"{case}|{tag}|toks"])
        np.testing.assert_array_equal(r[case], ranks[0][case])


@pytest.mark.parametrize("tag,case", [(t, c) for t, c in PAIRS
                                      if c in CACHED])
def test_each_rank_writes_its_cache_shard(tag, case, worlds, jax_side):
    """Every model rank's prefill cache holds every kv head: within 1e-4
    of its data rank's cut of the reference's global cache, the heads it
    did not compute gathered over ``model`` before the write."""
    _, want, _ = jax_side
    dp, tp = MESHES[tag]
    cfg = _cfg(case)
    ref = {"kv": paged.PagedKV(*(want[f"{case}|cache|{f}"]
                                 for f in paged.PagedKV._fields))}
    for r, res in enumerate(worlds[tag]):
        cut = convert.lm_caches_shard_from_jax(ref, cfg, r // tp, dp,
                                               device="cpu")
        for i, c in enumerate(cut["kv"]):
            _close(res[f"{case}|k|{i}"], c.k_pages, 1e-4)
            _close(res[f"{case}|v|{i}"], c.v_pages, 1e-4)
            assert res[f"{case}|k|{i}"].shape[2] == cfg.n_kv_heads


@pytest.mark.parametrize("tag,case", PAIRS)
def test_the_attention_kernels_see_the_ranks_share(tag, case, worlds):
    """K6 and K8 run on n_heads / tp heads a rank where the heads divide
    ``model`` (the kv heads: the group's share), on the rank's rows where
    the batch tiles the data axes.  Where they do not divide, K6 takes the
    ``_attn_act_spec`` branch's share: a block of the rows, or of the
    query rows (K6 on the diagonal block, and with the LSE on the keys
    before it); K8 a share of ceil or floor n_heads / tp heads.  With
    ``attn_activation_shard="none"`` K6 and K8 see every head."""
    dp, tp = MESHES[tag]
    cfg, (_, _, b, s, _) = _cfg(case), CASES[case]
    rows = b // dp if b % dp == 0 else b
    branch = _act_branch(case, tag)
    g = cfg.n_heads // cfg.n_kv_heads
    layers = (cfg.n_layers if cfg.family != "hybrid"
              else sum(1 for i in range(cfg.n_layers)
                       if (i + 1) % cfg.shared_attn_every == 0))
    for rank, res in enumerate(worlds[tag]):
        calls = res[f"{case}|calls"]
        fa = calls[calls[:, 0] != 2]
        pd = calls[calls[:, 0] == 2]
        windowed = cfg.local_global_pattern
        global_layers = layers // 2 if windowed else layers
        # decode: n_heads / tp heads a rank, or where they do not divide,
        # ceil(m·H / tp) up to ceil((m + 1)·H / tp) for model rank m
        m = rank % tp
        dec = (cfg.n_heads // tp if branch == "heads" else cfg.n_heads
               if cfg.attn_activation_shard == "none" else
               -(-(m + 1) * cfg.n_heads // tp) - -(-m * cfg.n_heads // tp))
        # K8: every unwindowed layer of every step on a rank with heads;
        # none at batch 1 (the context-parallel decode's float32 merge)
        assert len(pd) == (0 if b == 1 or dec == 0
                           else global_layers * STEPS)
        if len(pd):
            assert (pd[:, 1] == rows).all() and (pd[:, 2] == dec).all()
            assert (pd[:, 3] == max(1, dec // g)).all()
        if branch == "heads":
            heads = cfg.n_heads // tp
            assert len(fa) == layers and (fa[:, 0] == 0).all()
            assert (fa[:, 1] == rows).all() and (fa[:, 2] == heads).all()
            assert (fa[:, 3] == max(1, heads // g)).all()
        elif branch == "batch":
            assert (fa[:, 1] == rows // tp).all()
            assert (fa[:, 2] == cfg.n_heads).all()
        elif branch is None:
            assert len(fa) == layers and (fa[:, 1] == rows).all()
            assert (fa[:, 2] == cfg.n_heads).all()
        elif branch == "seq":
            assert (fa[:, 1] == rows).all()
            assert len(fa) == layers * (1 if m == 0 else 2)
            assert (fa[:, 0] == (0 if m == 0 else 1)).all()


def test_both_act_spec_branches_and_the_fallbacks_are_covered():
    """The cases reach each split this slice ports: heads with kv heads
    split and replicated, both ``_attn_act_spec`` branches, the vocab
    fallback, the context-parallel decode on the rank's heads, and
    attention replicated within a model group ("none")."""
    from repro_torch.distributed import sharding_rules as SR

    class Shape:
        def __init__(self, dp, tp):
            self.shape = {"data": dp, "model": tp}
    seen = {(_act_branch(c, t), t) for t, c in PAIRS}
    assert {b for b, _ in seen} == {"heads", "batch", "seq", None}
    kv = {SR.model_dim(_cfg(c), Shape(*MESHES[t]), "attn/wk") is None
          for t, c in PAIRS if _act_branch(c, t) == "heads"
          and MESHES[t][1] > 1}
    assert kv == {True, False}
    assert SR.model_dim(_cfg("vocab"), Shape(1, 3), "embed/table") == 1
    assert ("gemma2_b1", "2x2") in {(c, t) for t, c in PAIRS}


def test_flops_a_rank_shrink_with_the_model_axis(worlds):
    """(1, 4), minicpm (4 heads, 4 kv heads): a rank's prefill counts at
    most 0.3× the FLOPs of the same prefill on one device."""
    for res in worlds["1x4"]:
        mine, one = res["minicpm|flops"]
        assert 0 < mine <= 0.3 * one, (mine, one)


def test_a_skipped_wo_all_reduce_reads_past_the_tolerance(worlds, jax_side):
    """gemma2 on (1, 2) with ``wo``'s all-reduce skipped: the logits
    leave the reference by far more than the 2e-4 the sound run keeps."""
    _, want, _ = jax_side
    got = worlds["1x2"][0]["gemma2|fault"]
    err = np.abs(got - want["gemma2|1x2"][:2]).max()
    assert err > 100 * 2e-4, err
