"""Port parity on a device mesh: ``repro_torch.launch.mesh``, the mesh
helpers of ``core/sharding.py``, the roomy embedding and MoE exchanges and
both sharded paged decodes, vs the JAX package inside ``jax.shard_map``.

The reference runs once, in one subprocess with 8 fake CPU devices (the
``multidev`` fixture), every mesh on its first devices, with
``kernels="ref"`` and float32; it saves its params and outputs.  The port
runs each mesh as a gloo world of ``torch.multiprocessing`` processes
(spawned, a file store under tmp_path): every rank passes the same global
inputs, made from a numpy seed, and saves what it got back.  Params cross
with ``convert.lm_params_from_jax``.  Meshes ("data", "model"): (2, 2)
and (1, 2) for the exchanges and both decodes, (4, 1) where a case needs
data ranks, (1, 8) for the embedding whose buckets overflow (its capacity,
``max(8, min(t, 4·ceil(t / S)))``, holds every token while the model axis
S is 4 or less).

Tolerances: the embedding bit for bit; ``moe_roomy`` within 2e-4 of the
reference and of the port's ``moe_einsum`` at capacity factor 8 (no pair
dropped), within 1e-5 of the reference at 0.25, where pairs drop, with the
dropped count equal to a numpy count of the two bucket levels; logits
within 2e-4 (abs + rel) of the reference's mesh run and of the port with
no mesh; each data rank's prefill cache within 1e-4 of its cut of the
reference's global one (``convert.lm_caches_shard_from_jax``; 1e-4, as
the single-device tests hold caches across the packages), and after the
steps only its pages, which joined (``convert.lm_caches_unshard``) are
within 1e-5 of the port's cache with no mesh.
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
from repro_torch.distributed import sharding_rules as SR
from repro_torch.models import layers, lm, moe

WORLD_TIMEOUT_S = 180
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "4x1": (4, 1), "1x8": (1, 8)}
CASES = {"2x2": ("embed", "moe", "batched", "cp", "granite_moe"),
         "1x2": ("embed", "moe", "batched", "cp"),
         "4x1": ("batched", "cp", "zamba2", "gemma2"),
         "1x8": ("skew",)}
MOE_CFS = (8.0, 1.0, 0.25)            # no drop; drops
B_DEC, PROMPT, STEPS = 8, 5, 3        # the batched decode
CP_MAX_LEN = 512                      # 4 pages: 1, 2 or 4 a data rank
CP_PROMPT = 300                       # spans pages 0-2: 2 or 3 data ranks
ARCHS = {"granite-34b": {}, "minicpm-2b": {},
         "granite-moe-3b-a800m": {"embedding_dispatch": "roomy"},
         "phi3.5-moe-42b-a6.6b": {"n_experts": 8, "top_k": 2}}


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

def _inputs() -> dict:
    rng = np.random.default_rng(30)
    emb, moe_cfg = _cfg("minicpm-2b"), _cfg("phi3.5-moe-42b-a6.6b")
    gm, z = _cfg("granite-moe-3b-a800m"), get_config("zamba2-1.2b",
                                                     smoke=True)
    big = _cfg("granite-34b")
    return {
        "embed_ids": rng.integers(0, emb.vocab_size, (4, 8)),
        # every id ≡ 0 mod 8: the whole batch goes to model rank 0
        "skew_ids": rng.integers(0, emb.vocab_size // 8, (8, 32)) * 8,
        "moe_x": rng.standard_normal((8, 8, moe_cfg.d_model)).astype(
            np.float32),
        "dec_prompt": rng.integers(0, big.vocab_size, (B_DEC, PROMPT)),
        "dec_steps": rng.integers(0, big.vocab_size, (B_DEC, STEPS)),
        "cp_prompt": rng.integers(0, emb.vocab_size, (1, CP_PROMPT)),
        "cp_steps": rng.integers(0, emb.vocab_size, (1, STEPS)),
        "gm_prompt": rng.integers(0, gm.vocab_size, (4, 8)),
        "gm_steps": rng.integers(0, gm.vocab_size, (4, 2)),
        "z_prompt": rng.integers(0, z.vocab_size, (4, 6)),
        "z_steps": rng.integers(0, z.vocab_size, (4, STEPS)),
        "g2_prompt": rng.integers(0, 199, (1, CP_PROMPT)),
        "g2_steps": rng.integers(0, 199, (1, STEPS)),
    }


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import lm
from repro.models.layers import embed_tokens
from repro.models.moe import init_moe, moe_roomy

# one compile a call (eagerly, every op of a shard_map region compiles)
embed_tokens = jax.jit(embed_tokens, static_argnums=(2, 3))
moe_roomy = jax.jit(moe_roomy, static_argnums=(2, 3))
prefill = jax.jit(lm.prefill, static_argnums=(2, 3),
                  static_argnames=("max_len",))
decode_step = jax.jit(lm.decode_step, static_argnums=(3, 4))

ARCHS = {archs}
def cfg_of(arch, **kw):
    return get_config(arch, smoke=True).replace(
        kernels="ref", dtype="float32", **{{**ARCHS.get(arch, {{}}), **kw}})

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

g = dict(np.load("{root}/inputs.npz"))
params, out = {{}}, {{}}
for arch in ("granite-34b", "minicpm-2b", "granite-moe-3b-a800m"):
    params[arch] = lm.init_params(cfg_of(arch), jax.random.PRNGKey(0))
    flat(params[arch], "params|" + arch, out)
moe_cfg = cfg_of("phi3.5-moe-42b-a6.6b")
moe_p = init_moe(jax.random.PRNGKey(1), moe_cfg)
flat(moe_p, "params|moe", out)

def run(arch, prompt, steps, mesh, max_len, key):
    cfg = cfg_of(arch)
    b, s = prompt.shape
    pos = jnp.tile(jnp.arange(s)[None], (b, 1))
    lg, caches = prefill(params[arch], {{"tokens": jnp.asarray(prompt),
                                       "positions": pos}}, cfg, mesh,
                         max_len=max_len)
    for f in caches["kv"]._fields:           # the global prefill caches
        out[f"{{key}}|cache|{{f}}"] = getattr(caches["kv"], f)
    res = [np.asarray(lg)]
    for t in range(steps.shape[1]):
        lg, caches = decode_step(
            params[arch], {{"tokens": jnp.asarray(steps[:, t:t + 1]),
                            "positions": jnp.zeros((b, 1), jnp.int32)}},
            caches, cfg, mesh)
        res.append(np.asarray(lg))
    return np.stack([r[:, -1] for r in res])

for tag, shape in {meshes}.items():
    mesh, cases = mesh_of(shape), {cases}[tag]
    if "embed" in cases:
        out[f"embed|{{tag}}"] = embed_tokens(
            params["minicpm-2b"]["embed"], jnp.asarray(g["embed_ids"]),
            cfg_of("minicpm-2b", embedding_dispatch="roomy"), mesh)
    if "skew" in cases:
        out[f"skew|{{tag}}"] = embed_tokens(
            params["minicpm-2b"]["embed"], jnp.asarray(g["skew_ids"]),
            cfg_of("minicpm-2b", embedding_dispatch="roomy"), mesh)
    if "moe" in cases:
        for cf in {cfs}:
            out[f"moe|{{tag}}|{{cf}}"] = moe_roomy(
                moe_p, jnp.asarray(g["moe_x"]),
                moe_cfg.replace(capacity_factor=cf), mesh)
    if "batched" in cases:
        out[f"batched|{{tag}}"] = run("granite-34b", g["dec_prompt"],
                                     g["dec_steps"], mesh, 128,
                                     f"batched|{{tag}}")
    if "cp" in cases:
        out[f"cp|{{tag}}"] = run("minicpm-2b", g["cp_prompt"],
                                g["cp_steps"], mesh, {cp_max_len},
                                f"cp|{{tag}}")
    if "granite_moe" in cases:
        out[f"granite_moe|{{tag}}"] = run("granite-moe-3b-a800m",
                                         g["gm_prompt"], g["gm_steps"],
                                         mesh, 128, f"granite_moe|{{tag}}")
np.savez("{root}/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("jax side ok")
"""


def _unflat(store: dict, prefix: str) -> dict:
    """The nested dict saved by the JAX side's ``flat`` under ``prefix``."""
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


def _params(store: dict, arch: str) -> dict:
    return convert.lm_params_from_jax(_unflat(store, "params|" + arch),
                                      _cfg(arch), device="cpu")


def _moe_params(store: dict) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in _unflat(store, "params|moe").items()}


def _run(params, cfg, prompt, steps, max_len, mesh=None):
    """prefill, then one decode step a column of ``steps``: (the last
    logits of every call (1 + T, B, V), the caches after the prefill,
    the caches after the steps).  On a mesh the calls take this rank's
    shards of ``params`` (``sharding_rules.shard_params``)."""
    if mesh is not None:
        params = SR.shard_params(params, SR.config_specs(cfg, mesh), mesh)
    prompt = torch.from_numpy(prompt)
    b, s = prompt.shape
    pos = torch.arange(s)[None].expand(b, s)
    lg, caches = lm.prefill(params, {"tokens": prompt, "positions": pos},
                            cfg, mesh, max_len=max_len)
    first = caches
    res = [lg[:, -1]]
    for t in range(steps.shape[1]):
        tok = torch.from_numpy(steps[:, t:t + 1])
        lg, caches = lm.decode_step(
            params, {"tokens": tok, "positions": torch.zeros_like(tok)},
            caches, cfg, mesh)
        res.append(lg[:, -1])
    return torch.stack(res), first, caches


# --------------------------------------------------------- the port side

def _torch_rank(rank: int, world: int, tag: str, root: str) -> None:
    """One rank of a gloo world on the mesh ``tag``: every case of
    ``CASES[tag]``, results to ``root/torch_<tag>_<rank>.npz``."""
    import torch.distributed as dist
    from repro_torch.core import sharding as SH
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{tag}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        dp, tp = MESHES[tag]
        mesh = M.make_host_mesh(tp=tp, device="cpu")
        g = dict(np.load(f"{root}/inputs.npz"))
        store = dict(np.load(f"{root}/jax_out.npz"))
        out = {"coord": np.array(mesh.get_coordinate()),
               "dp_index": np.array(SH.axis_index(mesh, "data"))}
        try:
            M.make_production_mesh(device="cpu")
        except ValueError as e:
            out["production_refused"] = np.array("256" in str(e))
        cases = CASES[tag]
        if "embed" in cases or "skew" in cases:
            cfg = _cfg("minicpm-2b", embedding_dispatch="roomy")
            emb = _params(store, "minicpm-2b")["embed"]
            for case in ("embed", "skew"):
                if case in cases:
                    ids = torch.from_numpy(g[f"{case}_ids"])
                    out[case] = layers.embed_tokens(emb, ids, cfg, mesh)
        if "moe" in cases:
            mcfg, mp_ = _cfg("phi3.5-moe-42b-a6.6b"), _moe_params(store)
            for cf in MOE_CFS:
                y, dropped = moe.moe_roomy(
                    mp_, torch.from_numpy(g["moe_x"]),
                    mcfg.replace(capacity_factor=cf), mesh)
                out[f"moe_{cf}"], out[f"moe_dropped_{cf}"] = y, dropped
        runs = {"batched": ("granite-34b", "dec", 128),
                "cp": ("minicpm-2b", "cp", CP_MAX_LEN),
                "granite_moe": ("granite-moe-3b-a800m", "gm", 128)}
        for case, (arch, key, max_len) in runs.items():
            if case in cases:
                lg, first, caches = _run(
                    _params(store, arch), _cfg(arch), g[f"{key}_prompt"],
                    g[f"{key}_steps"], max_len, mesh)
                out[case] = lg
                for i, (p0, c) in enumerate(zip(first["kv"], caches["kv"])):
                    out[f"{case}_k_{i}"], out[f"{case}_v_{i}"] = c[:2]
                    out[f"{case}_len_{i}"] = c.lengths
                    out[f"{case}_table_{i}"] = c.page_table
                    out[f"{case}_pk_{i}"], out[f"{case}_pv_{i}"] = p0[:2]
                empty = lm.make_cache(_cfg(arch), g[f"{key}_prompt"].shape[0],
                                      max_len, device="cpu", mesh=mesh)
                out[f"{case}_empty_pages"] = np.array(
                    [c.k_pages.shape[0] for c in empty["kv"]])
        for case, arch, seed, max_len in (("zamba2", "zamba2-1.2b", 2, 128),
                                          ("gemma2", "gemma2-2b", 3,
                                           CP_MAX_LEN)):
            if case in cases:
                cfg = get_config(arch, smoke=True).replace(kernels="ref")
                params = lm.init_params(cfg, seed, device="cpu")
                key = "z" if case == "zamba2" else "g2"
                out[case], _, caches = _run(params, cfg, g[f"{key}_prompt"],
                                            g[f"{key}_steps"], max_len, mesh)
                out[f"{case}_pages"] = np.array(
                    [c.k_pages.shape[0] for c in caches["kv"]])
        np.savez(f"{root}/torch_{tag}_{rank}.npz",
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def _run_world(tag: str, root: str) -> None:
    world = math.prod(MESHES[tag])
    ctx = mp.start_processes(_torch_rank, args=(world, tag, root),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo world {tag} did not finish in "
                        f"{WORLD_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    from conftest import run_multidev
    root = tmp_path_factory.mktemp("mesh")
    np.savez(root / "inputs.npz", **_inputs())
    code = JAX_SIDE.format(archs=ARCHS, meshes=MESHES, cases=CASES,
                           cfs=MOE_CFS, cp_max_len=CP_MAX_LEN, root=root)
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
            _run_world(tag, str(root))
            done[tag] = [dict(np.load(root / f"torch_{tag}_{r}.npz"))
                         for r in range(math.prod(MESHES[tag]))]
        return done[tag]
    return get


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key
    return ranks[0][key]


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- the mesh

@pytest.mark.parametrize("tag", ["2x2", "1x2", "4x1"])
def test_host_mesh_coordinates_and_production_refusal(tag, world):
    """make_host_mesh numbers ranks row-major over (data, model) and
    make_production_mesh refuses a world that is not 256 ranks."""
    ranks = world(tag)
    dp, tp = MESHES[tag]
    for r, res in enumerate(ranks):
        assert res["coord"].tolist() == [r // tp, r % tp]
        assert int(res["dp_index"]) == r // tp
        assert bool(res["production_refused"])


# ------------------------------------------------------------ embedding

@pytest.mark.parametrize("tag", ["2x2", "1x2"])
def test_roomy_embedding_matches_jax_and_take(tag, world, jax_side):
    _, want, g = jax_side
    got = _same_on_every_rank(world(tag), "embed")
    assert np.array_equal(got, want[f"embed|{tag}"])
    table = want["params|minicpm-2b|embed|table"]
    assert np.array_equal(got, table[g["embed_ids"]])


def test_roomy_embedding_overflow_embeds_zeros_as_jax(world, jax_side):
    """Every id ≡ 0 mod 8 on a (1, 8) mesh: each rank's 32 tokens go to
    model rank 0, whose buckets hold 16 of them; the rest embed as zeros,
    the same tokens as the reference's, bit for bit."""
    _, want, g = jax_side
    got = _same_on_every_rank(world("1x8"), "skew")
    assert np.array_equal(got, want["skew|1x8"])
    zero = ~got.any(-1)
    assert zero.sum() == 8 * 16
    table = want["params|minicpm-2b|embed|table"]
    assert np.array_equal(got[~zero], table[g["skew_ids"]][~zero])


# ------------------------------------------------------------------ MoE

def _roomy_drops_oracle(ids, cfg, shape) -> list:
    """The pairs ``moe_roomy`` drops, counted in numpy, [at the exchange,
    at the experts]: each device's pairs (token-major) bin by owner
    (expert // E_loc) with cap1 per (source, owner); each owner bins what
    it received (by source model rank, then slot) by local expert with
    cap2."""
    dp, s_model = shape
    n_dev = dp * s_model
    b, s, k = ids.shape
    e_loc = cfg.experts_padded // s_model
    t_loc = b * s // n_dev
    cap1 = max(8, math.ceil(t_loc * k / s_model * cfg.capacity_factor))
    cap2 = max(8, math.ceil(s_model * cap1 / e_loc * cfg.capacity_factor))
    pairs = ids.reshape(n_dev, t_loc * k)
    dropped = [0, 0]
    sent = {}                          # (device, owner) → kept expert ids
    for dev in range(n_dev):
        for owner in range(s_model):
            mine = pairs[dev][pairs[dev] // e_loc == owner]
            dropped[0] += max(0, len(mine) - cap1)
            sent[dev, owner] = mine[:cap1]
    for d in range(dp):
        for owner in range(s_model):
            recv = np.concatenate([sent[d * s_model + j, owner]
                                   for j in range(s_model)])
            counts = np.bincount(recv % e_loc, minlength=e_loc)
            dropped[1] += int(np.maximum(counts - cap2, 0).sum())
    return dropped


@pytest.mark.parametrize("tag", ["2x2", "1x2"])
def test_moe_roomy_matches_jax_and_einsum(tag, world, jax_side):
    _, want, g = jax_side
    ranks = world(tag)
    got = _same_on_every_rank(ranks, "moe_8.0")
    _close(got, want[f"moe|{tag}|8.0"])
    cfg = _cfg("phi3.5-moe-42b-a6.6b", capacity_factor=8.0)
    base = moe.moe_einsum(_moe_params(want), torch.from_numpy(g["moe_x"]),
                          cfg)
    _close(got, base)
    assert _same_on_every_rank(ranks, "moe_dropped_8.0").tolist() == [0, 0]


@pytest.mark.parametrize("tag", ["2x2", "1x2"])
def test_moe_roomy_drops_as_jax(tag, world, jax_side):
    """At capacity factors 1 and 0.25 pairs drop: the outputs within 1e-5
    of the reference's, and the drops at each level those of the numpy
    count; over the two, both levels drop."""
    _, want, g = jax_side
    ranks = world(tag)
    levels = np.zeros(2, int)
    for cf in MOE_CFS[1:]:
        got = _same_on_every_rank(ranks, f"moe_{cf}")
        _close(got, want[f"moe|{tag}|{cf}"], tol=1e-5)
        cfg = _cfg("phi3.5-moe-42b-a6.6b", capacity_factor=cf)
        _, ids = moe._route(_moe_params(want), torch.from_numpy(g["moe_x"]),
                            cfg)
        dropped = _same_on_every_rank(ranks, f"moe_dropped_{cf}")
        assert dropped.tolist() == _roomy_drops_oracle(ids.numpy(), cfg,
                                                       MESHES[tag])
        assert dropped.sum() > 0
        levels += dropped
    assert (levels > 0).all(), levels


# -------------------------------------------------------------- decodes

def _decode_case(case, tag, world, jax_side, arch, key, max_len):
    """Logits against the reference's mesh run and the port's run with no
    mesh; each data rank's prefill cache ≈ its cut of the reference's
    global one (``convert.lm_caches_shard_from_jax``); after the steps,
    each rank holds P/dp pages and the shards joined
    (``convert.lm_caches_unshard``) == the cache with no mesh."""
    _, want, g = jax_side
    ranks = world(tag)
    got = _same_on_every_rank(ranks, case)
    _close(got, want[f"{case}|{tag}"])
    cfg = _cfg(arch)
    one, _, caches = _run(_params(want, arch), cfg, g[f"{key}_prompt"],
                          g[f"{key}_steps"], max_len)
    _close(got, one)
    dp, tp = MESHES[tag]
    b = g[f"{key}_prompt"].shape[0]
    ref = {"kv": paged.PagedKV(*(want[f"{case}|{tag}|cache|{f}"]
                                 for f in paged.PagedKV._fields))}
    n_layers = len(caches["kv"])
    shards = []
    for d, r in enumerate(ranks[::tp]):                     # one a data rank
        cut = convert.lm_caches_shard_from_jax(ref, cfg, d, dp, device="cpu")
        for i in range(n_layers):
            _close(r[f"{case}_pk_{i}"], cut["kv"][i].k_pages, 1e-4)
            _close(r[f"{case}_pv_{i}"], cut["kv"][i].v_pages, 1e-4)
        shards.append({"kv": [paged.PagedKV(*(
            torch.from_numpy(r[f"{case}_{f}_{i}"])
            for f in ("k", "v", "table", "len"))) for i in range(n_layers)]})
    whole = convert.lm_caches_unshard(shards, b)
    for mine, c in zip(whole["kv"], caches["kv"]):
        pages = c.k_pages.shape[0]
        assert all(s["kv"][0].k_pages.shape[0] == pages // dp
                   for s in shards)
        _close(mine.k_pages, c.k_pages, 1e-5)
        _close(mine.v_pages, c.v_pages, 1e-5)
        assert torch.equal(mine.lengths, c.lengths)
        assert torch.equal(mine.page_table, c.page_table)
    for r in ranks:
        assert r[f"{case}_empty_pages"].tolist() == [pages // dp] * n_layers


@pytest.mark.parametrize("tag", ["2x2", "1x2", "4x1"])
def test_batched_decode_matches_jax_and_one_device(tag, world, jax_side):
    """granite-34b, batch 8: each data rank appends to and reads only its
    B/dp rows' pages (K8's plain version on the local table)."""
    _decode_case("batched", tag, world, jax_side, "granite-34b", "dec", 128)


@pytest.mark.parametrize("tag", ["2x2", "1x2", "4x1"])
def test_cp_decode_matches_jax_and_one_device(tag, world, jax_side):
    """minicpm-2b, batch 1 over 4 pages: each data rank holds P/dp pages,
    the tail page's owner appends, the partials merge over dp (the
    sequence spans 2 or 3 ranks' pages)."""
    _decode_case("cp", tag, world, jax_side, "minicpm-2b", "cp", CP_MAX_LEN)


def test_granite_moe_prefill_and_decode_match_jax(world, jax_side):
    """granite-moe on (2, 2): the roomy embedding and the roomy MoE run in
    the prefill (32 tokens) and in each decode step (4 tokens tile the
    four ranks), with the batched decode."""
    _, want, _ = jax_side
    got = _same_on_every_rank(world("2x2"), "granite_moe")
    _close(got, want["granite_moe|2x2"])


@pytest.mark.parametrize("case,arch,seed,max_len", [
    ("zamba2", "zamba2-1.2b", 2, 128), ("gemma2", "gemma2-2b", 3,
                                        CP_MAX_LEN)])
def test_decode_on_data_ranks_matches_one_device(case, arch, seed, max_len,
                                                 world, jax_side):
    """(4, 1): zamba2's shared block in the batched decode with its SSM
    state whole on every rank; gemma2 at batch 1, its global layers
    context-parallel and its windowed layers through the page shards
    gathered; each against the port with no mesh."""
    _, _, g = jax_side
    ranks = world("4x1")
    got = _same_on_every_rank(ranks, case)
    cfg = get_config(arch, smoke=True).replace(kernels="ref")
    key = "z" if case == "zamba2" else "g2"
    one, _, caches = _run(lm.init_params(cfg, seed, device="cpu"), cfg,
                          g[f"{key}_prompt"], g[f"{key}_steps"], max_len)
    _close(got, one)
    for r in ranks:
        assert r[f"{case}_pages"].tolist() == [
            c.k_pages.shape[0] // 4 for c in caches["kv"]]
