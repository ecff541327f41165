"""Port parity: ``repro_torch.distributed.sharding_rules`` vs
``repro.distributed.sharding_rules``, pure Python on stand-in meshes (no
devices): ``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}``.

* ``param_specs`` for every arch of the registry, leaf by leaf: the
  port's per-layer block leaves against the reference's stacked ones with
  the stack's leading Nones dropped (the port's params on the meta
  device, the reference's from ``jax.eval_shape``), and ``describe()``'s
  text with its fallbacks, equal;
* ``cache_specs`` at batch 1 and 8, the same way (gemma2's pair stack
  laid out as one (L, …) stack on the reference's side, since at batch 1
  the reference puts dp on the pair axis, which the port has not);
* ``batch_spec``, ``token_spec``, ``activation_spec``, and
  ``_attn_act_spec``'s choice over a grid of (heads, tp, dp, b, s),
  equal;
* ``named``'s placements on a few specs;
* the cache shards of ``core/paged.py``: ``make(shard=)`` against
  ``shard`` of the whole cache, ``unshard`` back, ``shard_layout``.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.distributed import sharding_rules as JSR
from repro.models import attention as JA
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import paged
from repro_torch.distributed import sharding_rules as SR
from repro_torch.models import attention as A
from repro_torch.models import lm

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """The reference's stand-in: axis sizes only (no devices touched)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", k)).lstrip(".") for k in kp)


def _ref_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_path(kp): tuple(s) for kp, s in flat}


def _get(tree, parts):
    for p in parts:
        tree = tree[int(p)] if isinstance(tree, list) else (
            getattr(tree, p) if hasattr(tree, "_fields") else tree[p])
    return tree


_PORT_PARAMS = {}


def _port_params(arch):
    """The port's params of ``arch`` FULL on the meta device (shapes only),
    made once."""
    if arch not in _PORT_PARAMS:
        _PORT_PARAMS[arch] = lm.init_params(
            get_config(arch), torch.Generator().manual_seed(0),
            device="meta")
    return _PORT_PARAMS[arch]


def test_registries_match():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_describe_match_jax(arch, mesh):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jrules = JSR.ShardingRules(jcfg, FakeMesh(MESHES[mesh]))
    rules = SR.ShardingRules(cfg, FakeMesh(MESHES[mesh]))
    want = _ref_flat(jrules.param_specs(jax.eval_shape(
        lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))))
    got = rules.param_specs(_port_params(arch))
    stack = 2 if cfg.local_global_pattern else 1
    n_leaves = 0
    for path, spec in want.items():
        parts = path.split("/")
        if parts[0] == "blocks":
            for i in range(cfg.n_layers):
                mine = _get(got, ["blocks", i] + parts[1:])
                assert isinstance(mine, SR.PartitionSpec)
                assert tuple(mine) == spec[stack:], (path, i, mine, spec)
                n_leaves += 1
        else:
            assert tuple(_get(got, parts)) == spec, (path, spec)
            n_leaves += 1
    assert n_leaves == sum(1 for _ in _leaves(got))
    assert rules.describe() == jrules.describe()
    if arch == "gemma2-2b":                   # 8 heads vs tp = 16
        assert any("tp_q" in f for f in rules.fallbacks)


def _leaves(tree):
    if isinstance(tree, SR.PartitionSpec):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def _one_stack(caches, cfg):
    """The reference's caches with gemma2's (L/2, 2, …) leaves laid out
    as (L, …)."""
    if not cfg.local_global_pattern:
        return caches
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        (a.shape[0] * a.shape[1],) + a.shape[2:], a.dtype), caches)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, mesh, batch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jrules = JSR.ShardingRules(jcfg, FakeMesh(MESHES[mesh]))
    rules = SR.ShardingRules(cfg, FakeMesh(MESHES[mesh]))
    caches = jax.eval_shape(lambda: jlm.make_cache(jcfg, batch, max_len=1024))
    want = _ref_flat(jrules.cache_specs(_one_stack(caches, jcfg), batch))
    got = rules.cache_specs(lm.make_cache(cfg, batch, 1024, device="meta"),
                            batch)
    for path, spec in want.items():
        kind, field = path.split("/")
        for i, entry in enumerate(got[kind]):
            mine = getattr(entry, field)
            assert tuple(mine) == spec[1:], (path, i, mine, spec)


def test_gemma2_pair_stack_at_batch_1():
    """The reference's spec of gemma2's (L/2, 2, P, …) pages at batch 1 is
    (None, dp, …): dp on the pair axis; the port shards the pages."""
    jcfg, cfg = j_get_config("gemma2-2b"), get_config("gemma2-2b")
    mesh = FakeMesh(MESHES["16x16"])
    caches = jax.eval_shape(lambda: jlm.make_cache(jcfg, 1, max_len=1024))
    want = _ref_flat(JSR.ShardingRules(jcfg, mesh).cache_specs(caches, 1))
    assert want["kv/k_pages"] == (None, "data", None, None, None)
    got = SR.ShardingRules(cfg, mesh).cache_specs(
        lm.make_cache(cfg, 1, 1024, device="meta"), 1)
    assert tuple(got["kv"][0].k_pages) == ("data", None, None, None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_token_activation_specs_match_jax(mesh):
    cfg, jcfg = get_config("minicpm-2b"), j_get_config("minicpm-2b")
    rules = SR.ShardingRules(cfg, FakeMesh(MESHES[mesh]))
    jrules = JSR.ShardingRules(jcfg, FakeMesh(MESHES[mesh]))
    assert tuple(rules.batch_spec()) == tuple(jrules.batch_spec())
    for extra in (0, 1, 2):
        assert tuple(rules.token_spec(extra)) == tuple(
            jrules.token_spec(extra))
    assert tuple(rules.activation_spec()) == tuple(jrules.activation_spec())


def _norm(choice):
    return None if choice is None else tuple(tuple(s) for s in choice)


@pytest.mark.parametrize("pod", [0, 2])
@pytest.mark.parametrize("mode", ["auto", "none"])
def test_attn_act_spec_matches_jax(mode, pod):
    cfg = get_config("minicpm-2b").replace(attn_activation_shard=mode)
    jcfg = j_get_config("minicpm-2b").replace(attn_activation_shard=mode)
    n_some = 0
    for heads in (8, 12, 24, 32):
        for tp in (1, 2, 16):
            for dp in (1, 2, 16):
                shape = ({"pod": pod} if pod else {}) | {"data": dp,
                                                         "model": tp}
                for b in (1, 2, 8, 32, 64):
                    for s in (1, 16, 30, 4096):
                        args = (FakeMesh(shape), b, s)
                        got = A._attn_act_spec(cfg.replace(n_heads=heads),
                                               *args)
                        want = JA._attn_act_spec(
                            jcfg.replace(n_heads=heads), *args)
                        assert _norm(got) == _norm(want), (heads, shape, b, s)
                        n_some += got is not None
    assert (n_some > 0) == (mode == "auto")
    assert A._attn_act_spec(cfg, None, 8, 16) is None


def test_named_gives_one_placement_a_mesh_dim():
    pod = FakeMesh(MESHES["2x16x16"])
    flat = FakeMesh(MESHES["16x16"])
    P = SR.PartitionSpec
    assert SR.named(pod, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert SR.named(pod, P()) == (Replicate(),) * 3
    assert SR.named(flat, P(None, "model")) == (Replicate(), Shard(1))
    tree = SR.named(flat, {"a": P("data"), "b": [P(), P("model", None)]})
    assert tree == {"a": (Shard(0), Replicate()),
                    "b": [(Replicate(),) * 2, (Replicate(), Shard(0))]}


# ------------------------------------------------------- cache shards

@pytest.mark.parametrize("batch,max_len,n,layout", [
    (8, 256, 2, "rows"), (8, 256, 4, "rows"), (8, 256, 1, "rows"),
    (1, 512, 4, "pages"), (1, 512, 2, "pages"), (6, 256, 4, None),
    (1, 384, 2, None)])
def test_cache_shards(batch, max_len, n, layout):
    ps = 128
    pps = max_len // ps
    assert paged.shard_layout(batch, pps, n) == layout
    rng = np.random.default_rng(batch * n)
    whole = paged.make(batch, max_len, 2, 4, page_size=ps,
                       dtype=torch.float32, device="cpu")
    whole = whole._replace(
        k_pages=torch.from_numpy(rng.standard_normal(
            whole.k_pages.shape).astype(np.float32)),
        lengths=torch.from_numpy(rng.integers(0, max_len, batch).astype(
            np.int32)))
    shards = [paged.shard(whole, i, n) for i in range(n)]
    for i, s in enumerate(shards):
        empty = paged.make(batch, max_len, 2, 4, page_size=ps,
                           dtype=torch.float32, device="cpu", shard=(i, n))
        assert empty.k_pages.shape == s.k_pages.shape
        assert torch.equal(empty.page_table, s.page_table)
        if layout == "rows":
            assert s.k_pages.shape[0] == batch * pps // n
            assert torch.equal(s.page_table, whole.page_table[
                i * batch // n:(i + 1) * batch // n])
        elif layout == "pages":
            assert s.k_pages.shape[0] == pps // n
    back = paged.unshard(shards, batch)
    for a, b in zip(back, whole):
        assert torch.equal(a, b)
