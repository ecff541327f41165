"""Port parity: ``repro_torch.configs.shapes`` and ``configs.inputs`` vs
``repro.configs.shapes`` and ``repro.configs.inputs``.

* ``SHAPES`` field for field, and ``shape_applicable`` for every shape and
  family;
* ``make_inputs`` bit for bit against the reference's numpy draws, for
  every arch at SMOKE under stand-in ``ShapeSpec``s of each kind, the
  decode caches against the reference's stacked caches carried across
  (``convert.lm_caches_from_jax``);
* ``input_specs`` at FULL x every shape: the same shapes and dtypes, the
  caches per layer against the reference's stacked ones (gemma2's (L/2,
  2, …) pairs laid out as one (L, …) stack), as
  ``tests/test_torch_sharding_rules.py`` compares them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import inputs as JI
from repro.configs import shapes as JS
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config
from repro_torch.configs import inputs as I
from repro_torch.configs import shape_applicable

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
STAND_INS = [ShapeSpec("t", 24, 2, "train"), ShapeSpec("p", 24, 2, "prefill"),
             ShapeSpec("d", 200, 2, "decode")]
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def test_shapes_match_the_reference():
    assert list(SHAPES) == list(JS.SHAPES)
    for name, spec in SHAPES.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(
            JS.SHAPES[name])


@pytest.mark.parametrize("family", FAMILIES)
def test_shape_applicable_matches_the_reference(family):
    for name in SHAPES:
        assert shape_applicable(SHAPES[name], family) == \
            JS.shape_applicable(JS.SHAPES[name], family)
    assert shape_applicable(SHAPES["long_500k"], family) == (
        family in ("ssm", "hybrid"))


def test_registries_have_every_family():
    assert {get_config(a).family for a in ARCH_IDS} == set(FAMILIES)


def _j_shape(spec):
    return JS.ShapeSpec(spec.name, spec.seq_len, spec.global_batch, spec.kind)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (the inputs and labels)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", STAND_INS, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_inputs_bit_for_bit(arch, spec, seed):
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    got = I.make_inputs(cfg, spec, seed=seed, device="cpu")
    want = JI.make_inputs(jcfg, _j_shape(spec), seed=seed)
    assert set(got) == set(want)
    g_in = _flat({k: v for k, v in got.items() if k != "caches"})
    w_in = _flat({k: v for k, v in want.items() if k != "caches"})
    assert set(g_in) == set(w_in)
    for path, w in w_in.items():
        g = g_in[path]
        assert g.device.type == "cpu"
        w = np.asarray(w)
        assert g.dtype == DTYPES[w.dtype] and tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    if spec.kind != "decode":
        return
    carried = convert.lm_caches_from_jax(want["caches"], cfg, device="cpu")
    assert set(got["caches"]) == set(carried)
    for kind, layers in carried.items():
        assert len(got["caches"][kind]) == len(layers)
        for mine, theirs in zip(got["caches"][kind], layers):
            for f, a, b in zip(theirs._fields, mine, theirs):
                assert a.dtype == b.dtype and a.shape == b.shape, (kind, f)
                assert torch.equal(a, b), (kind, f)


def test_make_inputs_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        I.make_inputs(get_config("gemma2-2b", smoke=True), STAND_INS[0])


def _one_stack(caches, cfg):
    """The reference's caches with gemma2's (L/2, 2, …) leaves as (L, …)."""
    if not cfg.local_global_pattern:
        return caches
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        (a.shape[0] * a.shape[1],) + a.shape[2:], a.dtype), caches)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    got = I.input_specs(cfg, SHAPES[shape])
    want = JI.input_specs(jcfg, JS.SHAPES[shape])
    assert set(got) == set(want)
    g_in = _flat({k: v for k, v in got.items() if k != "caches"})
    w_in = _flat({k: v for k, v in want.items() if k != "caches"})
    assert set(g_in) == set(w_in)
    for path, w in w_in.items():
        g = g_in[path]
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == DTYPES[jnp.dtype(w.dtype)], path
    if "caches" not in want:
        return
    stacked = _one_stack(want["caches"], jcfg)
    assert set(got["caches"]) == set(stacked)
    for kind, tree in stacked.items():
        layers = got["caches"][kind]
        n = tree[0].shape[0]
        assert len(layers) == n, kind
        for entry in layers:
            for f, leaf in zip(tree._fields, tree):
                mine = getattr(entry, f)
                assert mine.device.type == "meta", (kind, f)
                assert tuple(mine.shape) == tuple(leaf.shape[1:]), (kind, f)
                assert mine.dtype == DTYPES[jnp.dtype(leaf.dtype)], (kind, f)
