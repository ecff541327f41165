"""Port parity: ``repro_torch.optim`` (AdamW, schedules, gradient
compression) against ``repro.optim``.

The same numpy inputs go through both packages.  Integer results (int8
codes, top-k indices, byte counts, the step) must match exactly; float
results within rtol 1e-6 (float32 arithmetic in the same order of
operations; the two libraries' reductions, pow and cos may round the last
bit differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch import optim as toptim
from repro_torch import tree as T
from repro_torch.optim import compress as tcompress
from repro_torch.optim import schedule as tschedule

FLOAT = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    """A nested dict of float32 arrays, some not a multiple of 256 long."""
    return {"w": (rng.standard_normal((7, 33)) * scale).astype(np.float32),
            "blk": {"a": (rng.standard_normal((300,)) * scale
                          ).astype(np.float32),
                    "b": (rng.standard_normal((2, 256)) * scale
                          ).astype(np.float32)},
            "g": (rng.standard_normal((5,)) * scale).astype(np.float32)}


def _j(tree):
    return T.tree_map(jnp.asarray, tree)


def _t(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(t_tree, j_tree, **tol):
    for a, b in zip(T.leaves(t_tree), T.leaves(j_tree)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **(tol or FLOAT))


@pytest.mark.parametrize("clip_norm,grad_scale", [(1.0, 1.0), (1.0, 0.01),
                                                  (None, 1.0)])
def test_adamw_three_steps(clip_norm, grad_scale):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, tp = _j(p0), _t(p0)
    js, ts = joptim.init(jp), toptim.init(tp)
    for step in range(3):
        g = _tree(rng, grad_scale)
        lr = 1e-2 * (step + 1)
        jp, js, jn = joptim.update(_j(g), js, jp, lr=lr, clip_norm=clip_norm)
        tp_new, ts, tn = toptim.update(_t(g), ts, tp, lr=lr,
                                       clip_norm=clip_norm)
        assert tp_new is tp                   # in place
        np.testing.assert_allclose(float(tn), float(jn), **FLOAT)
        assert ts.step == int(js.step) == step + 1
        _close(tp, jp)
        _close(ts.m, js.m)
        _close(ts.v, js.v)


def test_global_norm_and_clip():
    rng = np.random.default_rng(1)
    g = _tree(rng, 3.0)
    np.testing.assert_allclose(float(toptim.global_norm(_t(g))),
                               float(joptim.global_norm(_j(g))), **FLOAT)
    for max_norm in (0.5, 1e3):
        tc, tn = toptim.clip_by_global_norm(_t(g), max_norm)
        jc, jn = joptim.clip_by_global_norm(_j(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), **FLOAT)
        _close(tc, jc)


@pytest.mark.parametrize("name,args", [
    ("wsd", (3e-4, 10, 25, 15)), ("wsd", (1e-2, 0, 5, 3, 0.2)),
    ("cosine", (3e-4, 10, 50)), ("cosine", (1e-3, 0, 7, 0.0)),
    ("constant", (3e-4,))])
def test_schedules(name, args):
    t_fn, j_fn = getattr(tschedule, name)(*args), getattr(jschedule, name)(
        *args)
    got = np.array([t_fn(s) for s in range(60)], np.float32)
    want = np.array([float(j_fn(s)) for s in range(60)], np.float32)
    np.testing.assert_allclose(got, want, **FLOAT)


def test_int8_compress_with_error_feedback():
    rng = np.random.default_rng(2)
    t_res = j_res = None
    for _ in range(3):
        g = _tree(rng)
        t_msg, t_res = tcompress.int8_compress(_t(g), t_res)
        j_msg, j_res = jcompress.int8_compress(_j(g), j_res)
        for a, b in zip(T.leaves(t_msg.q), T.leaves(j_msg.q)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(t_msg.scale, j_msg.scale)
        _close(t_res, j_res)
        _close(tcompress.int8_decompress(t_msg, _t(g)),
               jcompress.int8_decompress(j_msg, _j(g)))
        assert tcompress.wire_bytes(t_msg) == jcompress.wire_bytes(j_msg)


def test_topk_compress_with_error_feedback():
    rng = np.random.default_rng(3)
    t_res = j_res = None
    for _ in range(3):
        g = _tree(rng)
        t_msg, t_res = tcompress.topk_compress(_t(g), t_res, density=0.1)
        j_msg, j_res = jcompress.topk_compress(_j(g), j_res, density=0.1)
        for ti, tv, ji, jv in zip(T.leaves(t_msg.idx), T.leaves(t_msg.val),
                                  T.leaves(j_msg.idx), T.leaves(j_msg.val)):
            order, jorder = np.argsort(ti.numpy()), np.argsort(np.asarray(ji))
            np.testing.assert_array_equal(ti.numpy()[order],
                                          np.asarray(ji)[jorder])
            np.testing.assert_allclose(tv.numpy()[order],
                                       np.asarray(jv)[jorder], **FLOAT)
        _close(t_res, j_res)
        _close(tcompress.topk_decompress(t_msg, _t(g)),
               jcompress.topk_decompress(j_msg, _j(g)))
        assert tcompress.wire_bytes(t_msg) == jcompress.wire_bytes(j_msg)


def _layers(rng, n=3):
    """A tree as the reference stacks it ({"blocks": (n, ...) arrays}) and
    as the port keeps it ({"blocks": [per-layer dict] * n}); leaves of 150
    and 7 x 5 elements, so int8 blocks straddle layers."""
    j = {"blocks": {"a": rng.standard_normal((n, 150)).astype(np.float32),
                    "b": rng.standard_normal((n, 7, 5)).astype(np.float32)},
         "w": rng.standard_normal((40,)).astype(np.float32)}
    t = {"blocks": [{"a": j["blocks"]["a"][i], "b": j["blocks"]["b"][i]}
                    for i in range(n)], "w": j["w"]}
    return t, j


def _as_layers(j_tree, n=3):
    """The reference's stacked tree in the port's per-layer layout."""
    return {"blocks": [{k: np.asarray(v)[i] for k, v in
                        j_tree["blocks"].items()} for i in range(n)],
            "w": np.asarray(j_tree["w"])}


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codecs_encode_the_reference_stacked_leaves(codec):
    """Per-layer leaves are encoded as the reference's stacked leaf: the
    same message (int8 blocks across layer boundaries, top-k over all
    layers), and residual and gradient in the port's layout."""
    rng = np.random.default_rng(4)
    t_res = j_res = None
    kw = {} if codec == "int8" else {"density": 0.1}
    tenc, tdec = (getattr(tcompress, f"{codec}_{f}") for f in
                  ("compress", "decompress"))
    jenc, jdec = (getattr(jcompress, f"{codec}_{f}") for f in
                  ("compress", "decompress"))
    for _ in range(3):
        t, j = _layers(rng)
        t_msg, t_res = tenc(_t(t), t_res, **kw)
        j_msg, j_res = jenc(_j(j), j_res, **kw)
        if codec == "int8":
            for a, b in zip(T.leaves(t_msg), T.leaves(j_msg)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            for ti, tv, ji, jv in zip(T.leaves(t_msg.idx), T.leaves(t_msg.val),
                                      T.leaves(j_msg.idx), T.leaves(j_msg.val)):
                order, jorder = np.argsort(ti.numpy()), np.argsort(
                    np.asarray(ji))
                np.testing.assert_array_equal(ti.numpy()[order],
                                              np.asarray(ji)[jorder])
                np.testing.assert_array_equal(tv.numpy()[order],
                                              np.asarray(jv)[jorder])
        _close(t_res, _as_layers(j_res))
        _close(tdec(t_msg, _t(t)), _as_layers(jdec(j_msg, _j(j))))
        assert tcompress.wire_bytes(t_msg) == jcompress.wire_bytes(j_msg)


def test_tree_helpers_round_trip():
    tree = {"a": [1, 2, {"b": 3}], "c": toptim.AdamWState(4, {"m": 5}, [6])}
    assert T.leaves(tree) == [1, 2, 3, 4, 5, 6]
    assert [p for p, _ in T.flatten_with_path(tree)][3:] == [
        ("c", "step"), ("c", "m", "m"), ("c", "v", "0")]
    assert T.unflatten(tree, range(10, 16)) == {
        "a": [10, 11, {"b": 12}], "c": toptim.AdamWState(13, {"m": 14}, [15])}
    with pytest.raises(ValueError):
        T.unflatten(tree, range(7))
