"""Port parity: ``repro_torch.core.rset`` and the set constructs of
``repro_torch.core.constructs`` vs ``repro.core.rset`` / ``repro.core.
constructs`` on the same seeded numpy inputs.

Every RoomySet operation (``_normalize`` through ``from_rows`` and
``from_list``, the three keep rules of ``_merge`` with their output
capacities, ``member_mask``, ``size``, ``to_numpy``) and the paper's set
recipes on RoomyLists (``set_union``, ``set_difference``, the
3-temporary ``set_intersection``) run in both packages; ``data`` (rows
past ``count`` included) and ``count`` are compared bit for bit.  The
recipes are also held, as sets, to the native RoomySet operations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constructs as JC
from repro.core import rlist as JRL
from repro.core import rset as JRS
from repro_torch import convert
from repro_torch.core import constructs as C
from repro_torch.core import rlist as RL
from repro_torch.core import rset as RS

from test_torch_rlist import lists, same, same_bits, t, words


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


j_from_rows = jax.jit(JRS.from_rows, static_argnums=1)


def sets(seed, w, n, cap):
    """One set in both packages, from n rows of ``words`` (duplicates, the
    sentinel, bit 31) at capacity ``cap``."""
    rows = words(np.random.default_rng(seed), n, w)
    js = j_from_rows(jnp.asarray(rows), cap)
    ts = RS.from_rows(rows, capacity=cap, device="cpu")
    same(ts, js)
    return js, ts


CASES = [(w, seed) for w in (1, 2, 3) for seed in (0, 1, 2)]


@pytest.mark.parametrize("w,seed", CASES)
def test_from_rows_from_list_make(w, seed):
    js, ts = sets(seed, w, 12, 20)
    rows = RS.to_numpy(ts)
    assert rows.dtype == np.uint32
    np.testing.assert_array_equal(rows, JRS.to_numpy(js))
    assert [tuple(r) for r in rows] == sorted({tuple(r) for r in rows})
    assert not np.all(rows == 0xFFFFFFFF, axis=1).any()
    same(RS.from_rows(t(words(np.random.default_rng(seed), 9, w)),
                      device="cpu"),
         j_from_rows(jnp.asarray(words(np.random.default_rng(seed), 9, w)),
                     None))
    jl, tl = lists(seed + 30, w, 24, 5 * seed + 3)     # garbage past count
    same(RS.from_list(tl), jax.jit(JRS.from_list)(jl))
    same(RS.make(6, w, "cpu"), JRS.make(6, w))
    assert int(RS.size(ts)) == int(JRS.size(js))


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("op", ["union", "intersection", "difference"])
def test_merge_ops(op, w):
    """Both orders, b holding 3 of a's rows then 0, 10 and 25 of its own
    (filling its capacity), and a with itself."""
    fn = jax.jit(getattr(JRS, op))
    ja, ta = sets(w, w, 14, 20)
    for nb in (0, 10, 25):
        rows_b = np.concatenate([np.asarray(ja.data)[:3],
                                 words(np.random.default_rng(nb), nb, w)])
        jb = j_from_rows(jnp.asarray(rows_b), 28)
        tb = convert.rset_from_jax(jb, device="cpu")
        got = getattr(RS, op)(ta, tb)
        same(got, fn(ja, jb))
        assert got.capacity == (48 if op == "union" else 28)
        same(getattr(RS, op)(tb, ta), fn(jb, ja))
    same(getattr(RS, op)(ta, ta), fn(ja, ja))


def test_merge_rejects_unknown_rule():
    _, ts = sets(0, 1, 4, 4)
    with pytest.raises(ValueError):
        RS._merge(ts, ts, "xor")


@pytest.mark.parametrize("w,seed", CASES)
def test_member_mask(w, seed):
    js, ts = sets(seed, w, 12, 16)
    rng = np.random.default_rng(seed + 40)
    queries = np.concatenate([np.asarray(js.data)[rng.integers(0, 16, 5)],
                              words(rng, 7, w)])
    got = RS.member_mask(ts, t(queries))
    same_bits(got, jax.jit(JRS.member_mask)(js, jnp.asarray(queries)))
    live = {tuple(r) for r in RS.to_numpy(ts)}
    assert got.tolist() == [tuple(q) in live for q in queries]


def _as_set(rl):
    return {tuple(r) for r in RL.to_numpy(rl)}


@pytest.mark.parametrize("w,seed", CASES)
def test_set_constructs(w, seed):
    """The RoomyList recipes vs the reference's, bit for bit, and vs the
    native RoomySet operations as sets (a and b are sets: the recipes
    assume it)."""
    ja, ta = sets(seed, w, 14, 34)      # room for a ∪ b in a's capacity
    rows_b = np.concatenate([np.asarray(ja.data)[:4],
                             words(np.random.default_rng(seed + 9), 10, w)])
    jb = j_from_rows(jnp.asarray(rows_b), None)
    tb = RS.from_rows(rows_b, device="cpu")
    jla, jlb = (JRL.RoomyList(s.data, s.count) for s in (ja, jb))
    tla, tlb = (RL.RoomyList(s.data, s.count) for s in (ta, tb))
    u = C.set_union(tla, tlb)
    same(u, jax.jit(JC.set_union)(jla, jlb))
    assert _as_set(u) == _as_set(RS.union(ta, tb))
    d = C.set_difference(tla, tlb)
    same(d, jax.jit(JC.set_difference)(jla, jlb))
    assert _as_set(d) == _as_set(RS.difference(ta, tb))
    i = C.set_intersection(tla, tlb)
    same(i, jax.jit(JC.set_intersection)(jla, jlb))
    assert _as_set(i) == _as_set(RS.intersection(ta, tb))
    assert i.capacity == ta.capacity + tb.capacity
    i = C.set_intersection(tla, tlb, capacity=40)
    same(i, jax.jit(JC.set_intersection, static_argnums=2)(jla, jlb, 40))
