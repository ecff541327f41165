"""Port parity: ``repro_torch.core.array`` (RoomyArray) and the §3
constructs ``chain_reduce`` / ``parallel_prefix`` / ``pair_reduce`` of
``repro_torch.core.constructs`` vs ``repro.core.array`` /
``repro.core.constructs`` on the same seeded numpy inputs.

Integer results are compared bit for bit.  float32 results within atol =
rtol = 1e-4 (``tests/test_kernels.py:150-151``, K5's limit): the port's
``add``/``add`` route sums each index's payloads through K5's plain
version in float32, in another order than the reference's segmented
scan.  A float32 sync where each index receives one op (chain reduction,
each round of the prefix) is one addition and is compared bit for bit.

User functions are batched in the port and ``vmap``ped per element in the
reference; the ones here are written with ``...`` indexing so that one
lambda serves both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import array as JRA
from repro.core import constructs as JC
from repro_torch.core import array as RA
from repro_torch.core import constructs as C
from repro_torch.kernels import bucket_scatter as tbs

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jadd(a, b):
    return a + b


# The reference's functions run jitted: eagerly, each of the scan's small
# ops compiles on its own, which costs seconds a call.
_jupdate = jax.jit(JRA.update)
_jsync_jit = jax.jit(JRA.sync, static_argnums=(1, 2, 3))
_jchain = jax.jit(JC.chain_reduce, static_argnums=1)
_jprefix = jax.jit(JC.parallel_prefix, static_argnums=1)


def _jsync(ja, combine, apply, pred=None):
    return _jsync_jit(ja, combine, apply, pred)


DTYPES = {"int32": (np.int32, torch.int32, jnp.int32),
          "float32": (np.float32, torch.float32, jnp.float32)}


def _make_both(data, qcap, pred=None, jpred=None):
    npd = data.dtype
    tdt = torch.from_numpy(np.zeros(0, npd)).dtype
    ja = JRA.make(jnp.asarray(data), qcap, payload_shape=data.shape[1:],
                  payload_dtype=jnp.asarray(data).dtype, pred=jpred)
    ta = RA.make(torch.from_numpy(data.copy()), qcap,
                 payload_shape=data.shape[1:], payload_dtype=tdt, pred=pred)
    return ja, ta


def _update_both(ja, ta, idx, pay, valid=None):
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    ja, jov = _jupdate(ja, jnp.asarray(idx), jnp.asarray(pay), jv)
    ta, tov = RA.update(ta, torch.from_numpy(idx), torch.from_numpy(pay), tv)
    assert bool(jov) == bool(tov)
    return ja, ta, bool(tov)


def _same_queue(ja, ta):
    assert int(ja.q_n) == int(ta.q_n)
    assert np.array_equal(np.asarray(ja.q_idx), ta.q_idx.numpy())
    assert np.array_equal(np.asarray(ja.q_pay), ta.q_pay.numpy())


def _assert_data(got, want, dtype):
    if dtype == "int32":
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ops(seed, n, m, trail, npd, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = n if hi is None else hi
    data = (rng.standard_normal((n,) + trail) * 10).astype(npd)
    idx = rng.integers(lo, hi, m).astype(np.int32)
    idx[: m // 4] = idx[0]                      # a hot index: duplicates
    pay = (rng.standard_normal((m,) + trail) * 10).astype(npd)
    return data, idx, pay


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("trail", [(), (3,)], ids=["scalar", "row3"])
def test_add_add_sync_matches_reference(dtype, trail):
    """``sync(add, add)``: float32 takes K5's plain version (one call, no
    launch booked on the CPU), int32 the scatter path; both equal the
    reference's sync with the same lambdas."""
    data, idx, pay = _ops(1, 50, 120, trail, DTYPES[dtype][0])
    ja, ta = _make_both(data, 128)
    ja, ta, _ = _update_both(ja, ta, idx, pay)
    _same_queue(ja, ta)
    want = _jsync(ja, _jadd, _jadd)
    before = dict(tbs.LAUNCHES)
    got = RA.sync(ta, RA.add, RA.add)
    assert tbs.LAUNCHES == before
    _assert_data(got.data, want.data, dtype)
    got2 = RA.sync(ta, lambda a, b: a + b, lambda a, b: a + b)  # scatter path
    _assert_data(got2.data, want.data, dtype)
    assert int(got.q_n) == 0 and bool((got.q_idx == 50).all())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["max", "first", "last_sub"])
def test_other_combines_match_reference(dtype, name):
    combine = {"max": (torch.maximum, jnp.maximum),
               "first": (lambda p, q: p, lambda p, q: p),
               "last_sub": (lambda p, q: q, lambda p, q: q)}[name]
    apply = {"max": (torch.maximum, jnp.maximum),
             "first": (lambda o, a: o - a, lambda o, a: o - a),
             "last_sub": (lambda o, a: a, lambda o, a: a)}[name]
    data, idx, pay = _ops(2, 40, 90, (2,), DTYPES[dtype][0])
    ja, ta = _make_both(data, 100)
    ja, ta, _ = _update_both(ja, ta, idx, pay)
    want = _jsync(ja, combine[1], apply[1])
    got = RA.sync(ta, combine[0], apply[0])
    _assert_data(got.data, want.data, dtype)


@pytest.mark.parametrize("route", ["k5", "scatter"])
def test_negative_and_out_of_range_indices(route):
    """[-n, 0) wraps, below -n and at or past n drop: the reference's
    scatter rule, which K5 takes.  No row is named twice (once as i and
    once as i - n), where the reference's scatter-set picks one writer."""
    idx = np.array([-1, 5, 4, 0, -5, 2, 2], np.int32)
    pay = np.array([1000, 1, 1, 1, 9, 3, 4], np.float32)
    ja, ta = _make_both(np.zeros(4, np.float32), 8)
    ja, ta, _ = _update_both(ja, ta, idx, pay)
    want = np.asarray(_jsync(ja, _jadd, _jadd).data)
    c = RA.add if route == "k5" else (lambda a, b: a + b)
    got = RA.sync(ta, c, c).data.numpy()
    assert np.array_equal(got, want)
    assert got.tolist() == [1, 0, 7, 1000]


def test_queue_overflow_drops_and_flags():
    data, idx, pay = _ops(3, 30, 25, (), np.int32)
    ja, ta = _make_both(data, 16)
    ja, ta, ov = _update_both(ja, ta, idx[:10], pay[:10])
    assert not ov
    valid = np.random.default_rng(3).random(15) < 0.8
    ja, ta, ov = _update_both(ja, ta, idx[10:], pay[10:], valid)
    assert ov == (10 + valid.sum() > 16)
    _same_queue(ja, ta)
    ja, ta, ov = _update_both(ja, ta, idx[:3], pay[:3])
    assert ov and int(ta.q_n) == 16
    _same_queue(ja, ta)
    assert np.array_equal(RA.sync(ta, RA.add, RA.add).data.numpy(),
                          np.asarray(_jsync(ja, _jadd, _jadd).data))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_incremental_predicate_count(dtype):
    """The count kept by sync equals the reference's and a recount."""
    pred = lambda x: x[..., 0] > 0       # noqa: E731
    data, idx, pay = _ops(4, 60, 150, (2,), DTYPES[dtype][0], hi=60)
    ja, ta = _make_both(data, 160, pred=pred, jpred=pred)
    assert int(RA.predicate_count(ta)) == int(JRA.predicate_count(ja))
    for rnd in range(3):
        sl = slice(50 * rnd, 50 * rnd + 50)
        ja, ta, _ = _update_both(ja, ta, idx[sl], pay[sl])
        ja = _jsync(ja, _jadd, _jadd, pred=pred)
        ta = RA.sync(ta, RA.add, RA.add, pred=pred)
        assert int(RA.predicate_count(ta)) == int(JRA.predicate_count(ja))
        assert int(RA.predicate_count(ta)) == int(pred(ta.data).sum())
        _assert_data(ta.data, ja.data, dtype)
    ta2 = RA.sync(RA.update(ta, torch.from_numpy(idx[:40]),
                            torch.from_numpy(pay[:40]))[0],
                  torch.maximum, torch.maximum, pred=pred)
    ja2 = _jsync(_jupdate(ja, jnp.asarray(idx[:40]),
                              jnp.asarray(pay[:40]))[0],
                   jnp.maximum, jnp.maximum, pred=pred)
    assert int(ta2.pcount) == int(ja2.pcount) == int(pred(ta2.data).sum())


def test_map_update_reduce_access():
    data = np.random.default_rng(5).integers(-50, 50, (37, 2)).astype(np.int32)
    ja, ta = _make_both(data, 4)
    fn = lambda i, x: x[..., 0] * 3 + x[..., 1] - i     # noqa: E731
    assert np.array_equal(RA.map_elements(ta, fn).numpy(),
                          np.asarray(JRA.map_elements(ja, fn)))
    up = lambda i, x: x * 2 + i[..., None]              # noqa: E731
    jup = lambda i, x: x * 2 + i                        # noqa: E731
    assert np.array_equal(RA.map_update(ta, up).data.numpy(),
                          np.asarray(JRA.map_update(ja, jup).data))
    elt = lambda i, x: x[..., 0] * x[..., 0]            # noqa: E731
    got = RA.reduce(ta, elt, lambda a, b: a + b, 0)
    want = JRA.reduce(ja, elt, lambda a, b: a + b, jnp.int32(0))
    assert int(got) == int(want) == int((data[:, 0] ** 2).sum())
    got = RA.reduce(ta, elt, torch.maximum, -1)
    assert int(got) == int(JRA.reduce(ja, elt, jnp.maximum, jnp.int32(-1)))
    idx = np.array([0, 36, 5, -1, -40, 99], np.int32)
    assert np.array_equal(RA.access(ta, torch.from_numpy(idx)).numpy(),
                          np.asarray(JRA.access(ja, jnp.asarray(idx))))


# ------------------------------------------------------------ constructs

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_chain_reduce(dtype, n):
    data = (np.random.default_rng(n).standard_normal((n, 2)) * 10
            ).astype(DTYPES[dtype][0])
    ja, ta = _make_both(data, n)
    want = _jchain(ja, lambda o, p: o + p)
    for comb in (lambda o, p: o + p, RA.add):
        got = C.chain_reduce(ta, comb)
        assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    got = C.chain_reduce(ta, lambda o, p: torch.maximum(o, p) * 2)
    want = _jchain(ja, lambda o, p: jnp.maximum(o, p) * 2)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 5, 37, 64, 100])
def test_parallel_prefix(dtype, n):
    """Each round gives every index at most one update, so float32 is
    bit for bit too."""
    data = (np.random.default_rng(n).standard_normal(n) * 10
            ).astype(DTYPES[dtype][0])
    ja, ta = _make_both(data, n)
    want = np.asarray(_jprefix(ja, lambda o, p: o + p).data)
    for comb in (lambda o, p: o + p, RA.add):
        got = C.parallel_prefix(ta, comb).data.numpy()
        assert np.array_equal(got, want)
    np.testing.assert_allclose(want, np.cumsum(data.astype(np.float64)),
                               rtol=1e-5, atol=1e-3)
    got = C.parallel_prefix(ta, torch.maximum).data.numpy()
    assert np.array_equal(got, np.asarray(
        _jprefix(ja, jnp.maximum).data))


@pytest.mark.parametrize("n,block", [(1, 4), (10, 4), (37, 8), (64, 64)])
def test_pair_reduce(n, block):
    data = np.random.default_rng(n).integers(-20, 20, n).astype(np.int32)
    ja, ta = _make_both(data, 1)
    got = C.pair_reduce(ta, lambda x, y: x * y, lambda p, q: p + q, 0,
                        block=block)
    want = JC.pair_reduce(ja, lambda x, y: (x * y).astype(jnp.int32),
                          lambda p, q: p + q, jnp.int32(0), block=block)
    assert int(got) == int(want) == int(data.sum()) ** 2
    got = C.pair_reduce(ta, lambda x, y: x * y, RA.add, 0, block=block)
    assert int(got) == int(want)
    rows = np.random.default_rng(n + 1).standard_normal((n, 3)).astype(
        np.float32)
    ja, ta = _make_both(rows, 1)
    dot = lambda x, y: (x * y).sum(-1)                  # noqa: E731
    got = C.pair_reduce(ta, dot, torch.maximum, float("-inf"), block=block)
    want = JC.pair_reduce(ja, dot, jnp.maximum, jnp.float32(-jnp.inf),
                          block=block)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_quickstart_tier_j_roomy_array():
    """``examples/quickstart.py:45-58``: the RoomyArray and chain-reduction
    numbers it prints."""
    ra = RA.make(torch.zeros(8, dtype=torch.int32), queue_capacity=16)
    ra, _ = RA.update(ra, torch.tensor([2, 2, 5], dtype=torch.int32),
                      torch.tensor([10, 20, 7], dtype=torch.int32))
    ra = RA.sync(ra, combine=lambda a, b: a + b,
                 apply=lambda old, agg: old + agg)
    assert ra.data.tolist() == [0, 0, 30, 0, 0, 7, 0, 0]
    ra2 = RA.make(torch.arange(6, dtype=torch.int32), queue_capacity=8)
    ra2 = C.chain_reduce(ra2, lambda old, prev: old + prev)
    assert ra2.data.tolist() == [0, 1, 3, 5, 7, 9]
    j = JRA.make(jnp.zeros(8, jnp.int32), queue_capacity=16,
                 payload_dtype=jnp.int32)
    j, _ = _jupdate(j, jnp.array([2, 2, 5], jnp.int32),
                      jnp.array([10, 20, 7], jnp.int32))
    j = _jsync(j, combine=lambda a, b: a + b,
                 apply=lambda old, agg: old + agg)
    assert np.asarray(j.data).tolist() == ra.data.tolist()
