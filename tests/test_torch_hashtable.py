"""Port parity: ``repro_torch.core.hashtable`` vs ``repro.core.hashtable``
on the same seeded numpy inputs: the stored keys (in (hash, key) order),
values, counts, overflow flags and lookups bit for bit, through inserts,
removes and syncs with the default last-wins merge and with the
benchmark's add combine (``benchmarks/constructs.py:100-105``); the
per-key op order of ``TestRoomyHashTableOpOrder`` (DEL→PUT resurrects,
PUT→DEL removes); lookups of missing keys; queue and table overflow.

Keys are uint32 in the reference and int32 tensors with the same bits in
the port.  The reference's functions run jitted (eagerly each small op
compiles on its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashtable as JHT
from repro_torch.core import hashtable as HT


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jinsert = jax.jit(JHT.insert)
_jremove = jax.jit(JHT.remove)
_jsync = jax.jit(JHT.sync, static_argnums=(1, 2))
_jlookup = jax.jit(JHT.lookup)

ADD = (lambda a, b: a + b, lambda a, b: a + b)
ADD_APPLY = (lambda o, g, p: torch.where(p, o + g, g),
             lambda o, g, p: jnp.where(p, o + g, g))
ADD_APPLY_ROWS = (lambda o, g, p: torch.where(p[:, None], o + g, g),
                  lambda o, g, p: jnp.where(p[:, None], o + g, g))


def _k(keys):
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint32)
                            .view(np.int32).copy())


class Both:
    """One table in each package, driven by the same calls."""

    def __init__(self, cap, kw, qcap, val_shape=()):
        self.j = JHT.make(cap, kw, qcap, val_shape=val_shape,
                          val_dtype=jnp.int32)
        self.t = HT.make(cap, kw, qcap, val_shape=val_shape,
                         val_dtype=torch.int32, device="cpu")

    def insert(self, keys, vals, valid=None):
        self.j, jo = _jinsert(self.j, jnp.asarray(keys), jnp.asarray(vals),
                              None if valid is None else jnp.asarray(valid))
        self.t, to = HT.insert(self.t, _k(keys), torch.from_numpy(vals),
                               None if valid is None
                               else torch.from_numpy(valid))
        assert bool(jo) == bool(to)
        return bool(to)

    def remove(self, keys):
        self.j, jo = _jremove(self.j, jnp.asarray(keys))
        self.t, to = HT.remove(self.t, _k(keys))
        assert bool(jo) == bool(to)

    def sync(self, add=False):
        if add:
            app = ADD_APPLY if self.t.vals.ndim == 1 else ADD_APPLY_ROWS
            self.j, jo = _jsync(self.j, ADD[1], app[1])
            self.t, to = HT.sync(self.t, ADD[0], app[0])
        else:
            self.j, jo = _jsync(self.j, None, None)
            self.t, to = HT.sync(self.t)
        assert bool(jo) == bool(to)
        self.check()
        return bool(to)

    def check(self):
        assert np.array_equal(self.t.keys.numpy().view(np.uint32),
                              np.asarray(self.j.keys))
        assert np.array_equal(self.t.vals.numpy(), np.asarray(self.j.vals))
        assert int(self.t.count) == int(self.j.count)
        assert int(HT.size(self.t)) == int(JHT.size(self.j))
        assert int(self.t.q_n) == int(self.j.q_n)

    def lookup(self, queries):
        jv, jf = _jlookup(self.j, jnp.asarray(queries))
        tv, tf = HT.lookup(self.t, _k(queries))
        assert np.array_equal(tf.numpy(), np.asarray(jf))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        return tv.numpy(), tf.numpy()


def _keys(rng, m, kw, hi):
    keys = rng.integers(0, hi, (m, kw)).astype(np.uint32)
    keys[rng.random((m, kw)) < 0.1] |= np.uint32(0x80000000)
    return keys


@pytest.mark.parametrize("kw", [1, 2, 3])
@pytest.mark.parametrize("add", [False, True], ids=["last_wins", "add"])
def test_windows_of_inserts_and_removes(kw, add):
    rng = np.random.default_rng(kw + 10 * add)
    both = Both(96, kw, 64)
    for _ in range(3):
        keys = _keys(rng, 40, kw, 12)
        both.insert(keys, rng.integers(-50, 50, 40).astype(np.int32))
        both.remove(_keys(rng, 8, kw, 12))
        both.sync(add)
    queries = np.concatenate([_keys(rng, 30, kw, 14),
                              np.full((2, kw), 0xFFFFFFFF, np.uint32)])
    _, found = both.lookup(queries)
    assert not found[-2:].any()                    # sentinel keys never hit


def test_vector_values_and_valid_mask():
    rng = np.random.default_rng(4)
    both = Both(64, 2, 64, val_shape=(3,))
    keys = _keys(rng, 50, 2, 10)
    valid = rng.random(50) < 0.6
    both.insert(keys, rng.integers(0, 9, (50, 3)).astype(np.int32), valid)
    both.sync(add=True)
    both.lookup(keys)


def test_benchmark_insert_sum_matches_dict():
    """The benchmark's round trip (``benchmarks/constructs.py:100-105``):
    one window of inserts with duplicates, summed per key."""
    rng = np.random.default_rng(7)
    n = 256
    keys = rng.integers(0, n, (n, 1)).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    both = Both(2 * n, 1, n)
    both.insert(keys, vals)
    both.sync(add=True)
    want = {}
    for k, v in zip(keys[:, 0].tolist(), vals.tolist()):
        want[k] = want.get(k, 0) + v
    assert int(both.t.count) == len(want)
    q = np.array([[k] for k in sorted(want)] + [[n + 5]], np.uint32)
    v, f = both.lookup(q)
    assert f[:-1].all() and not f[-1]
    assert v[:-1].tolist() == [want[k] for k in sorted(want)]


class TestOpOrder:
    """``tests/test_roomy_core.py::TestRoomyHashTableOpOrder`` on both."""

    def _one(self, key, val):
        return (np.array([[key]], np.uint32), np.array([val], np.int32))

    def test_del_then_put_resurrects(self):
        both = Both(16, 1, 16)
        both.insert(*self._one(7, 1))
        both.sync()
        both.remove(self._one(7, 0)[0])
        both.insert(*self._one(7, 5))
        both.sync(add=True)
        v, f = both.lookup(self._one(7, 0)[0])
        assert f[0] and v[0] == 5 and int(both.t.count) == 1

    def test_put_then_del_removes(self):
        both = Both(16, 1, 16)
        both.insert(*self._one(7, 1))
        both.sync()
        both.insert(*self._one(7, 9))
        both.remove(self._one(7, 0)[0])
        both.sync()
        _, f = both.lookup(self._one(7, 0)[0])
        assert not f[0] and int(both.t.count) == 0

    def test_puts_after_del_combine_fresh(self):
        both = Both(16, 1, 16)
        both.insert(*self._one(3, 100))
        both.sync()
        both.remove(self._one(3, 0)[0])
        both.insert(np.array([[3], [3]], np.uint32),
                    np.array([2, 3], np.int32))
        both.sync(add=True)
        v, f = both.lookup(self._one(3, 0)[0])
        assert f[0] and v[0] == 5 and int(both.t.count) == 1

    def test_del_of_absent_key_is_noop(self):
        both = Both(16, 1, 16)
        both.remove(self._one(42, 0)[0])
        both.sync()
        _, f = both.lookup(self._one(42, 0)[0])
        assert not f[0] and int(both.t.count) == 0

    def test_matches_sequential_dict(self):
        rng = np.random.default_rng(11)
        both = Both(64, 1, 128)
        want = {}
        for _wnd in range(3):
            for _ in range(25):
                k, v, d = (int(rng.integers(0, 12)), int(rng.integers(0, 50)),
                           bool(rng.random() < 0.3))
                if d:
                    both.remove(self._one(k, 0)[0])
                    want.pop(k, None)
                else:
                    both.insert(*self._one(k, v))
                    want[k] = want.get(k, 0) + v
            both.sync(add=True)
        assert int(both.t.count) == len(want)
        q = np.array([[k] for k in sorted(want)], np.uint32)
        v, f = both.lookup(q)
        assert f.all() and v.tolist() == [want[k] for k in sorted(want)]


def test_queue_and_table_overflow():
    rng = np.random.default_rng(2)
    both = Both(8, 1, 10)
    keys = np.arange(14, dtype=np.uint32)[:, None]
    assert not both.insert(keys[:6], np.ones(6, np.int32))
    assert both.insert(keys[6:], np.ones(8, np.int32))   # 14 > 10 queued
    assert int(both.t.q_n) == 10
    assert both.sync()                                  # 10 keys > 8 slots
    assert int(both.t.count) == 8
    both.lookup(_keys(rng, 20, 1, 16))


def test_map_reduce_predicate_count():
    rng = np.random.default_rng(6)
    both = Both(40, 2, 40)
    both.insert(_keys(rng, 30, 2, 50), rng.integers(0, 20, 30).astype(
        np.int32))
    both.sync(add=True)
    fn = lambda k, v: (k[..., 0] ^ k[..., 1]) + v        # noqa: E731
    assert np.array_equal(HT.map_items(both.t, fn).numpy(),
                          np.asarray(JHT.map_items(both.j, fn)).view(np.int32))
    elt = lambda k, v: v * 2                             # noqa: E731
    got = HT.reduce(both.t, elt, lambda a, b: a + b, 0)
    want = JHT.reduce(both.j, elt, lambda a, b: a + b, jnp.int32(0))
    assert int(got) == int(want)
    pred = lambda k, v: v > 10                           # noqa: E731
    assert int(HT.predicate_count(both.t, pred)) == \
        int(JHT.predicate_count(both.j, pred))
