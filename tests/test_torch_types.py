"""Port parity: ``repro_torch.core.types`` vs ``repro.core.types`` on the
same seeded numpy inputs.

Rows are uint32 in the reference and int32 tensors with the same bits in
the port.  Everything here is integer or boolean, so every comparison is
bit for bit (the lexsort permutation included: both sorts are stable).
``hash_rows`` is also held to the golden values that
``tests/test_cluster.py:82-88`` pins for the reference and its numpy
mirror ``repro.core.disk.buckets.hash_rows_np``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as JT
from repro.core.disk import buckets as JB
from repro_torch.core import types as T

ROWS1 = np.array([[0], [1], [2], [0xFFFFFFFF], [0xDEADBEEF]], np.uint32)
ROWS2 = np.array([[0, 0], [1, 2], [2, 1], [123456789, 987654321]], np.uint32)
GOLD1 = [0x39E95042, 0xA381B84E, 0x99CA38EF, 0x8BB58942, 0xBE973D59]
GOLD2 = [0x4B71867D, 0x9C77B28B, 0x702BE32B, 0x65F056C5]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rows):
    return torch.from_numpy(np.ascontiguousarray(rows, np.uint32)
                            .view(np.int32).copy())


def _u(t):
    return t.numpy().view(np.uint32)


def _rows(seed, n, w, hi=5, p_sentinel=0.2, p_high=0.2):
    """Small words (many ties), words with the top bit set, and sentinels."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, hi, (n, w)).astype(np.uint32)
    high = rng.random((n, w)) < p_high
    rows[high] = (rows[high] | 0x80000000) ^ rng.integers(0, 3, high.sum()
                                                         ).astype(np.uint32)
    rows[rng.random(n) < p_sentinel] = 0xFFFFFFFF
    return rows


def test_sentinels_and_validity():
    rows = _rows(0, 40, 3)
    assert np.array_equal(_u(T.sentinel_rows(4, 3)),
                          np.asarray(JT.sentinel_rows(4, 3)))
    j = jnp.asarray(rows)
    assert np.array_equal(T.is_sentinel(_t(rows)).numpy(),
                          np.asarray(JT.is_sentinel(j)))
    assert np.array_equal(T.rows_valid(_t(rows)).numpy(),
                          np.asarray(JT.rows_valid(j)))
    assert np.array_equal(T.rows_equal(_t(rows), _t(rows[::-1])).numpy(),
                          np.asarray(JT.rows_equal(j, j[::-1])))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
def test_lexsort_permutation_equal_and_sentinels_last(w):
    rows = _rows(w, 300, w)
    got = T.lexsort_rows(_t(rows)).numpy()
    assert np.array_equal(got, np.asarray(JT.lexsort_rows(jnp.asarray(rows))))
    s = rows[got]
    sent = np.all(s == 0xFFFFFFFF, axis=1)
    assert sent.sum() and np.all(sent[-sent.sum():])   # all at the end
    assert [tuple(r) for r in s] == sorted(tuple(r) for r in rows)


def test_run_ids_and_first_of_run():
    rows = _rows(7, 200, 2, hi=3)
    s = rows[np.asarray(JT.lexsort_rows(jnp.asarray(rows)))]
    assert np.array_equal(T.run_ids(_t(s)).numpy(),
                          np.asarray(JT.run_ids(jnp.asarray(s))))
    assert np.array_equal(T.first_of_run(_t(s)).numpy(),
                          np.asarray(JT.first_of_run(jnp.asarray(s))))


def test_hash_rows_golden():
    assert _u(T.hash_rows(_t(ROWS1))).tolist() == GOLD1
    assert _u(T.hash_rows(_t(ROWS2))).tolist() == GOLD2


@pytest.mark.parametrize("w", [1, 2, 3])
def test_hash_rows_matches_jax_and_numpy_mirror(w):
    rng = np.random.default_rng(w)
    rows = rng.integers(0, 1 << 32, (256, w), dtype=np.uint64).astype(
        np.uint32)
    got = _u(T.hash_rows(_t(rows)))
    assert np.array_equal(got, np.asarray(JT.hash_rows(jnp.asarray(rows))))
    assert np.array_equal(got, JB.hash_rows_np(rows))
    seed = 12345
    assert np.array_equal(_u(T.hash_rows(_t(rows), seed)),
                          np.asarray(JT.hash_rows(jnp.asarray(rows), seed)))


def test_compact_valid_first():
    rows = _rows(3, 100, 2)
    valid = np.random.default_rng(3).random(100) < 0.4
    got, cnt = T.compact_valid_first(_t(rows), torch.from_numpy(valid))
    want, wcnt = JT.compact_valid_first(jnp.asarray(rows), jnp.asarray(valid))
    assert np.array_equal(_u(got), np.asarray(want))
    assert int(cnt) == int(wcnt) == valid.sum() and cnt.dtype == torch.int32


COMBINES = {
    "add": (lambda a, b: a + b, lambda a, b: a + b),
    "max": (torch.maximum, jnp.maximum),
    "first": (lambda a, b: a, lambda a, b: a),
}


@pytest.mark.parametrize("name", sorted(COMBINES))
@pytest.mark.parametrize("n,trail", [(1, ()), (37, ()), (64, (3,)),
                                     (130, (2, 2))])
def test_segmented_reduce_last(name, n, trail):
    rng = np.random.default_rng(n)
    vals = rng.integers(-1000, 1000, (n,) + trail).astype(np.int32)
    starts = rng.random(n) < 0.3
    starts[0] = rng.random() < 0.5         # a leading partial segment too
    tc, jc = COMBINES[name]
    got = T.segmented_reduce_last(torch.from_numpy(vals),
                                  torch.from_numpy(starts), tc)
    want = JT.segmented_reduce_last(jnp.asarray(vals), jnp.asarray(starts), jc)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_segmented_reduce_last_float32_add():
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((300, 4)).astype(np.float32)
    starts = rng.random(300) < 0.05
    got = T.segmented_reduce_last(torch.from_numpy(vals),
                                  torch.from_numpy(starts), lambda a, b: a + b)
    want = JT.segmented_reduce_last(jnp.asarray(vals), jnp.asarray(starts),
                                    lambda a, b: a + b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("n", [1, 5, 8, 33])
def test_tree_reduce(n):
    vals = np.random.default_rng(n).integers(0, 100, (n, 2)).astype(np.int32)
    got = T.tree_reduce(torch.from_numpy(vals), torch.maximum, -1)
    want = JT.tree_reduce(jnp.asarray(vals), jnp.maximum, -1)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = T.tree_reduce(torch.from_numpy(vals), lambda a, b: a + b, 0)
    assert np.array_equal(got.numpy(), vals.sum(0))


@pytest.mark.parametrize("count,nblock,cap", [(0, 10, 16), (10, 10, 16),
                                              (14, 10, 16), (16, 4, 16)])
def test_append_block_and_its_overflow(count, nblock, cap):
    rng = np.random.default_rng(count + nblock)
    buf = _rows(cap, cap, 2)
    block = _rows(nblock + 1, nblock, 2, p_sentinel=0)
    valid = rng.random(nblock) < 0.7
    got = T.append_block(_t(buf), torch.tensor(count, dtype=torch.int32),
                         _t(block), torch.from_numpy(valid))
    want = JT.append_block(jnp.asarray(buf), jnp.int32(count),
                           jnp.asarray(block), jnp.asarray(valid))
    assert np.array_equal(_u(got[0]), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])
    assert bool(got[2]) == (count + valid.sum() > cap)


def test_pad_pow2():
    assert [T.pad_pow2(n) for n in (0, 1, 2, 3, 17, 64)] == \
        [JT.pad_pow2(n) for n in (0, 1, 2, 3, 17, 64)]


def test_sort_stats_deltas():
    """One lexsort per ``lexsort_rows`` call and one scatter per
    ``append_block`` call, counted in the ``tierj`` namespace as the
    reference counts them when traced."""
    T.reset_sort_stats()
    JT.reset_sort_stats()
    rows = _rows(1, 10, 2)
    for _ in range(2):
        T.lexsort_rows(_t(rows))
        JT.lexsort_rows(jnp.asarray(rows))
    T.append_block(_t(rows), torch.tensor(0, dtype=torch.int32), _t(rows),
                   torch.ones(10, dtype=torch.bool))
    JT.append_block(jnp.asarray(rows), jnp.int32(0), jnp.asarray(rows),
                    jnp.ones(10, bool))
    T.compact_valid_first(_t(rows), torch.ones(10, dtype=torch.bool))
    assert dict(T.SORT_STATS) == dict(JT.SORT_STATS) == \
        {"lexsorts": 2, "scatters": 1}


def test_index_rules_match_jax():
    """The port's scatter rule (``index_drop``) and gather rule
    (``index_clip``) against JAX's ``.at[].set(mode="drop")`` and ``x[i]``."""
    idx = np.array([-9, -5, -4, -1, 0, 3, 4, 5, 9], np.int32)
    base = np.zeros(4, np.int32)
    vals = np.arange(1, 10, dtype=np.int32)
    # distinct landing rows only: -4 and 0 alias, so take one of each pair
    pick = np.array([0, 1, 3, 4, 6, 7, 8])
    want = np.asarray(jnp.asarray(base).at[idx[pick]].set(vals[pick],
                                                          mode="drop"))
    got = T.scatter_drop(torch.from_numpy(base), torch.from_numpy(idx[pick]),
                         torch.from_numpy(vals[pick]))
    assert np.array_equal(got.numpy(), want)
    src = np.arange(10, 14, dtype=np.int32)
    assert np.array_equal(
        torch.from_numpy(src)[T.index_clip(torch.from_numpy(idx), 4)].numpy(),
        np.asarray(jnp.asarray(src)[jnp.asarray(idx)]))
