"""Port parity: ``repro_torch.core.ranking`` vs ``repro.core.ranking``
(``unrank_np``/``rank_np`` and ``unrank_jnp``/``rank_jnp``), mirroring
tests/test_bitarray.py::TestRanking.

Tolerance: none — ranks and permutations are integers, compared exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ranking as JR
from repro_torch import convert
from repro_torch.core import ranking as TR


def _sample(n, size, seed):
    rng = np.random.default_rng(seed)
    f = math.factorial(n)
    if f < 1 << 63:
        return rng.integers(0, f, size=size, dtype=np.int64)
    return rng.integers(0, f, size=size, dtype=np.uint64).astype(np.int64)


def test_constants_match():
    assert (TR.MAX_N, TR.MAX_N_1WORD) == (JR.MAX_N, JR.MAX_N_1WORD)
    for n in range(1, TR.MAX_N + 1):
        assert TR.rank_width(n) == JR.rank_width(n)
        assert TR.n_states(n) == JR.n_states(n)


@pytest.mark.parametrize("n", range(1, 8))
def test_all_ranks_match_numpy(n):
    ranks = np.arange(math.factorial(n), dtype=np.int64)
    perms = TR.unrank(n, torch.from_numpy(ranks))
    want = JR.unrank_np(n, ranks.astype(np.uint64))
    np.testing.assert_array_equal(perms.numpy(), want)
    np.testing.assert_array_equal(TR.rank(perms).numpy(), ranks)
    np.testing.assert_array_equal(
        TR.rank(torch.from_numpy(want)).numpy().astype(np.uint64),
        JR.rank_np(want))


@pytest.mark.parametrize("n", [6, 7])
def test_all_ranks_match_jnp(n):
    ranks = np.arange(math.factorial(n), dtype=np.int64)
    rows = JR.ranks_to_rows(ranks.astype(np.uint64), n)
    jperms = np.asarray(JR.unrank_jnp(n, jnp.asarray(rows)))
    tperms = TR.unrank(n, convert.ranks_from_rows(rows, device="cpu"))
    np.testing.assert_array_equal(tperms.numpy(), jperms)
    jrows = np.asarray(JR.rank_jnp(jnp.asarray(jperms)))
    np.testing.assert_array_equal(TR.rank(tperms).numpy(),
                                  JR.rows_to_ranks(jrows).astype(np.int64))


@pytest.mark.parametrize("n", [12, 13, 20])
def test_sampled_ranks_match_numpy_and_jnp(n):
    ranks = _sample(n, 300, n)
    tperms = TR.unrank(n, torch.from_numpy(ranks))
    want = JR.unrank_np(n, ranks.astype(np.uint64))
    np.testing.assert_array_equal(tperms.numpy(), want)
    np.testing.assert_array_equal(TR.rank(tperms).numpy(), ranks)
    rows = JR.ranks_to_rows(ranks.astype(np.uint64), n)
    jperms = np.asarray(JR.unrank_jnp(n, jnp.asarray(rows)))
    np.testing.assert_array_equal(tperms.numpy(), jperms)
    jrows = np.asarray(JR.rank_jnp(jnp.asarray(want)))
    np.testing.assert_array_equal(
        convert.ranks_from_rows(jrows, device="cpu").numpy(), ranks)


@pytest.mark.parametrize("n", [5, 12, 13, 14, 20])
def test_row_codec_matches(n):
    ranks = _sample(n, 200, 100 + n)
    rows = TR.ranks_to_rows(torch.from_numpy(ranks), n)
    want = JR.ranks_to_rows(ranks.astype(np.uint64), n)
    assert rows.shape == want.shape and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(TR.rows_to_ranks(rows).numpy(), ranks)
    np.testing.assert_array_equal(
        convert.ranks_to_numpy(TR.rows_to_ranks(rows)),
        JR.rows_to_ranks(want))


def test_rank_rows_sort_in_rank_order():
    ranks = _sample(14, 500, 1)
    rows = TR.ranks_to_rows(torch.from_numpy(ranks), 14).numpy() \
        .view(np.uint32)
    order = np.lexsort((rows[:, 1], rows[:, 0]))
    back = TR.rows_to_ranks(torch.from_numpy(rows[order].view(np.int32)))
    np.testing.assert_array_equal(back.numpy(), np.sort(ranks))
