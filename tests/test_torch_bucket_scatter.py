"""Port parity: the plain version behind K5 (the segment scatter-add,
``repro_torch.kernels.bucket_scatter``) vs the reference's oracle
``repro.kernels.ref.bucket_scatter_add_ref``, and the dispatcher.

The Pallas kernel is not run: under jax 0.9.0 its interpret mode raises
(``pl.load``).  Tolerance: atol = rtol = 1e-4, as
``tests/test_kernels.py:150-151`` holds the kernel, for float32 tables
(both sides sum in float32, possibly in another order); bit for bit where
each index receives at most one op (a single add).  bfloat16 tables: the
result is rounded to bfloat16 once, so the two agree to one bfloat16 ulp
(rtol 2⁻⁷).  The CUDA kernel is held against the same plain version on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import bucket_scatter as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (N, M, D) of the JAX tests, tests/test_kernels.py:129-134
SHAPES = [(16, 100, 8), (64, 37, 4), (8, 256, 16), (32, 5, 8)]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n, m, d, lo, hi, sort=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(lo, hi, m).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    payload = rng.standard_normal((m, d)).astype(np.float32)
    return table, idx, payload


def _jax(table, idx, payload):
    return np.asarray(jref.bucket_scatter_add_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(payload)))


def _port(table, idx, payload, **kw):
    return tops.bucket_scatter_add(torch.from_numpy(table),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(payload), **kw).numpy()


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plain_matches_oracle_at_jax_test_shapes(n, m, d, sort):
    # the JAX tests draw idx in [0, N + 3); here also negatives to -N - 3
    for lo in (0, -n - 3):
        args = _inputs(n * m + d, n, m, d, lo, n + 3, sort)
        np.testing.assert_allclose(_port(*args), _jax(*args), **TOL)


def test_out_of_range_dropped():
    """The JAX ``test_out_of_range_dropped`` case (tests/test_kernels.py:
    153-160): N = 4, every index at or past N drops, index 0 adds."""
    table = np.zeros((4, 2), np.float32)
    idx = np.array([4, 5, 100, 0], np.int32)
    payload = np.ones((4, 2), np.float32)
    got = _port(table, idx, payload)
    np.testing.assert_array_equal(got, _jax(table, idx, payload))
    np.testing.assert_array_equal(got, [[1, 1], [0, 0], [0, 0], [0, 0]])


def test_negative_indices_wrap_once_then_drop():
    """[-N, 0) wraps to idx + N; below -N and at or past N drop — the
    oracle's contract, which K5 takes."""
    table = np.zeros((4, 1), np.float32)
    idx = np.array([-1, 5, 4, 0, -5, 2, 2, -4, -100], np.int32)
    payload = np.array([[1000], [1], [1], [1], [9], [3], [4], [20], [7]],
                       np.float32)
    got = _port(table, idx, payload)
    np.testing.assert_array_equal(got, _jax(table, idx, payload))
    np.testing.assert_array_equal(got[:, 0], [21, 0, 7, 1000])


def test_one_op_per_index_is_bit_exact():
    rng = np.random.default_rng(5)
    n, d = 300, 7
    idx = rng.permutation(np.arange(-n, n))[:200].astype(np.int32)
    _, first = np.unique(idx % n, return_index=True)
    idx = idx[np.sort(first)]        # one op a row, some of them negative
    table = rng.standard_normal((n, d)).astype(np.float32)
    payload = rng.standard_normal((idx.shape[0], d)).astype(np.float32)
    got = _port(table, idx, payload)
    np.testing.assert_array_equal(got, _jax(table, idx, payload))
    want = table.copy()
    want[idx % n] += payload
    np.testing.assert_array_equal(got, want)


def test_empty_and_all_dropped():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    for idx in (np.zeros(0, np.int32), np.array([4, -5, 99, -99], np.int32)):
        payload = np.ones((idx.shape[0], 3), np.float32)
        np.testing.assert_array_equal(_port(table, idx, payload), table)
        np.testing.assert_array_equal(_jax(table, idx, payload), table)


def test_result_is_out_of_place():
    table = torch.zeros(3, 2)
    out = tops.bucket_scatter_add(table, torch.tensor([1], dtype=torch.int32),
                                  torch.ones(1, 2))
    assert float(table.abs().sum()) == 0 and float(out[1, 0]) == 1


def test_strided_table_and_payload():
    rng = np.random.default_rng(9)
    wide = rng.standard_normal((20, 11)).astype(np.float32)
    idx = rng.integers(-23, 23, 40).astype(np.int32)
    pay = rng.standard_normal((40, 9)).astype(np.float32)
    got = tops.bucket_scatter_add(torch.from_numpy(wide)[:, 2:7],
                                  torch.from_numpy(idx),
                                  torch.from_numpy(pay)[:, 1:6]).numpy()
    np.testing.assert_allclose(
        got, _jax(np.ascontiguousarray(wide[:, 2:7]), idx,
                  np.ascontiguousarray(pay[:, 1:6])), **TOL)


def test_bfloat16_table_through_the_plain_version():
    """f32 accumulation, one cast back to bfloat16, as the oracle does;
    the kernel itself takes float32 only."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    idx = rng.integers(-19, 19, 100).astype(np.int32)
    payload = rng.standard_normal((100, 8)).astype(np.float32)
    got = tops.bucket_scatter_add(
        torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(idx),
        torch.from_numpy(payload))
    assert got.dtype == torch.bfloat16
    want = jref.bucket_scatter_add_ref(jnp.asarray(table, jnp.bfloat16),
                                       jnp.asarray(idx), jnp.asarray(payload))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)


def test_dispatcher():
    table, idx, payload = (torch.zeros(4, 2), torch.tensor([1, 1], dtype=
                           torch.int32), torch.ones(2, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.bucket_scatter_add(table, idx, payload, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tops.bucket_scatter_add(table, idx, payload, impl="pallas")
    before = dict(tbs.LAUNCHES)
    for impl in ("auto", "ref"):
        out = tops.bucket_scatter_add(table, idx, payload, impl=impl)
        np.testing.assert_array_equal(out.numpy(),
                                      [[0, 0], [2, 2], [0, 0], [0, 0]])
    assert tbs.LAUNCHES == before           # the plain version books nothing
    np.testing.assert_array_equal(
        tbs.bucket_scatter_add(table, idx, payload).numpy(),
        tref.bucket_scatter_add_ref(table, idx, payload).numpy())


def test_wrapper_checks_its_arguments():
    table = torch.zeros(4, 2)
    with pytest.raises(TypeError, match="int32"):
        tbs.bucket_scatter_add(table, torch.tensor([1]), torch.ones(1, 2))
    with pytest.raises(ValueError, match="payload"):
        tbs.bucket_scatter_add(table, torch.tensor([1], dtype=torch.int32),
                               torch.ones(1, 3))
    with pytest.raises(ValueError, match="table must be"):
        tbs.bucket_scatter_add(torch.zeros(4), torch.tensor(
            [1], dtype=torch.int32), torch.ones(1, 1))
