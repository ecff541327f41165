"""Port parity: ``repro_torch.core.paged`` against ``repro.core.paged``.

The paged KV store only moves data, so every comparison is exact, in
float32 and in bfloat16: ``make``, ``append`` across page boundaries,
``bulk_fill`` with partial final pages, and ``gather`` through the
identity table and through a shuffled one.  Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged as jpaged
from repro_torch.core import paged as tpaged

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(t: torch.Tensor, j) -> None:
    want = np.asarray(j)
    if want.dtype.name == "bfloat16":
        assert t.dtype == torch.bfloat16
        t, want = t.float(), want.astype(np.float32)
    np.testing.assert_array_equal(t.numpy(), want)


def _same_cache(t: tpaged.PagedKV, j) -> None:
    for f in tpaged.PagedKV._fields:
        _same(getattr(t, f), getattr(j, f))


def _kv(rng, *shape):
    return rng.standard_normal(shape, np.float32)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("batch,max_len,ps", [(1, 8, 4), (3, 10, 4),
                                              (2, 256, 128)])
def test_make(jdt, tdt, batch, max_len, ps):
    t = tpaged.make(batch, max_len, 2, 6, page_size=ps, dtype=tdt,
                    device="cpu")
    j = jpaged.make(batch, max_len, 2, 6, page_size=ps, dtype=jdt)
    _same_cache(t, j)
    assert t.page_size == j.page_size and t.pages_per_seq == j.pages_per_seq
    assert t.page_table.dtype == t.lengths.dtype == torch.int32


def test_make_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpaged.make(1, 8, 2, 6)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_append_across_pages(jdt, tdt):
    rng = np.random.default_rng(0)
    b, kvh, hd, ps = 3, 2, 5, 4
    t = tpaged.make(b, 16, kvh, hd, page_size=ps, dtype=tdt, device="cpu")
    j = jpaged.make(b, 16, kvh, hd, page_size=ps, dtype=jdt)
    for _ in range(9):                       # crosses two page boundaries
        k, v = _kv(rng, b, kvh, hd), _kv(rng, b, kvh, hd)
        before = t.k_pages.clone()
        t_new = tpaged.append(t, torch.from_numpy(k), torch.from_numpy(v))
        assert torch.equal(t.k_pages, before)          # out of place
        t, j = t_new, jpaged.append(j, jnp.asarray(k), jnp.asarray(v))
        _same_cache(t, j)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("s", [1, 4, 10])
def test_bulk_fill_then_append_and_gather(jdt, tdt, s):
    rng = np.random.default_rng(s)
    b, kvh, hd, ps = 2, 2, 3, 4
    k, v = _kv(rng, b, s, kvh, hd), _kv(rng, b, s, kvh, hd)
    lengths = np.full((b,), s, np.int32)
    t = tpaged.make(b, 16, kvh, hd, page_size=ps, dtype=tdt, device="cpu")
    j = jpaged.make(b, 16, kvh, hd, page_size=ps, dtype=jdt)
    t = tpaged.bulk_fill(t, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(lengths))
    j = jpaged.bulk_fill(j, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lengths))
    _same_cache(t, j)
    k1, v1 = _kv(rng, b, kvh, hd), _kv(rng, b, kvh, hd)
    t = tpaged.append(t, torch.from_numpy(k1), torch.from_numpy(v1))
    j = jpaged.append(j, jnp.asarray(k1), jnp.asarray(v1))
    for got, want in zip(tpaged.gather(t), jpaged.gather(j)):
        _same(got, want)


def test_gather_through_a_shuffled_table():
    rng = np.random.default_rng(3)
    b, pps, ps, kvh, hd = 3, 4, 4, 2, 3
    pages = _kv(rng, b * pps, ps, kvh, hd)
    table = rng.permutation(b * pps).reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 7, 15], np.int32)
    t = tpaged.PagedKV(*(torch.from_numpy(x) for x in
                         (pages, pages * 2, table, lengths)))
    j = jpaged.PagedKV(*(jnp.asarray(x) for x in
                         (pages, pages * 2, table, lengths)))
    for got, want in zip(tpaged.gather(t), jpaged.gather(j)):
        _same(got, want)
    k1 = _kv(rng, b, kvh, hd)
    _same_cache(tpaged.append(t, torch.from_numpy(k1), torch.from_numpy(k1)),
                jpaged.append(j, jnp.asarray(k1), jnp.asarray(k1)))
