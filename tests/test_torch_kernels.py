"""Port parity: the plain versions behind the bit-pack kernel wrappers of
``repro_torch`` vs ``repro.kernels.ops.*(impl="ref")`` (and K3 vs its
Pallas kernel in interpret mode), K1–K4.  K4's Pallas kernel is not run:
under jax 0.9.0 its interpret mode raises (``pl.load``), so its plain
version is held against ``impl="ref"`` and the disk tier's ``pack2``.

Tolerance: none — every result is bit-packed or an integer count, so all
comparisons are bit-exact.  Inputs come from ``np.random.default_rng`` and
go through both packages as numpy.  On the CPU the wrappers take the plain
version because the tensors lie there; the CUDA kernels are held against
the same plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitpack as jbp
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import bitpack as tbp
from repro_torch.kernels import ops as tops

ROTATE = tbp.make_lut([0, 3, 1, 3])       # the BFS rotate LUT
COLLIDE = tbp.make_lut([0, 0, 2, 1])      # lut[0] == count_val 0
LUTS = [(ROTATE, 1), (COLLIDE, 0), (tbp.make_lut([3, 2, 1, 0]), 3),
        (tbp.make_lut([1, 1, 1, 1]), 1)]
WIDTHS = [1, 3, 37, 129, 1000]            # none a multiple of 128 or 8
MARKS = [(2, 0), (1, 0), (3, 1), (0, 2), (2, 2)]


def _words(rng, w):
    return rng.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.uint32)


def _idx(rng, w, m):
    """Random targets plus every edge: duplicates, == cap, > cap, < 0."""
    cap = w * 16
    idx = rng.integers(-20, cap + 20, m)
    edges = [0, 0, cap - 1, cap - 1, cap, cap + 1, cap + 1000, -1, -cap]
    return np.concatenate([idx, edges, idx[: m // 4]]).astype(np.int32)


def _t(words):
    return convert.words_to_torch(words, device="cpu")


def _same_words(got, want):
    np.testing.assert_array_equal(convert.words_to_numpy(got),
                                  np.asarray(want, np.uint32))


def test_make_lut_matches_jax():
    for table in ([0, 3, 1, 3], [3, 2, 1, 0], [1, 1, 1, 1]):
        assert tbp.make_lut(table) == jbp.make_lut(table)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("lut,cval", LUTS)
def test_lut_count_matches_jax(w, lut, cval):
    rng = np.random.default_rng(w * 7 + lut)
    words = _words(rng, w)
    got, gcnt = tops.bitpack_lut_count(_t(words), lut, cval)
    want, wcnt = jops.bitpack_lut_count(jnp.asarray(words), lut, cval,
                                        impl="ref")
    _same_words(got, want)
    assert got.dtype == torch.int32 and gcnt.dtype == torch.int32
    assert int(gcnt) == int(wcnt)
    # the Pallas kernel itself, interpreted, agrees too (incl. pad collision)
    pal, pcnt = jops.bitpack_lut_count(jnp.asarray(words), lut, cval,
                                       impl="interpret")
    _same_words(got, pal)
    assert int(gcnt) == int(pcnt)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("mark,only_if", MARKS)
def test_scatter_mark_matches_jax(w, mark, only_if):
    rng = np.random.default_rng(w * 11 + mark * 4 + only_if)
    words, idx = _words(rng, w), _idx(rng, w, 4 * w + 5)
    got = tops.bitpack_scatter_mark(_t(words), torch.from_numpy(idx),
                                    mark=mark, only_if=only_if)
    want = jops.bitpack_scatter_mark(jnp.asarray(words), jnp.asarray(idx),
                                     mark=mark, only_if=only_if, impl="ref")
    _same_words(got, want)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("lut,cval", LUTS)
@pytest.mark.parametrize("mark,only_if", [(2, 0), (3, 1)])
def test_mark_rotate_count_matches_jax(w, lut, cval, mark, only_if):
    rng = np.random.default_rng(w * 13 + lut + mark)
    words, idx = _words(rng, w), _idx(rng, w, 4 * w + 5)
    want, wcnt = jops.bitpack_mark_rotate_count(
        jnp.asarray(words), jnp.asarray(idx), lut, cval, mark=mark,
        only_if=only_if, impl="ref")
    packed = _t(words)
    got, gcnt = tops.bitpack_mark_rotate_count(
        packed, torch.from_numpy(idx), lut, cval, mark=mark, only_if=only_if)
    _same_words(got, want)
    assert int(gcnt) == int(wcnt)
    _same_words(packed, words)                     # out of place by default
    got_in, icnt = tops.bitpack_mark_rotate_count(
        packed, torch.from_numpy(idx), lut, cval, mark=mark, only_if=only_if,
        inplace=True)
    assert got_in.data_ptr() == packed.data_ptr()
    _same_words(packed, want)
    assert int(icnt) == int(wcnt)


def test_empty_targets():
    words = _words(np.random.default_rng(0), 5)
    empty = torch.empty(0, dtype=torch.int32)
    _same_words(tops.bitpack_scatter_mark(_t(words), empty), words)
    got, cnt = tops.bitpack_mark_rotate_count(_t(words), empty, ROTATE, 1)
    want, wcnt = jops.bitpack_lut_count(jnp.asarray(words), ROTATE, 1,
                                        impl="ref")
    _same_words(got, want)
    assert int(cnt) == int(wcnt)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_impls_agree_on_cpu(impl):
    rng = np.random.default_rng(5)
    words, idx = _words(rng, 37), torch.from_numpy(_idx(rng, 37, 99))
    a, ca = tops.bitpack_mark_rotate_count(_t(words), idx, ROTATE, 1,
                                           impl=impl)
    b, cb = tbp.bitpack_mark_rotate_count(_t(words), idx, ROTATE, 1)
    assert torch.equal(a, b) and int(ca) == int(cb)


def test_cuda_impl_refuses_cpu_tensor_and_bad_impl():
    words = _t(_words(np.random.default_rng(1), 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.bitpack_lut_count(words, ROTATE, 1, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tops.bitpack_lut_count(words, ROTATE, 1, impl="pallas")


def test_wrappers_validate_arguments():
    words = _t(_words(np.random.default_rng(2), 4))
    with pytest.raises(TypeError):
        tbp.bitpack_lut_count(words.to(torch.int64), ROTATE, 1)
    with pytest.raises(TypeError):
        tbp.bitpack_scatter_mark(words, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tbp.bitpack_lut_count(torch.zeros(8, dtype=torch.int32)[::2],
                              ROTATE, 1)
    with pytest.raises(ValueError, match="outside 0..3"):
        tbp.bitpack_scatter_mark(words, torch.zeros(1, dtype=torch.int32),
                                 mark=4)
    with pytest.raises(ValueError, match="2\\^31"):
        tbp.bitpack_lut_count(torch.empty(1 << 27, dtype=torch.int32),
                              ROTATE, 1)


def test_launch_counters_stay_zero_on_cpu():
    tbp.reset_launches()
    rng = np.random.default_rng(3)
    words, idx = _words(rng, 9), torch.from_numpy(_idx(rng, 9, 30))
    tbp.bitpack_lut_count(_t(words), ROTATE, 1)
    tbp.bitpack_scatter_mark(_t(words), idx)
    tbp.bitpack_mark_rotate_count(_t(words), idx, ROTATE, 1, inplace=True)
    tbp.bitpack_gather2(_t(words), idx)
    assert tbp.LAUNCHES == {"mark_rotate_count": 0, "scatter_mark": 0,
                            "lut_count": 0, "gather2": 0}


# ------------------------------------------------------------------- K4

@pytest.mark.parametrize("w,m", [(1000, 4096), (64, 7), (4096, 20000)])
def test_gather2_matches_jax(w, m):
    """The JAX tests' shapes (tests/test_kernels.py:240-244), indices in
    [-50, 16W + 50) — negative and past the end — and a quarter of them
    again as duplicates."""
    rng = np.random.default_rng(w + m)
    words = _words(rng, w)
    idx = rng.integers(-50, w * 16 + 50, m).astype(np.int64)
    idx = np.concatenate([idx, idx[: m // 4 + 1]])
    want = jops.bitpack_gather2(jnp.asarray(words), idx, impl="ref")
    for impl in ("auto", "ref"):
        got = tops.bitpack_gather2(_t(words),
                                   torch.from_numpy(idx.astype(np.int32)),
                                   impl=impl)
        assert got.dtype == torch.int32 and got.shape == idx.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather2_empty_and_all_oob():
    words = np.arange(10, dtype=np.uint32) | 0xC0000000   # field 15 is 3
    for idx in (np.asarray([], np.int64), np.full(5, -3, np.int64),
                np.full(3, 10 * 16 + 7, np.int64), np.asarray([-(1 << 31)]),
                np.asarray([160, 159, -1, 0, 161, 160])):      # cap = 160
        got = tbp.bitpack_gather2(_t(words),
                                  torch.from_numpy(idx.astype(np.int32)))
        want = jops.bitpack_gather2(jnp.asarray(words), idx, impl="ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == idx.shape and got.dtype == torch.int32
    empty = tbp.bitpack_gather2(_t(words[:0]), torch.tensor([0, -1, 5],
                                                            dtype=torch.int32))
    np.testing.assert_array_equal(empty.numpy(), [0, 0, 0])


def test_gather2_matches_disk_packing():
    """The bridge of tests/test_kernels.py:268-284: bytes packed by the disk
    tier (4 fields a byte, field j at bits 2j), viewed little-endian as
    32-bit words, gather to the fields that were packed."""
    from repro.core.disk.bitarray import pack2
    rng = np.random.default_rng(5)
    for n in (1000, 1001, 1003, 4096):
        vals = rng.integers(0, 4, n).astype(np.uint8)
        raw = pack2(vals)
        pad = (-raw.size) % 4
        words = np.frombuffer(np.concatenate(
            [raw, np.zeros(pad, np.uint8)]).tobytes(), dtype="<u4")
        idx = np.concatenate([rng.integers(0, n, 500), [0, n - 1]])
        got = tops.bitpack_gather2(_t(words), torch.from_numpy(
            idx.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), vals[idx])


def test_gather2_field_15_needs_the_mask():
    """Field 15 holds the sign bit of an int32 word: the arithmetic shift
    of the plain version must be masked back to 0..3."""
    words = np.full(3, 0xC0000000, np.uint32)
    idx = torch.tensor([15, 31, 47, 14], dtype=torch.int32)
    np.testing.assert_array_equal(
        tbp.bitpack_gather2(_t(words), idx).numpy(), [3, 3, 3, 0])


def test_gather2_dispatch_and_checks():
    words = _t(_words(np.random.default_rng(6), 4))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.bitpack_gather2(words, idx, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tops.bitpack_gather2(words, idx, impl="pallas")
    with pytest.raises(TypeError):
        tbp.bitpack_gather2(words, idx.to(torch.int64))
    with pytest.raises(TypeError):
        tbp.bitpack_gather2(words.to(torch.int64), idx)
    with pytest.raises(TypeError):
        tbp.bitpack_gather2(words, idx.reshape(3, 1))
    with pytest.raises(ValueError, match="contiguous"):
        tbp.bitpack_gather2(words, torch.zeros(6, dtype=torch.int32)[::2])


# ------------------------------------------------- K4 over a chunk table

def _chunked(rng, total, ce):
    """``total`` random fields cut into chunks of ``ce``, each chunk packed
    into words of its own (16 fields a word from its first field); returns
    (the words of the fields joined, the chunks' word arrays)."""
    fields = rng.integers(0, 4, total).astype(np.uint32)

    def pack(f):
        f = np.concatenate([f, np.zeros((-f.size) % 16, np.uint32)])
        return (f.reshape(-1, 16) << (2 * np.arange(16, dtype=np.uint32))
                ).sum(axis=1, dtype=np.uint64).astype(np.uint32)

    return pack(fields), [pack(fields[c:c + ce]) for c in range(0, total, ce)]


def _chunk_ranks(rng, total, ce, m):
    """Random ranks in [-50, total + 50) and every chunk's boundaries."""
    n_chunks = -(-total // ce)
    edges = [e for c in range(n_chunks + 1)
             for e in (c * ce - 1, c * ce, c * ce + 1)]
    return np.concatenate([rng.integers(-50, total + 50, m), edges,
                           [total - 1, total, -(1 << 40), 1 << 40]])


@pytest.mark.parametrize("total,ce", [
    (1003, 100),        # a short last chunk; chunks that share words
    (1000, 96),         # chunks of whole words, a short last chunk
    (4096 * 3 + 5, 4096),
    (50, 7),            # chunk_elems no multiple of 4
])
def test_gather2_chunked_matches_jax_over_the_joined_words(total, ce):
    """The chunked plain version == JAX ``bitpack_gather2(impl="ref")`` over
    the chunks' fields joined, for ranks in and out of range and at every
    chunk boundary; uint8 codes in query order."""
    rng = np.random.default_rng(total + ce)
    joined, chunks = _chunked(rng, total, ce)
    ranks = _chunk_ranks(rng, total, ce, 3000)
    inside = (ranks >= 0) & (ranks < 16 * joined.size)
    want = np.asarray(jops.bitpack_gather2(
        jnp.asarray(joined), np.where(inside, ranks, -1), impl="ref"))
    table = [_t(w) for w in chunks]
    for impl in ("auto", "ref"):
        out = torch.full((ranks.size,), 0xAB, dtype=torch.uint8)
        got = tops.bitpack_gather2_chunked(table, ce, torch.from_numpy(ranks),
                                           out, impl=impl)
        assert got is out and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather2_chunked_null_entries_leave_their_bytes():
    """A None entry's ranks keep the bytes ``out`` held; the others get
    their codes, ranks outside the table 0."""
    rng = np.random.default_rng(11)
    total, ce = 1003, 100
    joined, chunks = _chunked(rng, total, ce)
    ranks = _chunk_ranks(rng, total, ce, 2000)
    inside = (ranks >= 0) & (ranks < 16 * joined.size)
    want = np.asarray(jops.bitpack_gather2(
        jnp.asarray(joined), np.where(inside, ranks, -1), impl="ref"))
    null = {0, 3, 4, 10}
    table = [None if c in null else _t(w) for c, w in enumerate(chunks)]
    before = rng.integers(0, 256, ranks.size).astype(np.uint8)
    got = tbp.bitpack_gather2_chunked(table, ce, torch.from_numpy(ranks),
                                      torch.from_numpy(before.copy()))
    chunk = np.floor_divide(ranks, ce)
    kept = (ranks >= 0) & np.isin(chunk, sorted(null))
    np.testing.assert_array_equal(got.numpy(), np.where(kept, before, want))


def test_gather2_chunked_empty_batch_and_checks():
    tbp.reset_launches()
    words = _t(_words(np.random.default_rng(12), 4))
    out = torch.empty(0, dtype=torch.uint8)
    got = tbp.bitpack_gather2_chunked([words, None], 64,
                                      torch.empty(0, dtype=torch.int64), out)
    assert got is out and got.numel() == 0
    assert tbp.LAUNCHES["gather2"] == 0
    ranks, out = torch.zeros(3, dtype=torch.int64), torch.zeros(
        3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.bitpack_gather2_chunked([words], 64, ranks, out, impl="cuda")
    with pytest.raises(TypeError):
        tbp.bitpack_gather2_chunked([words], 64, ranks.int(), out)
    with pytest.raises(TypeError):
        tbp.bitpack_gather2_chunked([words], 64, ranks, out.int())
    with pytest.raises(TypeError):
        tbp.bitpack_gather2_chunked([words.long()], 64, ranks, out)
    with pytest.raises(ValueError, match="contiguous"):
        tbp.bitpack_gather2_chunked(
            [words], 64, torch.zeros(6, dtype=torch.int64)[::2], out)
    with pytest.raises(ValueError, match="chunk_elems"):
        tbp.bitpack_gather2_chunked([words], 0, ranks, out)
    with pytest.raises(ValueError, match="table"):
        tbp.bitpack_gather2_chunked([], 64, ranks, out)
