"""Port parity: the plain versions behind the bit-pack kernel wrappers of
``repro_torch`` vs ``repro.kernels.ops.*(impl="ref")`` (and K3 vs its
Pallas kernel in interpret mode).

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
    assert tbp.LAUNCHES == {"mark_rotate_count": 0, "scatter_mark": 0,
                            "lut_count": 0}
