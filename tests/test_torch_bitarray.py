"""Port parity: ``repro_torch.core.bitarray`` vs ``repro.core.bitarray``
with ``impl="ref"``, mirroring tests/test_bitarray.py::TestRoomyBitArray.

Tolerance: none — packed words and counts are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitarray as JB
from repro_torch import convert
from repro_torch.core import bitarray as TB


def _t(words):
    return convert.words_to_torch(words, device="cpu")


def _np(t):
    return convert.words_to_numpy(t)


def _bfs_words(rng, n):
    """Packed words of n BFS marks with zero tail padding."""
    vals = rng.integers(0, 4, n).astype(np.uint32)
    return np.asarray(JB.pack_values(jnp.asarray(vals)))


def test_constants_match():
    assert (TB.UNSEEN, TB.CUR, TB.NEXT, TB.DONE) == \
        (JB.UNSEEN, JB.CUR, JB.NEXT, JB.DONE)
    assert TB.ROTATE_LUT == JB.ROTATE_LUT
    assert TB.FIELDS_PER_WORD == JB.FIELDS_PER_WORD
    for n in (0, 1, 15, 16, 17, 250):
        assert TB.n_words(n) == JB.n_words(n)


@pytest.mark.parametrize("k", [1, 16, 250])
def test_pack_unpack_match(k):
    vals = np.random.default_rng(k).integers(0, 4, k).astype(np.uint32)
    packed = TB.pack_values(torch.from_numpy(vals.astype(np.int32)))
    np.testing.assert_array_equal(_np(packed),
                                  np.asarray(JB.pack_values(jnp.asarray(vals))))
    np.testing.assert_array_equal(TB.unpack_values(packed).numpy()[:k], vals)
    np.testing.assert_array_equal(
        TB.unpack_values(packed).numpy(),
        np.asarray(JB.unpack_values(jnp.asarray(_np(packed)))))


def test_get_matches():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, 20, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 320, 100)
    ba = TB.RoomyBitArray(_t(words))
    jba = JB.make(320)._replace(data=jnp.asarray(words))
    np.testing.assert_array_equal(
        TB.get(ba, torch.from_numpy(idx)).numpy(),
        np.asarray(JB.get(jba, jnp.asarray(idx))))


def test_make_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.make(100)
    ba = TB.make(100, device="cpu")
    assert ba.data.shape == (TB.n_words(100),) and ba.capacity == 112
    assert not ba.data.any()


def test_mark_packed_duplicates_and_oob():
    data = torch.zeros(4, dtype=torch.int32)            # 64 elements
    idx = torch.tensor([5, 5, 5, 63, 64, 9999, -1], dtype=torch.int32)
    out = TB.mark_packed(data, idx)
    want = JB.mark_packed(jnp.zeros((4,), jnp.uint32), jnp.asarray(idx.numpy()),
                          impl="ref")
    np.testing.assert_array_equal(_np(out), np.asarray(want))
    vals = TB.unpack_values(out).numpy()
    assert vals[5] == TB.NEXT and vals[63] == TB.NEXT and vals.sum() == 4
    # non-UNSEEN targets absorb the mark
    again = TB.mark_packed(out, torch.tensor([5], dtype=torch.int32))
    assert torch.equal(again, out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mark_packed_with_valid_mask(seed):
    rng = np.random.default_rng(seed)
    words = _bfs_words(rng, 200)
    idx = rng.integers(-5, 230, 300)
    valid = rng.random(300) < 0.6
    for mark, only_if in ((TB.NEXT, TB.UNSEEN), (TB.CUR, TB.DONE)):
        got = TB.mark_packed(_t(words), torch.from_numpy(idx),
                             torch.from_numpy(valid), mark=mark,
                             only_if=only_if)
        want = JB.mark_packed(jnp.asarray(words), jnp.asarray(idx),
                              jnp.asarray(valid), mark=mark, only_if=only_if,
                              impl="ref")
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_rotate_count_small():
    vals = torch.tensor([TB.UNSEEN, TB.CUR, TB.NEXT, TB.DONE, TB.NEXT])
    new, cnt = TB.rotate_count(TB.pack_values(vals), 5)
    assert TB.unpack_values(new)[:5].tolist() == \
        [TB.UNSEEN, TB.DONE, TB.CUR, TB.DONE, TB.CUR]
    assert int(cnt) == 2


@pytest.mark.parametrize("n", [5, 16, 100, 257])
@pytest.mark.parametrize("lut,cval", [(TB.ROTATE_LUT, TB.CUR),
                                      (TB.ROTATE_LUT, TB.UNSEEN),
                                      (TB.ROTATE_LUT, TB.DONE)])
def test_rotate_count_tail_padding(n, lut, cval):
    words = _bfs_words(np.random.default_rng(n), n)
    new, cnt = TB.rotate_count(_t(words), n, lut=lut, count_val=cval)
    jnew, jcnt = JB.rotate_count(jnp.asarray(words), n, lut=lut,
                                 count_val=cval, impl="ref")
    np.testing.assert_array_equal(_np(new), np.asarray(jnew))
    assert int(cnt) == int(jcnt)


@pytest.mark.parametrize("n", [5, 16, 100, 257])
@pytest.mark.parametrize("cval", [TB.CUR, TB.UNSEEN])
@pytest.mark.parametrize("inplace", [False, True])
def test_mark_rotate_count_tail_padding(n, cval, inplace):
    rng = np.random.default_rng(10 + n)
    words = _bfs_words(rng, n)
    idx = np.concatenate([rng.integers(0, n, 3 * n), [0, 0, n - 1]])
    data = _t(words)
    new, cnt = TB.mark_rotate_count(data, torch.from_numpy(idx), n,
                                    count_val=cval, inplace=inplace)
    jnew, jcnt = JB.mark_rotate_count(jnp.asarray(words), jnp.asarray(idx), n,
                                      count_val=cval, impl="ref")
    np.testing.assert_array_equal(_np(new), np.asarray(jnew))
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(_np(data),
                                  np.asarray(jnew) if inplace else words)


def test_padded_arrays_need_zero_preserving_lut():
    data = torch.zeros(2, dtype=torch.int32)
    bad = TB.ROTATE_LUT | 1                          # lut[0] == 1
    with pytest.raises(AssertionError, match="zero-preserving"):
        TB.rotate_count(data, 20, lut=bad)
    with pytest.raises(AssertionError, match="zero-preserving"):
        TB.mark_rotate_count(data, torch.zeros(1, dtype=torch.int32), 20,
                             lut=bad)
    TB.rotate_count(data, 32, lut=bad)               # no padding: allowed


@pytest.mark.parametrize("value", range(4))
def test_count_value_matches(value):
    words = _bfs_words(np.random.default_rng(value), 150)
    ba = TB.RoomyBitArray(_t(words))
    jba = JB.make(150)._replace(data=jnp.asarray(words))
    for n in (None, 150, 77):
        assert TB.count_value(ba, value, n) == \
            int(JB.count_value(jba, value, n))
