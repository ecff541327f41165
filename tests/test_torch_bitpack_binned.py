"""K1's and K2's binned route in plain PyTorch: the mirror of its order
(``repro_torch.kernels.ref.bitpack_mark_binned``), its launch plan
(``bitpack.bin_plan``), the route function and its launch counters.

The binned route sorts the marks by tile of words (a histogram per block
of targets, an exclusive scan of the (tile, block) counts, each target's
offset in its tile written at its run's cursor) and applies each tile's
marks from a hit bitmap.  The mirror does the same steps in PyTorch; it is
held bit for bit to the plain version of the port and to the JAX
package's ``impl="ref"`` (under ``JAX_PLATFORMS=cpu``; not interpret mode,
whose scatter kernels raise under jax 0.9.0), at small tile sizes so that
every edge of the binning is reached: targets on the first and last field
of every tile, a partial tail tile, duplicates, negative and ≥ 16·W
targets, M = 0 and M = 1, ``only_if != 0``, ``mark == only_if`` and
``lut[0] == count_val``.  Tolerance: none, every result is packed words or
an integer count.  The CUDA kernels are held to the plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import obs
from repro_torch.kernels import bitpack as tbp
from repro_torch.kernels import ref as tref

ROTATE = tbp.make_lut([0, 3, 1, 3])       # the BFS rotate LUT
COLLIDE = tbp.make_lut([0, 0, 2, 1])      # lut[0] == count_val 0
LUTS = [(ROTATE, 1), (COLLIDE, 0), (tbp.make_lut([3, 2, 1, 0]), 3)]
MARKS = [(2, 0), (1, 0), (3, 1), (0, 2), (2, 2)]
WIDTHS = [1, 3, 37, 129]
TILES = [1, 3, 8]                          # words a tile, for the mirror
# Pancake n = 12: its words and its level sizes (15 levels, diameter 14).
W12 = 479001600 // 16
SIZES12 = [1, 11, 110, 1099, 9883, 77937, 533397, 3064788, 14141929,
           49337252, 118420043, 169332213, 111050066, 13032704, 167]


def _words(rng, w):
    return rng.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.uint32)


def _tile_edges(w, tile_words):
    cap, tf = 16 * w, 16 * tile_words
    return [f for t in range(-(-w // tile_words))
            for f in (t * tf, min(cap, (t + 1) * tf) - 1)]


def _idx(rng, w, m, tile_words):
    """Random targets, every tile's first and last field, duplicates,
    == cap, > cap and negatives, shuffled."""
    cap = 16 * w
    idx = rng.integers(-20, cap + 20, m)
    edges = [0, 0, cap - 1, cap - 1, cap, cap + 1, cap + 1000, -1, -cap]
    idx = np.concatenate([idx, edges, _tile_edges(w, tile_words),
                          idx[:m // 4]])
    return rng.permutation(idx).astype(np.int32)


def _t(words):
    return convert.words_to_torch(words, device="cpu")


def _same_words(got, want):
    np.testing.assert_array_equal(convert.words_to_numpy(got),
                                  np.asarray(want, np.uint32))


def _plan(m, blocks):
    """The per-block slice the plan would give ``blocks`` blocks."""
    return -(-(-(-m // blocks)) // 4) * 4


def _check_bins(w, idx, tile_words, tile_start, bins):
    """The bins hold exactly the in-range targets, each as its offset in
    its tile, tile by tile."""
    e = idx.to(torch.int64)
    e = e[(e >= 0) & (e < 16 * w)]
    tf = 16 * tile_words
    assert tile_start[0] == 0 and int(tile_start[-1]) == e.numel()
    assert bool((tile_start.diff() >= 0).all())
    assert bool(((bins >= 0) & (bins < tf)).all())
    tile_of = torch.repeat_interleave(torch.arange(tile_start.numel() - 1),
                                      tile_start.diff())
    back = tile_of * tf + bins.to(torch.int64)
    assert torch.equal(back.sort().values, e.sort().values)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("tile_words", TILES)
@pytest.mark.parametrize("mark,only_if", MARKS)
def test_binned_mirror_matches_plain_and_jax(w, tile_words, mark, only_if):
    rng = np.random.default_rng(w * 31 + tile_words * 7 + mark * 4 + only_if)
    words = _words(rng, w)
    idx = torch.from_numpy(_idx(rng, w, 4 * w + 5, tile_words))
    want = jops.bitpack_scatter_mark(jnp.asarray(words),
                                     jnp.asarray(idx.numpy()), mark=mark,
                                     only_if=only_if, impl="ref")
    _same_words(tref.bitpack_scatter_mark_ref(_t(words), idx, mark, only_if),
                want)
    for blocks in (1, 3):
        got, tile_start, bins = tref.bitpack_mark_binned(
            _t(words), idx, mark, only_if, tile_words=tile_words,
            blocks=blocks, per_block=_plan(idx.shape[0], blocks))
        _same_words(got, want)
        _check_bins(w, idx, tile_words, tile_start, bins)


@pytest.mark.parametrize("w", [5, 37])
@pytest.mark.parametrize("lut,cval", LUTS)
@pytest.mark.parametrize("mark,only_if", [(2, 0), (3, 1), (2, 2)])
def test_binned_mirror_then_lut_count_matches_k1(w, lut, cval, mark,
                                                 only_if):
    """K1 is the binned marks then the rotate and count of every field."""
    rng = np.random.default_rng(w + lut + mark)
    words = _words(rng, w)
    idx = torch.from_numpy(_idx(rng, w, 3 * w, 2))
    marked, _, _ = tref.bitpack_mark_binned(_t(words), idx, mark, only_if,
                                            tile_words=2, blocks=2,
                                            per_block=_plan(idx.shape[0], 2))
    got, cnt = tref.bitpack_lut_count_ref(marked, lut, cval)
    want, wcnt = jops.bitpack_mark_rotate_count(
        jnp.asarray(words), jnp.asarray(idx.numpy()), lut, cval, mark=mark,
        only_if=only_if, impl="ref")
    _same_words(got, want)
    assert int(cnt) == int(wcnt)


@pytest.mark.parametrize("m", [0, 1])
@pytest.mark.parametrize("tile_words", [1, 4])
def test_binned_mirror_no_or_one_target(m, tile_words):
    rng = np.random.default_rng(m)
    words = _words(rng, 9)
    idx = torch.tensor([16 * 9 - 1][:m], dtype=torch.int32)
    got, tile_start, bins = tref.bitpack_mark_binned(
        _t(words), idx, 2, 0, tile_words=tile_words)
    _same_words(got, tref.bitpack_scatter_mark_ref(_t(words), idx, 2, 0))
    assert bins.numel() == m and int(tile_start[-1]) == m


def test_binned_mirror_drops_every_out_of_range_target():
    words = _words(np.random.default_rng(4), 6)
    idx = torch.tensor([-1, -96, 96, 97, 1 << 30], dtype=torch.int32)
    got, tile_start, bins = tref.bitpack_mark_binned(_t(words), idx, 2, 0,
                                                     tile_words=2)
    _same_words(got, words)
    assert bins.numel() == 0 and torch.equal(tile_start,
                                             torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("w", [tbp.TILE_WORDS - 1, tbp.TILE_WORDS,
                               tbp.TILE_WORDS + 1, 2 * tbp.TILE_WORDS + 1])
def test_binned_mirror_at_the_kernels_tile(w):
    """The kernels' tile of 4096 words: every offset fits a uint16, the
    tail tile is partial, and marks on each tile's first and last field
    land."""
    rng = np.random.default_rng(w)
    words = _words(rng, w)
    idx = torch.from_numpy(_idx(rng, w, 3000, tbp.TILE_WORDS))
    plan = tbp.bin_plan(w, idx.shape[0], 2)
    got, tile_start, bins = tref.bitpack_mark_binned(
        _t(words), idx, 2, 0, blocks=plan.blocks, per_block=plan.per_block)
    want = jops.bitpack_scatter_mark(jnp.asarray(words),
                                     jnp.asarray(idx.numpy()), mark=2,
                                     only_if=0, impl="ref")
    _same_words(got, want)
    assert tile_start.numel() == plan.n_tiles + 1
    assert int(bins.max()) < 1 << 16
    _check_bins(w, idx, tbp.TILE_WORDS, tile_start, bins)


@pytest.mark.parametrize("sms", [1, 3, 132])
def test_binned_mirror_over_the_plans_blocks(sms):
    """The plan's blocks and slices, as the kernels take them."""
    rng = np.random.default_rng(sms)
    w = 3 * tbp.TILE_WORDS + 5
    words = _words(rng, w)
    idx = torch.from_numpy(_idx(rng, w, 70000, tbp.TILE_WORDS))
    plan = tbp.bin_plan(w, idx.shape[0], sms)
    got, tile_start, bins = tref.bitpack_mark_binned(
        _t(words), idx, 3, 1, blocks=plan.blocks, per_block=plan.per_block)
    _same_words(got, tref.bitpack_scatter_mark_ref(_t(words), idx, 3, 1))
    _check_bins(w, idx, tbp.TILE_WORDS, tile_start, bins)


@pytest.mark.parametrize("w,m,sms", [(1, 0, 132), (4095, 1, 132),
                                     (29937600, 5867367, 132),
                                     (29937600, 1862654343, 132),
                                     (8193, 70000, 3), (100, 10 ** 6, 1)])
def test_bin_plan(w, m, sms):
    plan = tbp.bin_plan(w, m, sms)
    assert plan.n_tiles == -(-w // tbp.TILE_WORDS)
    assert 1 <= plan.blocks <= sms
    assert plan.blocks == 1 or m > (plan.blocks - 1) * \
        tbp.BIN_TARGETS_PER_BLOCK
    assert plan.per_block % 4 == 0 and plan.blocks * plan.per_block >= m
    assert (plan.blocks - 1) * plan.per_block < max(m, 1)
    offs = [plan.counts, plan.tile_total, plan.tile_start, plan.bins,
            plan.nbytes]
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)
    assert plan.tile_total - plan.counts >= 4 * plan.n_tiles * plan.blocks
    assert plan.tile_start - plan.tile_total >= 4 * plan.n_tiles
    assert plan.bins - plan.tile_start >= 4 * (plan.n_tiles + 1)
    assert plan.nbytes - plan.bins >= 2 * m


def test_bin_plan_at_pancake_12():
    """7,309 tiles, the last of 4,032 words; the bins of the widest level
    take 2M bytes."""
    plan = tbp.bin_plan(W12, 11 * max(SIZES12), 132)
    assert 11 * max(SIZES12) == 1862654343
    assert plan.n_tiles == 7309 and W12 - 7308 * tbp.TILE_WORDS == 4032
    assert plan.nbytes - plan.bins == 2 * 1862654343 + 2


def test_route():
    """Binned from half as many targets as words, where the measured times
    cross (between levels 6 and 7 of n = 12: 0.2 and 1.1 targets a word),
    and while the scatter's shared memory holds the tiles."""
    assert tbp.route(W12, 0) == "atomic"
    assert tbp.route(W12, W12 // 2 - 1) == "atomic"
    assert tbp.route(W12, W12 // 2) == "binned"
    routes = [tbp.route(W12, 11 * s) for s in SIZES12]
    assert routes == ["atomic"] * 7 + ["binned"] * 7 + ["atomic"]
    wide = tbp.BIN_MAX_TILES * tbp.TILE_WORDS
    assert tbp.route(wide, wide) == "binned"
    assert tbp.route(wide + 1, wide) == "atomic"


def test_route_counters():
    assert obs._COUNTERS["bitpack_route"] is tbp.ROUTE_LAUNCHES
    assert set(tbp.ROUTE_LAUNCHES) == {"binned", "atomic"}
    tbp.ROUTE_LAUNCHES["binned"] += 3
    tbp.LAUNCHES["scatter_mark"] += 1
    tbp.reset_launches()
    assert tbp.ROUTE_LAUNCHES == {"binned": 0, "atomic": 0}
    assert not any(tbp.LAUNCHES.values())


def test_cpu_calls_book_no_route():
    tbp.reset_launches()
    rng = np.random.default_rng(6)
    words = _t(_words(rng, 9))
    idx = torch.from_numpy(_idx(rng, 9, 30, 4))
    tbp.bitpack_scatter_mark(words, idx)
    tbp.bitpack_mark_rotate_count(words, idx, ROTATE, 1, inplace=True)
    assert tbp.ROUTE_LAUNCHES == {"binned": 0, "atomic": 0}


def test_mark_refuses_an_unknown_route():
    words = _t(_words(np.random.default_rng(7), 4))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown route"):
        tbp._mark(words, idx, torch.empty_like(words), 2, 0, path="tiled")
