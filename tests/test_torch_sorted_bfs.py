"""Port parity for the sorted-list BFS (Tier J): ``repro_torch.core.
constructs`` ``dedupe_subtract_fold`` / ``breadth_first_search`` and the
apps ``pancake_bfs`` / ``cayley_bfs`` vs ``repro.core.constructs`` and the
reference examples' ``gen_next_jnp``, on the CPU.

The port expands only the frontier's live rows and, fused, sorts only live
rows, where the reference expands and sorts every slot; the lists must
still be the reference's bit for bit — ``data`` past ``count`` included,
``count``, the level sizes and the overflow flags.  Also the pass budget
(``types.SORT_STATS``: a fused level is 1 lexsort + 1 scatter, an unfused
one 2 + 2), the spans, the capacity growth, the two-word encoding against
a jnp generator of the same encoding, and pancake n = 9 (two words a row)
against the implicit engine.  Tolerance: none, everything is integer.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constructs as JC
from repro.core import rlist as JRL
from repro_torch import convert
from repro_torch.apps import cayley_bfs as CB
from repro_torch.apps import pancake_bfs as PB
from repro_torch.apps import pancake_bits as P
from repro_torch.core import constructs as C
from repro_torch.core import obs
from repro_torch.core import rlist as RL
from repro_torch.core import types as T

REPO = Path(__file__).resolve().parents[1]
sys.path.append(str(REPO / "examples"))
import cayley_bfs as ref_cayley  # noqa: E402
import pancake_bfs as ref_pancake  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


from test_torch_rlist import same  # noqa: E402


# ------------------------------------------------ dedupe_subtract_fold

j_dsf = jax.jit(JC.dedupe_subtract_fold, static_argnums=3)
M_PAD = 40         # every expansion padded to 40 rows, the padding invalid
CAP = 40           # and every visited list to 40 slots: few jitted shapes
NEXT_CAP = M_PAD + 4


def dsf_cases():
    """The 20 random cases of ``tests/test_sort_once.py:358`` (same seed and
    draws), padded to one shape a width: the expansion to ``M_PAD`` rows
    with garbage rows marked invalid, the visited list to ``CAP`` slots
    with garbage past count, next_cap ``NEXT_CAP`` (m + 4 at the padded
    m).  Every fourth case also runs with next_cap 2, below its
    survivors, or with a visited list one row short, in turns."""
    rng = np.random.default_rng(7)
    for case in range(20):
        m = int(rng.integers(1, 40))
        na = int(rng.integers(1, 30))
        width = int(rng.integers(1, 3))
        nxt_rows = rng.integers(0, 20, size=(m, width)).astype(np.uint32)
        nxt_valid = rng.random(m) < 0.8
        all_rows = np.unique(rng.integers(0, 20, size=(na, width))
                             .astype(np.uint32), axis=0)
        rows = np.full((M_PAD, width), 11, np.uint32)   # 11 is a live value
        rows[:m] = nxt_rows
        valid = np.zeros(M_PAD, bool)
        valid[:m] = nxt_valid
        yield case, rows, valid, all_rows, CAP, NEXT_CAP
        if case % 8 == 0:
            yield case, rows, valid, all_rows, CAP, 2
        elif case % 4 == 0:
            yield case, rows, valid, all_rows, len(all_rows) + 1, NEXT_CAP


def test_dedupe_subtract_fold_matches_jax():
    overflows = 0
    for case, rows, valid, all_rows, cap, next_cap in dsf_cases():
        # garbage past count, which both sides must mask
        data = np.full((cap, rows.shape[1]), 3, np.uint32)
        data[:len(all_rows)] = all_rows
        jall = JRL.RoomyList(jnp.asarray(data),
                             jnp.asarray(len(all_rows), jnp.int32))
        tall = convert.rlist_from_jax(jall, device="cpu")
        jn, ja, jov = j_dsf(jnp.asarray(rows), jnp.asarray(valid), jall,
                            next_cap)
        T.reset_sort_stats()
        tn, ta, tov = C.dedupe_subtract_fold(RL.as_rows(rows, "cpu"),
                                             torch.from_numpy(valid), tall,
                                             next_cap)
        assert T.SORT_STATS == {"lexsorts": 1, "scatters": 1}, case
        same(tn, jn)
        same(ta, ja)
        assert tn.capacity == next_cap
        assert bool(tov) == bool(jov), case
        overflows += bool(tov)
    assert overflows >= 5          # the short next_cap and visited cases


# ------------------------------------------------------------- the BFS

def run_both(n, ref_gen, moves, fused, all_cap=None, level_cap=None):
    total = math.factorial(n)
    all_cap = all_cap or total + 8
    level_cap = level_cap or total + 8
    start = np.array([[ref_pancake.start_code(n)]], np.uint32)
    want = JC.breadth_first_search(start, ref_gen, fanout=n - 1, width=1,
                                   all_capacity=all_cap,
                                   level_capacity=level_cap, fused=fused)
    got = C.breadth_first_search(start, moves, fanout=n - 1, width=1,
                                 all_capacity=all_cap,
                                 level_capacity=level_cap, fused=fused,
                                 device="cpu")
    assert got.level_sizes == want.level_sizes
    assert got.levels_run == want.levels_run
    same(got.all, want.all)
    assert sum(got.level_sizes) == total
    return got


@pytest.mark.parametrize("n,fused", [(5, True), (6, True), (7, True),
                                     (6, False)])
def test_pancake_matches_jax(n, fused):
    got = run_both(n, ref_pancake.gen_next_jnp(n), PB.prefix_flips(n), fused)
    assert len(got.level_sizes) - 1 == P.DIAMETERS[n]


@pytest.mark.parametrize("fused", [True, False])
def test_cayley_matches_jax(fused):
    n = 5
    got = run_both(n, ref_cayley.gen_next_jnp(n), CB.adjacent_swaps(n),
                   fused)
    assert got.level_sizes == CB.mahonian(n) == ref_cayley.mahonian(n)


@pytest.mark.parametrize("fused", [True, False])
def test_capacity_growth_matches_jax(fused):
    """``tests/test_constructs.py:127``: 120 states do not fit a visited
    list of 16, which doubles three times, the same as the reference's."""
    got = run_both(5, ref_pancake.gen_next_jnp(5), PB.prefix_flips(5),
                   fused, all_cap=16, level_cap=64)
    assert got.all.capacity == 128


def test_expand_in_batches_is_one_expansion():
    """Only rows [0, count) expand, in row order, whatever the batch."""
    n = 6
    cur = RL.from_rows(RL.as_rows(PB.pack(torch.stack(
        [torch.randperm(n, generator=torch.Generator().manual_seed(s))
         for s in range(10)]), n), "cpu"), capacity=16, device="cpu")
    cur = cur._replace(data=cur.data.clone().fill_(5).index_copy_(
        0, torch.arange(10), cur.data[:10]))           # garbage past count
    rows, valid = C.expand(cur, PB.prefix_flips(n), n - 1)
    want, _ = PB.prefix_flips(n)(cur.data[:10])
    assert torch.equal(rows, want.reshape(-1, 1)) and bool(valid.all())
    for batch in (1, 3, 10):
        got, ok = C.expand(cur, PB.prefix_flips(n), n - 1, batch=batch)
        assert torch.equal(got, rows) and torch.equal(ok, valid)


def test_second_overflow_raises():
    with pytest.raises(MemoryError, match="twice"):
        C.breadth_first_search(PB.start_code(5)[None], PB.prefix_flips(5),
                               fanout=4, width=1, all_capacity=1,
                               level_capacity=8, device="cpu")


def test_default_device_is_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            C.breadth_first_search(PB.start_code(4)[None],
                                   PB.prefix_flips(4), fanout=3, width=1,
                                   all_capacity=32, level_capacity=32)


# ----------------------------------------------- the two-word encoding

MASK = 0xF0000000          # word 0 flipped high: bit 31 set on every row


def two_word_jnp(n):
    """Pancake flips on two words: positions 0..2 in word 0 (xor MASK),
    the rest in word 1, 4 bits each."""
    def unpack(row):
        w0 = row[0] ^ jnp.uint32(MASK)
        return jnp.stack([(w0 >> jnp.uint32(4 * i)) & jnp.uint32(0xF)
                          for i in range(3)]
                         + [(row[1] >> jnp.uint32(4 * i)) & jnp.uint32(0xF)
                            for i in range(n - 3)])

    def pack(p):
        w0 = jnp.uint32(0)
        for i in range(3):
            w0 = w0 | (p[i] << jnp.uint32(4 * i))
        w1 = jnp.uint32(0)
        for i in range(n - 3):
            w1 = w1 | (p[3 + i] << jnp.uint32(4 * i))
        return jnp.stack([w0 ^ jnp.uint32(MASK), w1])

    def gen(row):
        p = unpack(row)
        outs = [pack(jnp.concatenate([p[:k][::-1], p[k:]]))
                for k in range(2, n + 1)]
        return jnp.stack(outs), jnp.ones((n - 1,), bool)
    return gen


class TwoWordTorch:
    """The same generator, batched in torch over int32 rows."""

    def __init__(self, n):
        self.n = n
        self.flips = PB.prefix_flips(n).table

    def __call__(self, rows):
        n = self.n
        w0 = rows[:, 0].to(torch.int64) ^ MASK
        w1 = rows[:, 1].to(torch.int64)
        p = torch.stack([(w0 >> 4 * i) & 0xF for i in range(3)]
                        + [(w1 >> 4 * i) & 0xF for i in range(n - 3)], 1)
        q = p[:, self.flips]                               # (m, n-1, n)
        w0 = sum(q[..., i] << 4 * i for i in range(3)) ^ MASK
        w1 = sum(q[..., 3 + i] << 4 * i for i in range(n - 3))
        out = torch.stack([T.to_int32_bits(w0), T.to_int32_bits(w1)], -1)
        return out, torch.ones(q.shape[:2], dtype=torch.bool)


def test_two_word_generator_matches_jax():
    n = 6
    total = math.factorial(n)
    start = np.array([[sum(i << 4 * i for i in range(3)) ^ MASK,
                       sum((3 + i) << 4 * i for i in range(n - 3))]],
                     np.uint32)
    kw = dict(fanout=n - 1, width=2, all_capacity=total + 8,
              level_capacity=total + 8)
    want = JC.breadth_first_search(start, two_word_jnp(n), **kw)
    got = C.breadth_first_search(start, TwoWordTorch(n), device="cpu", **kw)
    assert got.level_sizes == want.level_sizes
    assert len(got.level_sizes) - 1 == P.DIAMETERS[n]
    same(got.all, want.all)


# ------------------------------------------------------------- the apps

@pytest.mark.parametrize("n", [5, 8])
def test_codec_is_the_reference_encoding(n):
    """At n ≤ 8 the port's rows are the reference's one word, and the flips
    are ``examples/pancake_bfs.py``'s ``GenNextNp`` and ``examples/
    cayley_bfs.py``'s bit for bit."""
    assert PB.words(n) == 1
    assert PB.start_code(n).tolist() == [int(ref_pancake.start_code(n))]
    perms = np.array([np.random.default_rng(s).permutation(n)
                      for s in range(50)])
    codes = (perms.astype(np.uint32) << (4 * np.arange(n, dtype=np.uint32))
             ).sum(1, dtype=np.uint32)[:, None]
    rows = RL.as_rows(codes, "cpu")
    for port, ref in ((PB.prefix_flips(n), ref_pancake.gen_next_np(n)),
                      (CB.adjacent_swaps(n), ref_cayley.gen_next_np(n))):
        got, ok = port(rows)
        assert got.shape == (50, n - 1, 1) and bool(ok.all())
        want = ref(codes).reshape(n - 1, 50).T       # the reference's order
        np.testing.assert_array_equal(got[..., 0].numpy().view(np.uint32),
                                      want)


@pytest.mark.parametrize("n", [9, 10, 12])
def test_codec_two_words_round_trip(n):
    assert PB.words(n) == 2
    perms = torch.stack([torch.randperm(n, generator=torch.Generator()
                                        .manual_seed(s)) for s in range(40)])
    rows = PB.pack(perms, n)
    assert rows.dtype == torch.int32 and rows.shape == (40, 2)
    assert torch.equal(PB.unpack(rows, n), perms)
    assert bool((rows[:, 0] < 0).any())      # bit 31: position 7 holds ≥ 8
    start = PB.start_code(n)
    assert torch.equal(PB.unpack(RL.as_rows(start[None], "cpu"), n)[0],
                       torch.arange(n))


def test_pancake_app_n9_two_words_matches_implicit():
    sizes, res, _ = PB.run(9, device="cpu")
    want, _, _ = P.run(9, device="cpu")
    assert sizes == want and len(sizes) - 1 == 10
    rows = RL.to_numpy(res.all)
    assert rows.shape == (math.factorial(9), 2)
    assert len(np.unique(rows, axis=0)) == len(rows)


def test_clis(capsys):
    PB.main(["--n", "6", "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "diameter (max flips to sort): 7" in out
    assert "check: level sizes match the implicit engine's" in out
    CB.main(["--n", "5", "--device", "cpu"])
    assert "== Mahonian numbers T(5,k)" in capsys.readouterr().out
    P.main(["--n", "6", "--device", "cpu", "--check"])
    assert ("check: level sizes match the sorted-list BFS"
            in capsys.readouterr().out)


# ------------------------------------------------- budget and spans

@pytest.mark.parametrize("fused,budget", [(True, 1), (False, 2)])
def test_per_level_sort_budget_and_spans(fused, budget):
    spans = []
    obs.enable(sink=spans.append)
    try:
        res = C.breadth_first_search(PB.start_code(6)[None],
                                     PB.prefix_flips(6), fanout=5, width=1,
                                     all_capacity=728, level_capacity=728,
                                     fused=fused, device="cpu")
    finally:
        obs.disable()
    levels = [s for s in spans if s["sid"] == "bfs.level"]
    expands = [s for s in spans if s["sid"] == "bfs.expand"]
    # 7 levels, then the 8th finds nothing new (it runs and is counted)
    assert len(levels) == len(expands) == res.levels_run == 8
    assert len(res.level_sizes) == 8
    for lv, ex, size in zip(levels, expands, res.level_sizes):
        assert lv["attrs"] == {"level": lv["attrs"]["level"], "tier": "torch",
                               "engine": "sorted", "frontier": size}
        assert lv["metrics"] == {"tierj.lexsorts": budget,
                                 "tierj.scatters": budget}
        assert ex["parent"] == "bfs.level" and ex["attrs"]["n_cur"] == size
    assert [s["attrs"]["level"] for s in levels] == list(range(1, 9))
