"""Port parity: ``repro_torch.core.rlist`` vs ``repro.core.rlist`` on the
same seeded numpy inputs.

Lists are uint32 rows in the reference and int32 tensors with the same
bits in the port; each case builds one list in both packages
(``convert.rlist_from_jax``) and runs every operation in both.  Everything
is integer or boolean, so every comparison is bit for bit: ``data``
(rows past ``count`` included), ``count``, overflow flags and masks.
The inputs cover widths 1–3, duplicates, the all-ones sentinel row as
data, words with bit 31 set (unsigned order), garbage past ``count``,
empty lists and ``add`` overflow.  The reference's functions run jitted
(eagerly, every small op compiles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rlist as JRL
from repro_torch import convert
from repro_torch.core import rlist as RL

CAP_A, CAP_B = 24, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, n, w, hi=4):
    """Small words (many duplicates), some with bit 31 set, some rows the
    sentinel."""
    rows = rng.integers(0, hi, (n, w)).astype(np.uint32)
    rows[rng.random((n, w)) < 0.25] |= np.uint32(0x80000000)
    rows[rng.random(n) < 0.1] = 0xFFFFFFFF
    return rows


def lists(seed, w, cap, count):
    """One list in both packages: rows [0, count) from ``words``, garbage
    (random non-sentinel words) past count."""
    rng = np.random.default_rng(seed)
    data = words(rng, cap, w)
    data[count:] = rng.integers(0, 1 << 32, (cap - count, w), np.uint64
                                ).astype(np.uint32)
    data[count:][np.all(data[count:] == 0xFFFFFFFF, axis=1)] = 7
    jl = JRL.RoomyList(jnp.asarray(data), jnp.asarray(count, jnp.int32))
    return jl, convert.rlist_from_jax(jl, device="cpu")


def t(rows):
    return RL.as_rows(rows, "cpu")


def same(got, want):
    np.testing.assert_array_equal(got.data.numpy().view(np.uint32),
                                  np.asarray(want.data))
    assert got.count.dtype == torch.int32 and got.count.shape == ()
    assert int(got.count) == int(want.count)


def same_bits(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = [(w, seed, count) for w in (1, 2, 3) for seed, count in
         ((0, 0), (1, 5), (2, 17), (3, CAP_A))]
ids = [f"w{w}-s{s}-c{c}" for w, s, c in CASES]


def test_make_from_rows_valid_mask():
    same(RL.make(5, 3, "cpu"), JRL.make(5, 3))
    rows = words(np.random.default_rng(9), 7, 2)
    same(RL.from_rows(rows, device="cpu"), JRL.from_rows(jnp.asarray(rows)))
    same(RL.from_rows(t(rows), capacity=12, device="cpu"),
         JRL.from_rows(jnp.asarray(rows), capacity=12))
    jl, tl = lists(4, 2, CAP_A, 9)
    same_bits(RL.valid_mask(tl), JRL.valid_mask(jl))
    assert RL.make(4, 1, "cpu").data.device.type == "cpu"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert RL.make(2, 1).data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RL.make(2, 1)


@pytest.mark.parametrize("w,seed,count", CASES, ids=ids)
def test_add_and_add_all(w, seed, count):
    jl, tl = lists(seed, w, CAP_A, count)
    rng = np.random.default_rng(100 + seed)
    rows = words(rng, 11, w)
    valid = rng.random(11) < 0.7
    jgot, jov = jax.jit(JRL.add)(jl, jnp.asarray(rows), jnp.asarray(valid))
    got, ov = RL.add(tl, t(rows), torch.from_numpy(valid))
    same(got, jgot)
    assert bool(ov) == bool(jov)                # overflow once count > 13
    jgot, jov = jax.jit(JRL.add)(jl, jnp.asarray(rows))
    got, ov = RL.add(tl, t(rows))
    same(got, jgot)
    assert bool(ov) == bool(jov)
    jb, tb = lists(seed + 50, w, CAP_B, min(count, CAP_B))
    jgot, jov = jax.jit(JRL.add_all)(jl, jb)
    got, ov = RL.add_all(tl, tb)
    same(got, jgot)
    assert bool(ov) == bool(jov)


def test_add_overflow_drops_past_capacity():
    jl, tl = lists(5, 2, CAP_B, 14)
    rows = words(np.random.default_rng(6), 5, 2)
    jgot, jov = JRL.add(jl, jnp.asarray(rows))
    got, ov = RL.add(tl, t(rows))
    same(got, jgot)
    assert bool(ov) and bool(jov) and int(got.count) == CAP_B


@pytest.mark.parametrize("w,seed,count", CASES, ids=ids)
def test_remove_all_and_remove(w, seed, count):
    jl, tl = lists(seed, w, CAP_A, count)
    for bcount in (0, 6, CAP_B):
        jb, tb = lists(seed + 10 * bcount + 1, w, CAP_B, bcount)
        # share some rows with a, so that removals happen
        shared = np.asarray(jl.data)[:bcount // 2]
        jb = jb._replace(data=jb.data.at[:len(shared)].set(shared))
        tb = convert.rlist_from_jax(jb, device="cpu")
        same(RL.remove_all(tl, tb), jax.jit(JRL.remove_all)(jl, jb))
        same(RL.remove_all(tb, tl), jax.jit(JRL.remove_all)(jb, jl))
    rows = np.asarray(jl.data)[::3]
    valid = np.arange(len(rows)) % 2 == 0
    same(RL.remove(tl, t(rows), torch.from_numpy(valid)),
         jax.jit(JRL.remove)(jl, jnp.asarray(rows), jnp.asarray(valid)))
    same(RL.remove(tl, t(rows)), jax.jit(JRL.remove)(jl, jnp.asarray(rows)))


@pytest.mark.parametrize("w,seed,count", CASES, ids=ids)
def test_remove_dupes(w, seed, count):
    jl, tl = lists(seed, w, CAP_A, count)
    got = RL.remove_dupes(tl)
    same(got, jax.jit(JRL.remove_dupes)(jl))
    out = RL.to_numpy(got)
    assert len({tuple(r) for r in out}) == len(out)


@pytest.mark.parametrize("w,seed,count", CASES, ids=ids)
def test_member_mask(w, seed, count):
    jl, tl = lists(seed, w, CAP_A, count)
    rng = np.random.default_rng(200 + seed)
    queries = np.concatenate([np.asarray(jl.data)[rng.integers(0, CAP_A, 6)],
                              words(rng, 9, w),
                              np.full((1, w), 0xFFFFFFFF, np.uint32)])
    same_bits(RL.member_mask(tl, t(queries)),
              jax.jit(JRL.member_mask)(jl, jnp.asarray(queries)))


@pytest.mark.parametrize("w,seed,count", CASES, ids=ids)
def test_map_reduce_predicate_count(w, seed, count):
    jl, tl = lists(seed, w, CAP_A, count)
    fn = lambda r: r[..., 0] * 3 + r[..., -1]  # noqa: E731
    np.testing.assert_array_equal(
        RL.map_rows(tl, fn).numpy().view(np.uint32),
        np.asarray(JRL.map_rows(jl, fn)))
    got = RL.reduce(tl, fn, lambda a, b: a + b, 0)
    want = jax.jit(lambda rl: JRL.reduce(rl, fn, lambda a, b: a + b,
                                         jnp.uint32(0)))(jl)
    assert got.shape == () and int(got) & 0xFFFFFFFF == int(want)
    got = RL.reduce(tl, lambda r: r[..., -1], torch.maximum, -(1 << 31))
    want = jax.jit(lambda rl: JRL.reduce(
        rl, lambda r: r[..., -1].astype(jnp.int32), jnp.maximum,
        jnp.int32(-(1 << 31))))(jl)
    assert int(got) == int(want)
    pred = lambda r: (r[..., 0] & 1) == 1  # noqa: E731
    got = RL.predicate_count(tl, pred)
    assert got.dtype == torch.int32
    assert int(got) == int(jax.jit(lambda rl: JRL.predicate_count(rl, pred))
                           (jl))


@pytest.mark.parametrize("w,seed,count", CASES, ids=ids)
def test_to_numpy(w, seed, count):
    jl, tl = lists(seed, w, CAP_A, count)
    got = RL.to_numpy(tl)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, JRL.to_numpy(jl))


def test_as_rows_keeps_the_bits():
    rows = np.array([[0, 0xFFFFFFFF], [0x80000000, 1]], np.uint32)
    for src in (rows, rows.tolist(), torch.from_numpy(rows.view(np.int32))):
        got = RL.as_rows(src, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), rows)


def test_segment_any_refuses_int32_overflow():
    rid = torch.zeros(4, dtype=torch.int32)
    assert RL.segment_any(torch.tensor([0, 1, 0, 0]), rid).all()
    with pytest.raises(OverflowError):
        RL.segment_any(torch.zeros(1), torch.zeros(1, dtype=torch.int32)
                       .expand(1 << 31))


def test_quickstart_prints_the_reference_lines(capsys):
    """``apps.quickstart`` prints the lines of ``examples/quickstart.py``:
    ``tier_j_tour`` (RoomyList, reduce, RoomyArray sync, chain reduction,
    the hash table) and ``tier_d_tour`` (a DiskList on disk), run here
    too."""
    import sys
    from pathlib import Path

    from repro_torch.apps import quickstart

    sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))
    import quickstart as ref_quickstart

    ref_quickstart.tier_j_tour()
    ref_quickstart.tier_d_tour()
    want = capsys.readouterr().out
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "hashtable lookups: [4, 2, 4] [True, True, False]" in got
