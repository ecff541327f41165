"""Port parity: the plain version behind K5 (the segment scatter-add,
``repro_torch.kernels.bucket_scatter``) vs the reference's oracle
``repro.kernels.ref.bucket_scatter_add_ref``, the dispatcher, and the plain
mirror of the kernel's own order of sums (``ref.bucket_scatter_add_ordered``)
with the wrapper's geometry.

The Pallas kernel is not run: under jax 0.9.0 its interpret mode raises
(``pl.load``).  Tolerance: atol = rtol = 1e-4, as
``tests/test_kernels.py:150-151`` holds the kernel, for float32 tables
(both sides sum in float32, possibly in another order); bit for bit where
each index receives at most one op (a single add), or where the payloads
are sixteenths of small integers (exact in any order).  bfloat16 tables:
the result is rounded to bfloat16 once, so the two agree to one bfloat16
ulp (rtol 2⁻⁷).  The CUDA kernel is held bit for bit to the mirror, and to
the plain version within these limits, on the card by ``chip_smoke.py``.
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


# ---------------------------------------------------------------- the mirror

G = tref.K5_CHUNK


def _mirror(table, idx, payload):
    return tref.bucket_scatter_add_ordered(torch.from_numpy(table),
                                           torch.from_numpy(idx),
                                           torch.from_numpy(payload)).numpy()


def _plain(table, idx, payload):
    return tref.bucket_scatter_add_ref(torch.from_numpy(table),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(payload)).numpy()


def _sequential(table, idx, payload):
    """Each row's ops added left to right from the first, then to the
    table: the TPU kernel's arithmetic for a sorted run, in numpy float32."""
    n = table.shape[0]
    out = table.copy()
    rows = np.where(idx < 0, idx.astype(np.int64) + n, idx)
    for r in np.unique(rows[(rows >= 0) & (rows < n)]):
        ops = np.flatnonzero(rows == r)
        acc = payload[ops[0]].copy()
        for i in ops[1:]:
            acc = acc + payload[i]
        out[r] = table[r] + acc
    return out


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_mirror_matches_oracle_at_jax_test_shapes(n, m, d, sort):
    args = _inputs(7 * n + m + d, n, m, d, -n - 3, n + 3, sort)
    got = _mirror(*args)
    np.testing.assert_allclose(got, _jax(*args), **TOL)
    np.testing.assert_allclose(got, _plain(*args), **TOL)


@pytest.mark.parametrize("d", [1, 3, 2304])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_mirror_at_row_tile_widths(d, sort):
    """The widths of the kernel's narrow and wide row tiles: D = 1 (a
    prefix round), 3 and 2304 (gemma2-2b's embedding)."""
    n, m = (700, 3000) if d < 2304 else (40, 300)
    args = _inputs(d + sort, n, m, d, -n - 3, n + 3, sort)
    got = _mirror(*args)
    np.testing.assert_allclose(got, _jax(*args), **TOL)
    np.testing.assert_allclose(got, _plain(*args), **TOL)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_mirror_bit_exact_one_op_a_row(sort):
    rng = np.random.default_rng(11)
    n, d = 500, 6
    idx = rng.permutation(np.arange(-n, n))[:300].astype(np.int32)
    _, first = np.unique(idx % n, return_index=True)
    idx = idx[np.sort(first)]
    if sort:
        idx = np.sort(idx)
    table = rng.standard_normal((n, d)).astype(np.float32)
    payload = rng.standard_normal((idx.shape[0], d)).astype(np.float32)
    got = _mirror(table, idx, payload)
    np.testing.assert_array_equal(got, _jax(table, idx, payload))
    np.testing.assert_array_equal(got, _plain(table, idx, payload))


@pytest.mark.parametrize("m", [100, 3 * G + 5])
def test_mirror_bit_exact_on_sixteenths(m):
    """Sixteenths of small integers add exactly in any order, runs longer
    than a chunk included."""
    rng = np.random.default_rng(m)
    n, d = 6, 5
    table = (rng.integers(-64, 65, (n, d)) / 16).astype(np.float32)
    idx = rng.integers(-n - 2, n + 2, m).astype(np.int32)
    payload = (rng.integers(-8, 9, (m, d)) / 16).astype(np.float32)
    got = _mirror(table, idx, payload)
    np.testing.assert_array_equal(got, _jax(table, idx, payload))
    np.testing.assert_array_equal(got, _plain(table, idx, payload))


def test_mirror_pins_the_chunked_order():
    """A row of 2G ops: 1e8, then G - 1 ones (each lost against 1e8), then
    -1e8 and G - 1 ones.  Chunks: s0 = 1e8, s1 = -1e8 (its ones lost as
    well), out = 0 + (s0 + s1) = 0.  A flat left-to-right sum gives
    1e8 - 1e8 + (G - 1) = 255 instead."""
    row = np.ones(2 * G, np.float32)
    row[0], row[G] = 1e8, -1e8
    idx = np.full(2 * G, 3, np.int32)
    for order in (idx, idx - 5):                 # 3 and its wrap -2
        got = _mirror(np.zeros((5, 1), np.float32), order, row[:, None])
        assert got[3, 0] == 0.0
        assert _sequential(np.zeros((5, 1), np.float32), order,
                           row[:, None])[3, 0] == 255.0
    # interleaved with another row, the order is each row's own op order
    idx = np.empty(4 * G, np.int32)
    idx[0::2], idx[1::2] = 3, 1
    pay = np.repeat(row, 2)[:, None].astype(np.float32)
    got = _mirror(np.zeros((5, 1), np.float32), idx, pay)
    assert got[3, 0] == 0.0 and got[1, 0] == 0.0
    # and against 1e8 the chunk's own sum of ones survives: s1 = G
    row2 = np.ones(2 * G, np.float32)
    row2[0] = 1e8
    got = _mirror(np.zeros((1, 1), np.float32), np.zeros(2 * G, np.int32),
                  row2[:, None])
    assert got[0, 0] == np.float32(1e8) + np.float32(G)      # 100000256
    np.testing.assert_allclose(got, _jax(np.zeros((1, 1), np.float32),
                                         np.zeros(2 * G, np.int32),
                                         row2[:, None]), **TOL)


@pytest.mark.parametrize("run", [G, G + 1])
def test_mirror_runs_of_g_and_g_plus_one_are_sequential(run):
    """Up to G ops a row is one chunk: the TPU kernel's left-to-right sum
    bit for bit; at G + 1 the second chunk is the last op alone, so the
    sum is still the sequential one."""
    rng = np.random.default_rng(run)
    table = rng.standard_normal((4, 3)).astype(np.float32)
    idx = np.full(run, 1, np.int32)
    payload = rng.standard_normal((run, 3)).astype(np.float32)
    got = _mirror(table, idx, payload)
    np.testing.assert_array_equal(got, _sequential(table, idx, payload))
    np.testing.assert_array_equal(got[[0, 2, 3]], table[[0, 2, 3]])
    np.testing.assert_allclose(got, _jax(table, idx, payload), **TOL)


def test_mirror_wraps_and_drops_as_the_oracle():
    table = np.zeros((4, 1), np.float32)
    idx = np.array([-1, 5, 4, 0, -5, 2, 2, -4, -100], np.int32)
    payload = np.array([[1000], [1], [1], [1], [9], [3], [4], [20], [7]],
                       np.float32)
    got = _mirror(table, idx, payload)
    np.testing.assert_array_equal(got, _jax(table, idx, payload))
    np.testing.assert_array_equal(got[:, 0], [21, 0, 7, 1000])
    for empty in (np.zeros(0, np.int32), np.array([4, -5, 99], np.int32)):
        np.testing.assert_array_equal(
            _mirror(table + 2, empty, np.ones((empty.shape[0], 1),
                                              np.float32)), table + 2)


@pytest.mark.parametrize("n,d,m,vec,rows,warps,passes,bits", [
    (256_000, 2304, 131_072, 4, 14, 16, 1, 18),   # the sync: 14 x 576
    (49_408, 1536, 4096, 4, 21, 16, 1, 16),       # the fold: 21 x 384
    (1 << 27, 1, 1 << 27, 1, 4096, 2048, 3, 9),   # a prefix round
    (1000, 3, 5000, 1, 2730, 20, 1, 10),          # narrow, no vector width
    (64, 40_000, 10, 4, 1, 1, 1, 6),              # a row wider than a tile
    ((1 << 22) + 4, 1, 131_072, 1, 4096, 512, 2, 12),   # past 2^22 rows
    (1 << 23, 8, 1000, 4, 4096, 4, 2, 12),        # few ops, many rows
])
def test_geometry(n, d, m, vec, rows, warps, passes, bits):
    geo = tbs.geometry(n, d, m, vec)
    assert geo["tile_rows"] == min(rows, tbs.MAX_TILE_ROWS)
    assert geo["tile_rows"] == 1 or geo["tile_rows"] * d // vec <= \
        tbs.TILE_VECS
    assert geo["n_tiles"] == -(-n // geo["tile_rows"])
    assert (geo["warps"], geo["passes"], geo["bits"]) == (warps, passes, bits)
    mat = n * warps if passes == 1 else warps << bits
    assert geo["mat"] == mat <= tbs.MAT_BUDGET
    # the binning keeps a warp to ONE_PASS_OPS ops, or takes every warp
    # it may have (one per OPS_PER_WARP ops, at most MAX_WARPS)
    assert -(-m // warps) <= tbs.ONE_PASS_OPS or warps == min(
        -(-m // tbs.OPS_PER_WARP), tbs.MAX_WARPS)
    windows = -(-m // tbs.CHUNK)
    assert geo["tasks"] == m // 2 + 2 * windows
    assert tbs.TASK_INTS * geo["tasks"] >= m       # the passes' second list
    assert geo["scratch_floats"] == 2 * windows * d
    assert geo["scan_steps"] == -(-mat // tbs.SCAN_CHUNK)
    assert geo["ws_ints"] == (tbs.HEADER_INTS + geo["n_tiles"] + 1 + mat
                              + geo["scan_steps"] + m
                              + tbs.TASK_INTS * geo["tasks"])


@pytest.mark.parametrize("n,m", [
    (49_408, 4096), (256_000, 131_072), ((1 << 22) + 4, 5000),
    (1 << 23, 1000), (1 << 27, 1 << 20)])
def test_geometry_passes_sort_rows_stably(n, m):
    """The binned route's passes as ``geometry`` sets them, each a stable
    sort by a digit of the row (``bits`` bits from the lowest, the last
    pass the rest), give the ops grouped by row in op order, and every
    digit of every pass has its column in the count matrix."""
    geo = tbs.geometry(n, 1, m, 1)
    rows = np.random.default_rng(m).integers(0, n, m)
    rows[: m // 4] = rows[m // 2]                  # a long run
    order = np.arange(m)
    for i in range(geo["passes"]):
        last = i == geo["passes"] - 1
        digit = rows[order] >> (i * geo["bits"])
        if not last:
            digit &= (1 << geo["bits"]) - 1
        assert (int(digit.max()) + 1) * geo["warps"] <= geo["mat"]
        order = order[np.argsort(digit, kind="stable")]
    np.testing.assert_array_equal(order, np.argsort(rows, kind="stable"))


def test_vector_width():
    t = torch.zeros(8, 12)
    p = torch.zeros(5, 12)
    assert tbs.vector_width(t, p) == 4
    assert tbs.vector_width(t[:, 1:9], p[:, :8]) == 1     # base not 16 B
    assert tbs.vector_width(t[:, :8], p[:, :8]) == 4      # strides 12
    assert tbs.vector_width(torch.zeros(8, 10)[:, :8], p[:, :8]) == 1
    assert tbs.vector_width(torch.zeros(8, 3), torch.zeros(5, 3)) == 1
