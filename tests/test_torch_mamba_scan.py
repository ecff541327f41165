"""Port parity: the selective scan behind K9 (``repro_torch.kernels.ops
.mamba_scan``, which on a CPU tensor runs its plain version) against the
JAX package.

References: the Pallas kernel in interpret mode
(``repro.kernels.ops.mamba_scan(impl="interpret")``), the reference's
associative and sequential oracles, and ``mamba_scan_seq_stateful`` for
the final state.  Tolerances are those of ``tests/test_kernels.py:85-127``:
1e-4 in float32 (sums and products taken in another order), 5e-2 in
bfloat16 (the output is rounded to bfloat16).  Inputs come from numpy
seeds.  The CUDA kernel is held against the same plain versions on the
card by ``chip_smoke.py``.

The backward (K9-bwd's plain version, ``ref.mamba_scan_bwd_plain``, run
through the autograd Function ``ops._MambaScan`` from the chunk states of
``ref.mamba_scan_chunks_plain``) is held to ``jax.vjp`` of the reference's
associative and sequential scans at the edge shapes of the kernel: one
step, a chunk of 32 steps less one, one and one more, 4101 steps (a ragged
tail), N of 1, 4, 16 and 64, channels no multiple of the kernel's block,
strided b and c, batch 3, and a decay near 1 and a large dt, in float32
within 1e-4 (each gradient elementwise against its own largest value:
sums over time and channels taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MAMBA_CASES = [                  # tests/test_kernels.py:85-90
    (2, 64, 32, 16, 16, 32),     # b, l, di, n, bd, bt
    (1, 100, 16, 8, 16, 32),     # unaligned length
    (1, 128, 64, 4, 32, 64),
    (3, 32, 8, 16, 8, 16),
]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, l, di, n, seed, dtype=np.float32):
    """x, dt, a, b, c, d as numpy arrays, as tests/test_kernels.py draws
    them: dt = 0.1·|N|, a = -|N|."""
    rng = np.random.default_rng(seed)
    nrm = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    x, dt = nrm(b, l, di), np.abs(nrm(b, l, di)) * 0.1
    a = -np.abs(nrm(di, n))
    bb, cc, d = nrm(b, l, n), nrm(b, l, n), nrm(di)
    if dtype != np.float32:          # round through bfloat16, as both see it
        x, dt, bb, cc = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                         for t in (x, dt, bb, cc))
    return x, dt, a, bb, cc, d


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype if a.ndim == 3 else torch.float32)
            for a in arrs]


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype if a.ndim == 3 else jnp.float32)
            for a in arrs]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_plain_versions_match_the_pallas_kernel(case):
    b, l, di, n, bd, bt = case
    arrs = _inputs(b, l, di, n, 1)
    pallas = jops.mamba_scan(*_jax(arrs), impl="interpret", block_d=bd,
                             block_t=bt)
    t = _torch(arrs)
    for got in (tref.mamba_scan_ref(*t), tref.mamba_scan_seq_ref(*t),
                tops.mamba_scan(*t)):
        assert got.dtype == torch.float32 and got.shape == (b, l, di)
        np.testing.assert_allclose(_np(got), _np(pallas), **TOL)


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_final_state_matches_jax(case):
    b, l, di, n = case[:4]
    arrs = _inputs(b, l, di, n, 2)
    jy, jh = jref.mamba_scan_seq_stateful(*_jax(arrs))
    y, h = tops.mamba_scan(*_torch(arrs), return_state=True)
    assert h.dtype == torch.float32 and h.shape == (b, di, n)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    # from a given state, as the reference's h0
    h0 = np.random.default_rng(3).standard_normal((b, di, n), np.float32)
    jy, jh = jref.mamba_scan_seq_stateful(*_jax(arrs), h0=jnp.asarray(h0))
    y, h = tref.mamba_scan_seq_stateful(*_torch(arrs),
                                        h0=torch.from_numpy(h0))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_bfloat16_matches_the_pallas_kernel():
    """tests/test_kernels.py:112-127: b 1, l 64, di 16, n 8."""
    arrs = _inputs(1, 64, 16, 8, 4, dtype="bfloat16")
    pallas = jops.mamba_scan(*_jax(arrs, jnp.bfloat16), impl="interpret",
                             block_d=16, block_t=32)
    for return_state in (False, True):
        got = tops.mamba_scan(*_torch(arrs, torch.bfloat16),
                              return_state=return_state)
        y = got[0] if return_state else got
        assert y.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(y), _np(pallas), atol=5e-2, rtol=5e-2)
    _, jh = jref.mamba_scan_seq_stateful(*_jax(arrs, jnp.bfloat16))
    np.testing.assert_allclose(_np(got[1]), _np(jh), **TOL)


def test_long_sequences_take_the_sequential_form():
    """Above 512 steps the dispatchers run the sequential form (the
    associative one materialises (B, L, Di, N) several times over), as
    ``repro/kernels/ops.py:107-113`` does."""
    arrs = _inputs(1, 600, 8, 4, 5)
    t = _torch(arrs)
    got = tops.mamba_scan(*t, impl="ref")
    assert torch.equal(got, tref.mamba_scan_seq_ref(*t))
    np.testing.assert_allclose(_np(got), _np(jops.mamba_scan(
        *_jax(arrs), impl="ref")), **TOL)
    short = [a[:, :512] if a.ndim == 3 else a for a in t]
    assert torch.equal(tops.mamba_scan(*short, impl="ref"),
                       tref.mamba_scan_ref(*short))


def test_dispatcher_goes_by_device_and_counts_only_launches():
    t = _torch(_inputs(2, 40, 8, 4, 6))
    tms.reset_launches()
    for impl in ("auto", "ref"):
        assert torch.equal(tops.mamba_scan(*t, impl=impl),
                           tref.mamba_scan_ref(*t))
        y, h = tops.mamba_scan(*t, impl=impl, return_state=True)
        wy, wh = tref.mamba_scan_seq_stateful(*t)
        assert torch.equal(y, wy) and torch.equal(h, wh)
        assert torch.equal(tms.mamba_scan(*t), tref.mamba_scan_ref(*t))
    assert tms.LAUNCHES == {"mamba_scan": 0, "mamba_scan_bwd": 0}
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA tensor"):
        tops.mamba_scan(*t, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.mamba_scan(*t, impl="interpret")
    assert tms.LAUNCHES == {"mamba_scan": 0, "mamba_scan_bwd": 0}


def test_wrapper_checks_its_inputs():
    x, dt, a, b, c, d = _torch(_inputs(1, 16, 8, 4, 7))
    with pytest.raises(ValueError, match="x .* and dt"):
        tms.mamba_scan(x, dt[:, :8], a, b, c, d)
    with pytest.raises(ValueError, match="is not \\(Di=8, N\\)"):
        tms.mamba_scan(x, dt, a[:4], b, c, d)
    with pytest.raises(ValueError, match="must be \\(B, L, N\\)"):
        tms.mamba_scan(x, dt, a, b[..., :3], c, d)
    with pytest.raises(ValueError, match="is not \\(Di=8,\\)"):
        tms.mamba_scan(x, dt, a, b, c, d[:3])
    with pytest.raises(ValueError, match="must share one of"):
        tms.mamba_scan(x, dt, a, b.bfloat16(), c, d)
    with pytest.raises(ValueError, match="must share one of"):
        tms.mamba_scan(x.double(), dt.double(), a, b.double(), c.double(), d)


# K9's order of sums (time in segments of tms.SEG_LEN steps, each composed
# on its own, the segments folded from the carried state, then walked again
# from their prefixes), mirrored in plain PyTorch by
# ``ref.mamba_scan_segmented``: held in float32 to the reference's
# sequential scan within the float32 tolerance.  The card's kernel is held
# to the same mirror by chip_smoke.py.

@pytest.mark.parametrize("case", MAMBA_CASES)
def test_segmented_order_matches_jax(case):
    b, l, di, n = case[:4]
    arrs = _inputs(b, l, di, n, 8)
    jy, jh = jref.mamba_scan_seq_stateful(*_jax(arrs))
    y, h = tref.mamba_scan_segmented(*_torch(arrs), seg_len=tms.SEG_LEN)
    assert y.dtype == torch.float32 and h.shape == (b, di, n)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


@pytest.mark.parametrize("dt_scale", [1e-3, 1e-4])
def test_segmented_order_holds_with_decay_near_one(dt_scale):
    """dt·a near 0: each step's decay is near 1, so the state remembers
    thousands of steps and a reordered sum has the longest run to drift
    over.  L = 4096 (128 of the kernel's chunks), Di and N as falcon-mamba's
    N, one ragged time tail."""
    b, l, di, n = 1, 4096 + 5, 16, 16
    x, dt, a, bb, cc, d = _inputs(b, l, di, n, 9)
    dt = dt / 0.1 * dt_scale          # |N| · dt_scale
    arrs = (x, dt, a, bb, cc, d)
    jy, jh = jref.mamba_scan_seq_stateful(*_jax(arrs))
    assert float(np.max(np.exp(np.asarray(dt)[0, :, :, None] * a))) > 0.999
    y, h = tref.mamba_scan_segmented(*_torch(arrs), seg_len=tms.SEG_LEN)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    # the state carries many steps: h is far from the last step's input
    assert float(np.abs(_np(jh)).max()) > 10 * float(
        np.abs(dt[0, -1, :, None] * x[0, -1, :, None] * bb[0, -1]).max())


# ------------------------------------------------------------ backward

BWD_CASES = {  # b, l, di, n, and how the inputs are drawn
    "one step": (2, 1, 5, 4, "plain"),
    "a chunk less one": (1, 31, 7, 16, "plain"),
    "one chunk": (2, 32, 3, 1, "plain"),
    "a chunk and one": (3, 33, 37, 16, "strided"),
    "N 64 over two chunks": (1, 70, 6, 64, "plain"),
    "4101 steps": (1, 4101, 5, 4, "plain"),
    "decay near 1": (1, 300, 9, 16, "slow"),
    "large dt": (2, 100, 8, 8, "fast"),
}


def _bwd_inputs(b, l, di, n, kind, seed):
    """x, dt, a, b, c, d, dy as numpy: ``slow`` makes each step's decay
    exp(dt·a) near 1 (long memory), ``fast`` draws dt near 3 (a decay near
    0 for the larger |a|); ``strided`` hands b and c to the port as column
    slices of one array."""
    x, dt, a, bb, cc, d = _inputs(b, l, di, n, seed)
    if kind == "slow":
        dt = dt * 1e-2
    if kind == "fast":
        dt = dt * 30.0
    dy = np.random.default_rng(seed + 1).standard_normal((b, l, di),
                                                         np.float32)
    return (x, dt, a, bb, cc, d), dy


def _port_grads(arrs, dy, strided):
    t = [x.clone().requires_grad_(True) for x in _torch(arrs)]
    args = list(t)
    if strided:       # b and c as column slices of one (B, L, 2N) tensor
        both = torch.cat([t[3], t[4]], -1)
        args[3], args[4] = both.split(t[3].shape[-1], -1)
    y = tops._MambaScan.apply(*args, True)
    return y, torch.autograd.grad(y, t, torch.from_numpy(dy))


def _close_grad(got, want, what):
    """Elementwise within 1e-4 of the gradient's own largest value (plus
    1e-4 relative)."""
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_backward_matches_jax_vjp(name):
    b, l, di, n, kind = BWD_CASES[name]
    arrs, dy = _bwd_inputs(b, l, di, n, kind, 11)
    y, got = _port_grads(arrs, dy, kind == "strided")
    forms = [jref.mamba_scan_seq_ref] + ([jref.mamba_scan_ref]
                                         if l <= 512 else [])
    for form in forms:
        jy, vjp = jax.vjp(jax.jit(form), *_jax(arrs))
        np.testing.assert_allclose(_np(y.detach()), _np(jy), **TOL)
        for nm, g, w in zip("x dt a b c d".split(), got,
                            vjp(jnp.asarray(dy))):
            assert g.shape == w.shape and g.dtype == torch.float32
            _close_grad(g, w, f"{name}: d{nm} ({form.__name__})")


def test_chunk_states_are_the_sequential_forms():
    """The forward's residual: the state after every CHUNK steps and after
    the last step, the sequential form's; y its y."""
    arrs = _inputs(2, 70, 6, 4, 12)
    t = _torch(arrs)
    y, chunks = tms.mamba_scan(*t, return_chunks=True)
    assert chunks.shape == (2, 3, 6, 4) and chunks.dtype == torch.float32
    wy, wh = tref.mamba_scan_seq_stateful(*t)
    assert torch.equal(y, wy) and torch.equal(chunks[:, -1], wh)
    for k, steps in enumerate((32, 64)):
        cut = [a[:, :steps] if a.ndim == 3 else a for a in t]
        assert torch.equal(chunks[:, k],
                           tref.mamba_scan_seq_stateful(*cut)[1])
    with pytest.raises(ValueError, match="exclude each other"):
        tms.mamba_scan(*t, return_state=True, return_chunks=True)


def test_bfloat16_backward_matches_jax_vjp():
    """bfloat16 inputs: the gradients of x and dt come back in bfloat16
    (5e-2, the forward's bfloat16 tolerance), the others in float32 from
    the same float32 sums, within 1e-4."""
    arrs = _inputs(1, 64, 16, 8, 13, dtype="bfloat16")
    dy = np.random.default_rng(14).standard_normal((1, 64, 16), np.float32)
    t = [x.clone().requires_grad_(True)
         for x in _torch(arrs, torch.bfloat16)]
    y = tops._MambaScan.apply(*t, True)
    got = torch.autograd.grad(y, t, torch.from_numpy(dy).bfloat16())
    _, vjp = jax.vjp(jax.jit(jref.mamba_scan_seq_ref), *_jax(arrs))
    dyb = np.asarray(jnp.asarray(dy, jnp.bfloat16), np.float32)
    for nm, g, w, x in zip("x dt a b c d".split(), got,
                           vjp(jnp.asarray(dyb)), t):
        assert g.dtype == x.dtype
        if x.dtype == torch.bfloat16 and nm in ("x", "dt"):
            np.testing.assert_allclose(_np(g), _np(w), atol=5e-2, rtol=5e-2)
        else:
            scale = max(float(np.abs(_np(w)).max()), 1.0)
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-2,
                                       atol=1e-2 * scale, err_msg=nm)


def test_ops_takes_the_function_under_grad_and_counts_no_launch():
    """``ops.mamba_scan`` with an input requiring a gradient runs
    ``_MambaScan`` (the sequential form with its chunk states on a CPU
    tensor, impl "auto" and "ref" alike), and its gradient is the plain
    backward's; without grad mode it is the forward the dispatcher always
    ran.  The final state carries no gradient, so asking for it then
    raises.  No kernel launches on the CPU."""
    arrs, dy = _bwd_inputs(2, 40, 8, 4, "plain", 15)
    tms.reset_launches()
    want_y, want = _port_grads(arrs, dy, False)
    for impl in ("auto", "ref"):
        t = [x.clone().requires_grad_(True) for x in _torch(arrs)]
        y = tops.mamba_scan(*t, impl=impl)
        assert y.grad_fn is not None and torch.equal(y, want_y)
        got = torch.autograd.grad(y, t, torch.from_numpy(dy))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        with torch.no_grad():
            assert torch.equal(tops.mamba_scan(*t, impl=impl),
                               tref.mamba_scan_ref(*_torch(arrs)))
        with pytest.raises(NotImplementedError, match="no gradient"):
            tops.mamba_scan(*t, impl=impl, return_state=True)
    assert tms.LAUNCHES == {"mamba_scan": 0, "mamba_scan_bwd": 0}


def test_backward_wrapper_checks_its_inputs_and_goes_by_device():
    arrs, dy = _bwd_inputs(1, 40, 8, 4, "plain", 16)
    t = _torch(arrs)
    dyt = torch.from_numpy(dy)
    _, chunks = tms.mamba_scan(*t, return_chunks=True)
    got = tms.mamba_scan_bwd(*t, dyt, chunks)
    want = tref.mamba_scan_bwd_plain(*t, dyt, chunks)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [tuple(g.shape) for g in got] == [(1, 40, 8), (1, 40, 8), (8, 4),
                                             (1, 40, 4), (1, 40, 4), (8,)]
    with pytest.raises(ValueError, match="h_chunks"):
        tms.mamba_scan_bwd(*t, dyt, chunks[:, :1])
    with pytest.raises(ValueError, match="must be x's"):
        tms.mamba_scan_bwd(*t, dyt[:, :8], chunks)
    with pytest.raises(ValueError, match="must share one of"):
        tms.mamba_scan_bwd(t[0], t[1], t[2], t[3].bfloat16(), t[4], t[5],
                           dyt, chunks)
    assert tms.LAUNCHES["mamba_scan_bwd"] == 0
    geo = tms.bwd_geometry(1, 4096, 8192, 16)
    assert (geo["states"], geo["channels"], geo["grid"], geo["chunks"]) == \
        (16, 16, (512, 1), 128)
    assert geo["part_bytes"] == 268_435_456
    assert tms.bwd_geometry(1, 4096, 4096, 64)["states"] == 64
    assert tms.bwd_geometry(1, 1, 37, 3)["grid"] == (1, 1)
