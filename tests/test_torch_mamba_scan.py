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
"""
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
    assert tms.LAUNCHES == {"mamba_scan": 0}
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA tensor"):
        tops.mamba_scan(*t, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.mamba_scan(*t, impl="interpret")
    assert tms.LAUNCHES == {"mamba_scan": 0}


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
