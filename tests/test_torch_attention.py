"""Port parity: the attention behind K6 (``repro_torch.kernels.ops
.flash_attention``, which on a CPU tensor runs its plain version) and the
decode attention, against the JAX package.

References: the Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention(impl="interpret")``) and the textbook
``repro.kernels.ref.attention_naive``; ``decode_attention_ref`` against its
JAX twin.  Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
float32 (sums taken in another order), 2e-2 in bfloat16 (the output is
rounded to bfloat16).  Inputs come from numpy seeds.  The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATTN_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, softcap (test_kernels.py:16-26)
    (1, 4, 4, 64, 64, 32, True, None, None),
    (2, 8, 2, 128, 128, 64, True, None, None),
    (1, 4, 1, 96, 96, 32, True, None, None),
    (1, 4, 2, 96, 96, 32, True, 32, None),
    (1, 2, 2, 64, 64, 32, True, None, 50.0),
    (1, 4, 2, 64, 64, 32, True, 16, 30.0),
    (1, 4, 1, 48, 80, 32, False, None, None),
    (2, 2, 2, 33, 65, 16, True, None, None),
    # gemma2's head_dim 256 with a window and the softcap
    (1, 4, 2, 80, 80, 256, True, 16, 50.0),
]
TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(case, seed):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_jax(case):
    causal, window, softcap = case[6:]
    q, k, v = _qkv(case, 1)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window, softcap=softcap)
    pallas = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  window=window, softcap=softcap,
                                  impl="interpret", block_q=64, block_k=64)
    naive = jref.attention_naive(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), _np(naive), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_naive_matches_jax(case):
    causal, window, softcap = case[6:]
    q, k, v = _qkv(case, 2)
    got = tref.attention_naive(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window, softcap=softcap)
    want = jref.attention_naive(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block_k", [16, 48, 512])
def test_blocked_ref_is_independent_of_the_chunk(block_k):
    case = ATTN_CASES[3]
    q, k, v = map(torch.from_numpy, _qkv(case, 3))
    got = tref.attention_ref(q, k, v, window=32, block_k=block_k)
    want = tref.attention_naive(q, k, v, window=32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_bfloat16_matches_jax_interpret():
    case = (1, 4, 2, 64, 64, 32, True, 16, 50.0)
    q, k, v = _qkv(case, 4)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, window=16, softcap=50.0)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, window=16, softcap=50.0,
                                impl="interpret", block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2e-2,
                               rtol=2e-2)


def test_rows_that_see_no_key_give_zero():
    """Sq > Skv with a window: rows past Skv + window see nothing; the flash
    semantics (l == 0 → 0) hold in the plain version as in the Pallas one."""
    case = (1, 2, 1, 40, 10, 16, True, 5, None)
    q, k, v = _qkv(case, 5)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=5)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), window=5,
                                impl="interpret", block_q=8, block_k=8)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)
    assert not got[:, :, 16:].any()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_attention_matches_jax(dtype, softcap):
    b, hq, hkv, s, d = 3, 8, 4, 40, 16
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, hq, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    mask = np.arange(s)[None, :] < np.array([[1], [17], [40]])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jref.decode_attention_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                     jnp.asarray(mask), softcap=softcap)
    got = tref.decode_attention_ref(*(torch.from_numpy(x).to(tdt)
                                      for x in (q, k, v)),
                                    torch.from_numpy(mask), softcap=softcap)
    assert got.dtype == tdt
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


def test_decode_matches_the_last_row_of_naive():
    b, hq, hkv, s, d = 2, 4, 2, 48, 32
    q, k, v = (torch.from_numpy(x) for x in
               _qkv((b, hq, hkv, 1, s, d), 7))
    full = tref.attention_naive(q, k, v, causal=False)
    dec = tref.decode_attention_ref(q[:, :, 0], k.transpose(1, 2),
                                    v.transpose(1, 2),
                                    torch.ones((b, s), dtype=torch.bool))
    np.testing.assert_allclose(dec.numpy(), full[:, :, 0].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_strided_views_give_the_contiguous_result():
    """The model passes (B, S, H, D) activations viewed as (B, H, S, D)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(ATTN_CASES[1], 8))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    np.testing.assert_allclose(tops.flash_attention(*views).numpy(),
                               tops.flash_attention(q, k, v).numpy(),
                               atol=1e-6, rtol=1e-6)


def test_cpu_wrapper_runs_the_plain_version_and_books_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(ATTN_CASES[5], 9))
    before = dict(tfa.LAUNCHES)
    got = tfa.flash_attention(q, k, v, window=16, softcap=30.0)
    want = tref.attention_ref(q, k, v, window=16, softcap=30.0)
    assert torch.equal(got, want)
    assert dict(tfa.LAUNCHES) == before


@pytest.mark.parametrize("bad", [
    dict(d=0), dict(d=257), dict(dtype=torch.float16), dict(hkv=3),
    dict(window=-1), dict(softcap=0.0)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    d, hkv = bad.get("d", 16), bad.get("hkv", 2)
    dt = bad.get("dtype", torch.float32)
    q = torch.zeros((1, 4, 8, d), dtype=dt)
    k = torch.zeros((1, hkv, 8, d), dtype=dt)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, k, window=bad.get("window"),
                            softcap=bad.get("softcap"))


def test_impl_dispatch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(ATTN_CASES[0], 10))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, impl="pallas")
    assert torch.equal(tops.flash_attention(q, k, v, impl="ref"),
                       tops.flash_attention(q, k, v, impl="auto"))
