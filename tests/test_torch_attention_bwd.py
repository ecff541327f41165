"""Port parity: K6's log-sum-exp output, K7 (the flash-attention
backward) and the autograd Function that joins them, against the JAX
package.

References: the Pallas forward with ``return_lse=True`` and
``flash_attention_bwd`` in interpret mode (the GQA group summed as
``tests/test_kernels.py:367-369`` sums it), and ``jax.grad`` of
``repro.kernels.ops.flash_attention(impl="interpret")``.  The port's
functions run their plain versions here (CPU tensors).  Tolerances: the
forward output and LSE within 2e-5 (float32 sums in another order, as
``tests/test_torch_attention.py`` holds the forward); gradients within
atol = rtol = 3e-4, the reference's own tolerance for its backward
(``tests/test_kernels.py:371-372``).  Inputs come from numpy seeds.  The
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jfab
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BWD_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, softcap
    # tests/test_kernels.py:332-339
    (1, 2, 2, 64, 64, 32, True, None, None),
    (1, 4, 2, 64, 64, 32, True, None, None),       # GQA group sum
    (1, 2, 2, 96, 96, 16, True, 32, None),         # window, unaligned
    (1, 2, 2, 64, 64, 32, True, None, 30.0),       # softcap derivative
    (1, 2, 1, 48, 80, 32, False, None, None),      # Sq != Skv, MQA
    # rows past Skv + window see no key; the smoke config's head_dim 12
    (1, 4, 2, 40, 10, 12, True, 5, 50.0),
]
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=3e-4, rtol=3e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed):
    """q, k, v, dO as float32 numpy arrays."""
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


def _jax_fwd_bwd(case, q, k, v, do):
    """The Pallas forward (out, lse) and backward (dq, group-summed dk, dv)
    in interpret mode."""
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    kw = dict(causal=causal, window=window, softcap=softcap, block_q=32,
              block_k=32, interpret=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jfa(jq, jk, jv, return_lse=True, **kw)
    dq, dk, dv = jfab(jq, jk, jv, o, lse, jdo, **kw)
    g = hq // hkv
    dk = dk.reshape(b, hkv, g, skv, d).sum(2)
    dv = dv.reshape(b, hkv, g, skv, d).sum(2)
    return [np.asarray(x, np.float32) for x in (o, lse, dq, dk, dv)]


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_versions_match_jax_interpret(case):
    causal, window, softcap = case[6:]
    q, k, v, do = _inputs(case, 1)
    o_j, lse_j, dq_j, dk_j, dv_j = _jax_fwd_bwd(case, q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = tref.attention_lse_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.numpy(), o_j, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **FWD_TOL)
    dq, dk, dv = tref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    assert dq.shape == tq.shape and dk.shape == tk.shape == dv.shape
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, **BWD_TOL)


def test_rows_that_see_no_key_get_lse_neg_inf_and_no_gradient():
    case = BWD_CASES[-1]          # rows past 10 keys + window 5 see nothing
    q, k, v, do = map(torch.from_numpy, _inputs(case, 2))
    kw = dict(window=5, softcap=50.0)
    o, lse = tref.attention_lse_ref(q, k, v, **kw)
    assert (lse[:, :, 15:] == -1e30).all() and (lse[:, :, :15] > -1e3).all()
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    assert not dq[:, :, 15:].any() and dq[:, :, :15].abs().sum() > 0


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[2], BWD_CASES[3],
                                  BWD_CASES[5]])
def test_autograd_matches_jax_grad_of_the_kernel_pair(case):
    """The gradient through ``ops.flash_attention`` (the autograd Function,
    plain versions on the CPU) against jax.grad through the reference's
    custom_vjp in interpret mode and torch.autograd of attention_naive,
    as tests/test_kernels.py:374-393 holds the reference."""
    causal, window, softcap = case[6:]
    q, k, v, do = _inputs(case, 3)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def f_kernel(q, k, v):
        o = jops.flash_attention(q, k, v, impl="interpret", block_q=32,
                                 block_k=32, **kw)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))
    want = jax.grad(f_kernel, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(),
                              (tq, tk, tv))
    naive = torch.autograd.grad(
        (tref.attention_naive(tq, tk, tv, **kw) * torch.from_numpy(do)).sum(),
        (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    if case[3] > case[4] + (window or case[3]):
        return      # naive gives a row that sees no key the uniform average
    for g, n in zip(got, naive):
        np.testing.assert_allclose(g.numpy(), n.numpy(), **BWD_TOL)


def test_autograd_in_bfloat16_runs_through_the_plain_versions():
    case = BWD_CASES[3]
    q, k, v, do = _inputs(case, 4)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_(True)
                  for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, softcap=30.0)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).bfloat16())
    want = tref.flash_attention_bwd_ref(
        *(x.detach() for x in (tq, tk, tv)), *tref.attention_lse_ref(
            tq.detach(), tk.detach(), tv.detach(), softcap=30.0),
        torch.from_numpy(do).bfloat16(), softcap=30.0)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


class _Spy:
    """Records the ``return_lse`` of each call of K6's wrapper."""

    def __init__(self, monkeypatch):
        self.calls, self.orig = [], tfa.flash_attention
        monkeypatch.setattr(tops._fa, "flash_attention", self)

    def __call__(self, *a, **kw):
        self.calls.append(kw.get("return_lse", False))
        return self.orig(*a, **kw)


def test_forward_without_grad_takes_the_lse_less_route(monkeypatch):
    spy = _Spy(monkeypatch)
    q, k, v, _ = map(torch.from_numpy, _inputs(BWD_CASES[1], 5))
    tops.flash_attention(q, k, v)                           # no grad wanted
    with torch.no_grad():
        tops.flash_attention(q.requires_grad_(True), k, v)  # grad mode off
    tops.flash_attention(q, k, v)                           # grad wanted
    assert spy.calls == [False, False, True]
    tops.flash_attention(q, k, v, impl="ref")               # plain versions
    assert len(spy.calls) == 3


def test_impl_dispatch_with_grad():
    q, k, v, _ = (torch.from_numpy(x).requires_grad_(True)
                  for x in _inputs(BWD_CASES[0], 6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, impl="interpret")
    grads = [torch.autograd.grad(tops.flash_attention(q, k, v, impl=i).sum(),
                                 (q, k, v)) for i in ("auto", "ref")]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cpu_wrappers_run_the_plain_versions_and_book_no_launch():
    case = BWD_CASES[2]
    q, k, v, do = map(torch.from_numpy, _inputs(case, 7))
    before = dict(tfa.LAUNCHES)
    o, lse = tfa.flash_attention(q, k, v, window=32, return_lse=True)
    o_r, lse_r = tref.attention_lse_ref(q, k, v, window=32)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    got = tfab.flash_attention_bwd(q, k, v, o, lse, do, window=32)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(tfa.LAUNCHES) == before


@pytest.mark.parametrize("bad", ["lse_dtype", "lse_shape", "o_dtype",
                                 "do_shape", "hkv"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, do = map(torch.from_numpy, _inputs(BWD_CASES[1], 8))
    o, lse = tref.attention_lse_ref(q, k, v)
    if bad == "lse_dtype":
        lse = lse.double()
    elif bad == "lse_shape":
        lse = lse[..., :-1]
    elif bad == "o_dtype":
        o = o.bfloat16()
    elif bad == "do_shape":
        do = do[:, :, :-1]
    else:
        k, v = k[:, :1].expand(1, 3, 64, 32), v[:, :1].expand(1, 3, 64, 32)
    with pytest.raises(ValueError):
        tfab.flash_attention_bwd(q, k, v, o, lse, do)


def test_naive_reference_is_the_jax_twin():
    """The port's attention_naive, the oracle-of-the-oracle above, is the
    reference's on every case, rows that see no key included."""
    for i, case in enumerate(BWD_CASES):
        causal, window, softcap = case[6:]
        q, k, v, _ = _inputs(case, 9 + i)
        got = tref.attention_naive(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window,
                                   softcap=softcap)
        want = jref.attention_naive(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window,
                                    softcap=softcap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
