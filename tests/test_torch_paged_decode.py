"""Port parity: K8's plain version (paged decode attention over Roomy pages)
against the JAX package's Pallas kernel in interpret mode and against its
gather oracle, on the CPU.

Every case draws its inputs from a numpy seed: pages in a SHUFFLED
physical order with spare pages, so the table is honoured and not assumed
to be the identity.  Float32 within atol = rtol = 2e-5, the reference's
own tolerance (``tests/test_kernels.py:396-427``): the same float32
products summed in another order.  The lengths cover 1, a whole page, a
page and one, the whole table, 0 and random ones; a row of length 0 gives
0 in both the port and the interpret kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode_attention as jpaged
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import ref as tref

TOL = dict(atol=2e-5, rtol=2e-5)

CASES = [  # b, hq, kvh, ps, pps, hd, softcap
    # the reference's own cases (tests/test_kernels.py:402-406)
    (2, 4, 2, 16, 4, 32, None),
    (3, 6, 2, 8, 5, 16, 30.0),
    (1, 4, 4, 16, 3, 32, None),
    # g = 1 (minicpm's MHA), 2 (gemma2, softcap 50), 6 (nemotron) and 48
    # (granite's MQA), at head_dims 64 and 128
    (5, 4, 4, 8, 4, 64, None),
    (5, 4, 2, 16, 3, 128, 50.0),
    (5, 12, 2, 8, 4, 128, None),
    (5, 12, 2, 16, 3, 64, 30.0),
    (5, 48, 1, 8, 4, 128, 50.0),
    (5, 48, 1, 16, 2, 64, None),
]


def _lengths(b, ps, pps, rng):
    """1, ps, ps + 1, pps·ps and 0 first, then random ones in [1, pps·ps]."""
    fixed = [1, ps, ps + 1, pps * ps, 0]
    out = fixed[:b] + list(rng.integers(1, pps * ps + 1, max(0, b - 5)))
    return np.asarray(out, np.int32)


def _inputs(case, seed=0, q_scale=1.0):
    b, hq, kvh, ps, pps, hd, softcap = case
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    kp = rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, kvh, hd)).astype(np.float32)
    q = (rng.standard_normal((b, hq, hd)) * q_scale).astype(np.float32)
    table = rng.permutation(num_pages)[: b * pps].reshape(b, pps)
    lengths = _lengths(b, ps, pps, rng)
    return q, kp, vp, table.astype(np.int32), lengths, softcap


def _port(q, kp, vp, table, lengths, softcap, impl="ref"):
    t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
    return ops.paged_decode_attention(*t, softcap=softcap, impl=impl)


def _gathered_oracle(q, kp, vp, table, lengths, softcap):
    """The reference's gather + ``decode_attention_ref``, the oracle its
    kernel test uses."""
    b, pps = table.shape
    _, ps, kvh, hd = kp.shape
    kf = jnp.asarray(kp)[table].reshape(b, pps * ps, kvh, hd)
    vf = jnp.asarray(vp)[table].reshape(b, pps * ps, kvh, hd)
    mask = jnp.arange(pps * ps)[None] < jnp.asarray(lengths)[:, None]
    return jref.decode_attention_ref(jnp.asarray(q), kf, vf, mask,
                                     softcap=softcap)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_matches_the_interpret_kernel(case):
    q, kp, vp, table, lengths, softcap = _inputs(case)
    want = jpaged(*(jnp.asarray(x) for x in (q, kp, vp, table, lengths)),
                  softcap=softcap, interpret=True)
    got = _port(q, kp, vp, table, lengths, softcap)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    zero = lengths == 0
    assert zero.any() == (len(lengths) >= 5)
    assert not got[torch.from_numpy(zero)].any()
    assert not np.asarray(want)[zero].any()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_matches_the_gather_oracle(case):
    """Against the reference's gather + decode_attention_ref, on rows of
    length >= 1 (at length 0 that oracle gives the uniform average, the
    kernel 0)."""
    q, kp, vp, table, lengths, softcap = _inputs(case, seed=1)
    lengths = np.maximum(lengths, 1)
    want = _gathered_oracle(q, kp, vp, table, lengths, softcap)
    got = _port(q, kp, vp, table, lengths, softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES[3:6], ids=str)
def test_softcap_matters_where_scores_are_large(case):
    """At logits of std ~30 the softcap changes the output, and the port
    still agrees with the interpret kernel with and without it."""
    q, kp, vp, table, lengths, _ = _inputs(case, seed=2, q_scale=30.0)
    outs = {}
    for softcap in (None, 20.0):
        want = jpaged(*(jnp.asarray(x) for x in (q, kp, vp, table,
                                                  lengths)),
                      softcap=softcap, interpret=True)
        outs[softcap] = _port(q, kp, vp, table, lengths, softcap)
        np.testing.assert_allclose(outs[softcap].numpy(), np.asarray(want),
                                   **TOL)
    assert float((outs[None] - outs[20.0]).abs().max()) > 0.1


def test_table_entries_past_the_length_are_never_read():
    """Garbage ids (negative, past the pool) at and past each row's last
    live page change nothing."""
    q, kp, vp, table, lengths, softcap = _inputs(CASES[5], seed=3)
    ps, pps = kp.shape[1], table.shape[1]
    bad = table.copy()
    live_pages = -(-np.minimum(lengths, pps * ps) // ps)
    for i, n in enumerate(live_pages):
        bad[i, n:] = [-7, 10 ** 6, 2 ** 31 - 1, -2 ** 31][: pps - n]
    assert (bad != table).any()
    np.testing.assert_array_equal(
        _port(q, kp, vp, bad, lengths, softcap).numpy(),
        _port(q, kp, vp, table, lengths, softcap).numpy())


def test_lengths_past_the_table_read_the_whole_table():
    """A sequence whose length ran past its pages (the Server's reused
    slot) attends over all pps·ps positions, as the gather oracle does."""
    q, kp, vp, table, lengths, softcap = _inputs(CASES[1], seed=4)
    ps, pps = kp.shape[1], table.shape[1]
    longer = lengths.copy()
    longer[-1] = pps * ps + 17
    full = lengths.copy()
    full[-1] = pps * ps
    np.testing.assert_array_equal(
        _port(q, kp, vp, table, longer, softcap).numpy(),
        _port(q, kp, vp, table, full, softcap).numpy())
    want = _gathered_oracle(q, kp, vp, table, np.maximum(longer, 1),
                            softcap)
    np.testing.assert_allclose(_port(q, kp, vp, table, longer,
                                     softcap)[-1].numpy(),
                               np.asarray(want)[-1], **TOL)


def test_bfloat16_against_the_gather_oracle():
    """bf16 inputs: the port keeps p in float32 where the oracle rounds it
    to bf16 before P·V, so the two agree within bf16's own 2e-2
    (``tests/test_kernels.py:57-58``), and the output is bf16."""
    q, kp, vp, table, lengths, softcap = _inputs(CASES[6], seed=5)
    lengths = np.maximum(lengths, 1)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, kp, vp))
    got = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                     torch.from_numpy(lengths),
                                     softcap=softcap, impl="ref")
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq, tk, tv)]
    want = _gathered_oracle(*jb, table, lengths, softcap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_the_wrapper_on_cpu_is_the_plain_version():
    q, kp, vp, table, lengths, softcap = _inputs(CASES[4], seed=6)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
    tpd.reset_launches()
    got = tpd.paged_decode_attention(*t, softcap=softcap)
    want = tref.paged_decode_attention_ref(*t, softcap=softcap,
                                           scale=1 / 128 ** 0.5)
    assert torch.equal(got, want)
    assert torch.equal(ops.paged_decode_attention(*t, softcap=softcap), want)
    assert tpd.LAUNCHES == {"paged_decode_attention": 0}


def test_cuda_impl_on_a_cpu_tensor_raises():
    q, kp, vp, table, lengths, softcap = _inputs(CASES[0])
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA tensor"):
        _port(q, kp, vp, table, lengths, softcap, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        _port(q, kp, vp, table, lengths, softcap, impl="interpret")


@pytest.mark.parametrize("bad", ["table dtype", "lengths shape", "group",
                                 "head_dim", "dtype mix", "softcap"])
def test_the_wrapper_checks_its_inputs(bad):
    q, kp, vp, table, lengths, softcap = _inputs(CASES[0])
    t = dict(zip("q k v table lengths".split(),
                 (torch.from_numpy(x) for x in (q, kp, vp, table, lengths))))
    if bad == "table dtype":
        t["table"] = t["table"].long()
    elif bad == "lengths shape":
        t["lengths"] = t["lengths"][:1]
    elif bad == "group":
        t["q"] = t["q"][:, :3]
    elif bad == "head_dim":
        t["k"] = t["k"][..., :16]
    elif bad == "dtype mix":
        t["v"] = t["v"].bfloat16()
    if bad == "softcap":
        softcap = -1.0
    with pytest.raises(ValueError):
        tpd.paged_decode_attention(*t.values(), softcap=softcap)
