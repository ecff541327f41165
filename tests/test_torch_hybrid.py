"""Port parity: the hybrid family (zamba2-1.2b: mamba2 blocks, one shared
attention + MLP block after every ``shared_attn_every``-th of them, a KV
cache for each application) against the JAX package, at the SMOKE size in
float32 (5 layers, the shared block after layers 2 and 4).

The reference's params cross over with ``convert.lm_params_from_jax``.  At
the init's ``dt_bias`` of -4.6 and conv weights of 0.1 the scan state adds
a few percent to mamba2's output; both packages get ``dt_bias`` -1 and the
conv weights scaled by 5, where the state carries it.  Bit for bit:
``_hybrid_segments`` and ``n_shared_applications`` over several
(n_layers, shared_attn_every) pairs, the config's ``param_count``.
Within atol = rtol = 1e-4: ``mamba2_ssd`` (against the reference's and
against the sequential scan), ``mamba2`` with the SSD form on and off (off:
the head scalars broadcast into K9's form, its plain version here),
``mamba2_prefill``'s states, ``mamba2_decode``, forward, prefill logits and
both kinds of cache, decode.  The Server's greedy tokens are identical to
JAX's, with freed slots reused; port prefill-then-decode ≡ port stepwise
decode within 2e-3, as ``tests/test_models.py:171-200`` holds the
reference.  Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.runtime import Request as JRequest
from repro.runtime import Server as JServer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm, ssm
from repro_torch.runtime import Request, Server

ARCH = "zamba2-1.2b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 20
DT_BIAS = -1.0
CONV_SCALE = 5.0
CHUNK = 8                     # SMOKE's SSD chunk: 20 steps are 3 chunks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, smoke=True).replace(kernels="ref",
                                                  ssd_chunk=CHUNK)
    cfg = get_config(ARCH, smoke=True).replace(ssd_chunk=CHUNK)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    mamba = jp["blocks"]["mamba"]
    mamba["dt_bias"] = jnp.full_like(mamba["dt_bias"], DT_BIAS)
    mamba["conv_w"] = mamba["conv_w"] * CONV_SCALE
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(params=[True, False], ids=["ssd", "k9_form"])
def ssd(request):
    return request.param


def _cfgs(model, ssd):
    jcfg, cfg = model[:2]
    return (jcfg.replace(mamba2_use_ssd=ssd), cfg.replace(mamba2_use_ssd=ssd))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 127, (B, S + 1)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    jin = {"tokens": jnp.asarray(toks[:, :S]), "positions": jnp.asarray(pos)}
    tin = {"tokens": torch.from_numpy(toks[:, :S]).long(),
           "positions": torch.from_numpy(pos)}
    return toks, jin, tin


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _layer(jp, tp, i):
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["mamba"]),
            tp["blocks"][i]["mamba"])


def _x(cfg, b=2, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model), np.float32)


# ------------------------------------------------------------- configs

def test_config_and_param_count_match_the_reference():
    for smoke in (False, True):
        j, t = jget_config(ARCH, smoke), get_config(ARCH, smoke)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "ssm_state", "ssm_conv",
                  "ssm_expand", "mamba_version", "mamba2_head_dim",
                  "mamba2_use_ssd", "ssd_chunk", "shared_attn_every",
                  "mlp_act", "mlp_gated", "tie_embeddings", "dtype",
                  "rms_eps", "rope_theta", "d_inner", "vocab_padded",
                  "attention_free", "is_moe"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert get_config(ARCH).param_count() == 1_104_852_736


@pytest.mark.parametrize("n_layers,every", [
    (38, 6), (5, 2), (6, 6), (7, 3), (4, 0), (1, 1), (12, 5), (3, 4)])
def test_hybrid_segments_match_the_reference(n_layers, every):
    j = jget_config(ARCH, smoke=True).replace(n_layers=n_layers,
                                               shared_attn_every=every)
    t = get_config(ARCH, smoke=True).replace(n_layers=n_layers,
                                              shared_attn_every=every)
    assert lm._hybrid_segments(t) == jlm._hybrid_segments(j)
    assert lm.n_shared_applications(t) == jlm.n_shared_applications(j)


def test_the_full_config_runs_the_shared_block_six_times():
    cfg = get_config(ARCH)
    assert lm.n_shared_applications(cfg) == 6
    assert lm._hybrid_segments(cfg) == [(i, i + 6, True)
                                        for i in range(0, 36, 6)] + [
                                            (36, 38, False)]


def test_init_params_layout_matches_the_reference(model):
    """The port's own init has the reference's leaves and shapes: mamba2
    blocks (conv over d_inner + 2N channels, a scalar a head) and one
    shared transformer block."""
    jcfg, cfg, jp, tp = model
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = lambda p: jax.tree.map(np.shape, jax.tree.map(  # noqa: E731
        np.asarray, p))
    assert shapes(tp) == shapes(mine)
    assert sorted(mine) == ["blocks", "embed", "final_norm", "shared"]
    assert sorted(mine["shared"]) == ["attn", "ln1", "ln2", "mlp"]
    blk = mine["blocks"][1]["mamba"]
    di, n = cfg.d_inner, cfg.ssm_state
    heads = di // cfg.mamba2_head_dim
    assert blk["in_proj"].shape == (cfg.d_model, 2 * di + 2 * n + heads)
    assert blk["conv_w"].shape == (cfg.ssm_conv, di + 2 * n)
    torch.testing.assert_close(blk["a_log"], torch.from_numpy(
        np.array(jnp.log(jnp.linspace(1.0, 16.0, heads)))))
    assert bool((blk["dt_bias"] == -4.6).all()) and not blk["norm"].any()
    # the reference's count: two norms a block where a mamba block has one,
    # and neither conv_b nor dt_bias; the vocab's pad rows left out
    n_all = sum(t.numel() for t in jax.tree.leaves(mine))
    assert n_all == cfg.param_count() + (cfg.vocab_padded - cfg.vocab_size) \
        * cfg.d_model + cfg.n_layers * (di + 2 * n + heads - cfg.d_model)
    for k, v in tp["shared"]["attn"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jp["shared"]["attn"][k]))


# -------------------------------------------------------------- mamba2

@pytest.mark.parametrize("shape", [
    (2, 24, 3, 4, 5, 8),      # three whole chunks
    (1, 21, 2, 8, 4, 8),      # a ragged last chunk
    (2, 5, 2, 4, 3, 8),       # shorter than a chunk
    (1, 64, 4, 16, 8, 16)])   # SMOKE's heads and state
def test_mamba2_ssd_matches_jax_and_the_sequential_scan(shape):
    bs, seq, h, p, n, chunk = shape
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((bs, seq, h, p), np.float32)
    dt = np.abs(rng.standard_normal((bs, seq, h), np.float32)) * 0.5
    a = -np.abs(rng.standard_normal(h, np.float32)) - 0.1
    b, c = (rng.standard_normal((bs, seq, n), np.float32) for _ in range(2))
    d = rng.standard_normal(h, np.float32)
    h0 = rng.standard_normal((bs, h, p, n), np.float32)
    for init in (None, h0):
        jy, jh = jref.mamba2_ssd(*(jnp.asarray(t) for t in (x, dt, a, b, c,
                                                            d)),
                                 chunk=chunk, h0=None if init is None
                                 else jnp.asarray(init))
        ty, th = R.mamba2_ssd(*(torch.from_numpy(t) for t in (x, dt, a, b, c,
                                                              d)),
                              chunk=chunk, h0=None if init is None
                              else torch.from_numpy(init))
        assert ty.shape == x.shape and th.shape == (bs, h, p, n)
        assert ty.dtype == th.dtype == torch.float32
        _close(ty, jy)
        _close(th, jh)
    # the same map as the selective scan with the head scalars broadcast
    di = h * p
    sy, sh = R.mamba_scan_seq_stateful(
        torch.from_numpy(x.reshape(bs, seq, di)),
        torch.from_numpy(np.repeat(dt, p, axis=-1)),
        torch.from_numpy(np.repeat(a, p)[:, None] * np.ones((1, n),
                                                            np.float32)),
        torch.from_numpy(b), torch.from_numpy(c),
        torch.from_numpy(np.repeat(d, p)))
    y0, h_last = R.mamba2_ssd(*(torch.from_numpy(t) for t in (x, dt, a, b, c,
                                                              d)),
                              chunk=chunk)
    _close(y0.reshape(bs, seq, di), sy.numpy())
    _close(h_last.reshape(bs, di, n), sh.numpy())


def test_mamba2_matches_jax(model, ssd):
    jcfg, cfg = _cfgs(model, ssd)
    jm, tm = _layer(model[2], model[3], 1)
    x = _x(cfg, seed=1)
    _close(ssm.mamba2(tm, torch.from_numpy(x), cfg),
           jssm.mamba2(jm, jnp.asarray(x), jcfg))


def test_mamba2_prefill_states_match_jax(model, ssd):
    jcfg, cfg = _cfgs(model, ssd)
    jm, tm = _layer(model[2], model[3], 2)
    for s in (S, 2):                            # 2 < conv - 1: a padded tail
        x = _x(cfg, s=s, seed=2)
        jout, jst = jssm.mamba2_prefill(jm, jnp.asarray(x), jcfg)
        out, st = ssm.mamba2_prefill(tm, torch.from_numpy(x), cfg)
        _close(out, jout)
        assert st.conv.shape == (2, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)
        assert st.h.shape == (2, cfg.d_inner, cfg.ssm_state)
        assert st.h.dtype == torch.float32
        _close(st.conv, jst.conv)
        _close(st.h, jst.h)


def test_mamba2_decode_matches_jax(model):
    jcfg, cfg, jp, tp = model
    jm, tm = _layer(jp, tp, 3)
    _, jst = jssm.mamba2_prefill(jm, jnp.asarray(_x(cfg, seed=3)), jcfg)
    _, st = ssm.mamba2_prefill(tm, torch.from_numpy(_x(cfg, seed=3)), cfg)
    x1 = _x(cfg, s=1, seed=4)
    jout, jst2 = jssm.mamba2_decode(jm, jnp.asarray(x1), jst, jcfg)
    out, st2 = ssm.mamba2_decode(tm, torch.from_numpy(x1), st, cfg)
    assert out.shape == (2, 1, cfg.d_model)
    _close(out, jout)
    _close(st2.conv, jst2.conv)
    _close(st2.h, jst2.h)
    empty = ssm.init_ssm_state(cfg, 2, "cpu", version=2)
    jempty = jssm.init_ssm_state(jcfg, 2, 2)
    assert empty.conv.shape == jempty.conv.shape
    assert empty.h.shape == jempty.h.shape and not empty.h.any()


def test_the_state_carries_the_output(model):
    """A decode from a zeroed state lands far outside the tolerance: the
    checks above see the state."""
    _, cfg, _, tp = model
    tm = tp["blocks"][0]["mamba"]
    _, st = ssm.mamba2_prefill(tm, torch.from_numpy(_x(cfg, seed=5)), cfg)
    x1 = torch.from_numpy(_x(cfg, s=1, seed=6))
    good, _ = ssm.mamba2_decode(tm, x1, st, cfg)
    bad, _ = ssm.mamba2_decode(tm, x1, st._replace(h=torch.zeros_like(st.h)),
                               cfg)
    assert float((good - bad).abs().max()) > 100 * TOL["atol"]


# --------------------------------------------------------------- model

def test_forward_hidden_and_logits_match_jax(model, batch, ssd):
    jcfg, cfg = _cfgs(model, ssd)
    jp, tp = model[2:]
    h = lm.forward_hidden(tp, batch[2], cfg)
    jh = jlm.forward_hidden(jp, batch[1], jcfg)
    _close(h, jh)
    _close(lm.logits_fn(tp, h, cfg), jlm.logits_fn(jp, jh, jcfg))


def test_prefill_caches_and_decode_match_jax(model, batch, ssd):
    jcfg, cfg = _cfgs(model, ssd)
    jp, tp = model[2:]
    toks, jin, tin = batch
    jl, jc = jlm.prefill(jp, jin, jcfg, max_len=64)
    tl, tc = lm.prefill(tp, tin, cfg, max_len=64)
    assert tl.shape == (B, 1, cfg.vocab_padded)
    _close(tl, jl)
    want = convert.lm_caches_from_jax(jc, cfg, "cpu")
    assert sorted(tc) == sorted(want) == ["kv", "ssm"]
    assert len(tc["ssm"]) == cfg.n_layers
    assert len(tc["kv"]) == lm.n_shared_applications(cfg) == 2
    for got, exp in zip(tc["ssm"] + tc["kv"], want["ssm"] + want["kv"]):
        for g, w in zip(got, exp):
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g, w.numpy())
    nxt = toks[:, S:S + 1]
    zeros = np.zeros((B, 1), np.int32)
    jd, jc2 = jlm.decode_step(jp, {"tokens": jnp.asarray(nxt),
                                   "positions": jnp.asarray(zeros)}, jc, jcfg)
    td, tc2 = lm.decode_step(tp, {"tokens": torch.from_numpy(nxt).long(),
                                  "positions": torch.from_numpy(zeros)},
                             tc, cfg)
    _close(td, jd)
    want2 = convert.lm_caches_from_jax(jc2, cfg, "cpu")
    for got, exp in zip(tc2["ssm"] + tc2["kv"], want2["ssm"] + want2["kv"]):
        for g, w in zip(got, exp):
            _close(g, w.numpy())
    assert [int(c.lengths[0]) for c in tc2["kv"]] == [S + 1] * 2
    td2, _ = lm.decode_step(tp, {"tokens": torch.from_numpy(nxt).long(),
                                 "positions": torch.from_numpy(zeros)},
                            want, cfg)                     # carried across
    _close(td2, jd)


def test_make_cache_matches_the_reference_layout(model):
    jcfg, cfg = model[:2]
    got = lm.make_cache(cfg, 3, 200, device="cpu")
    want = convert.lm_caches_from_jax(jlm.make_cache(jcfg, 3, 200), cfg,
                                      "cpu")
    assert sorted(got) == ["kv", "ssm"]
    for g_all, w_all in ((got["ssm"], want["ssm"]), (got["kv"], want["kv"])):
        assert len(g_all) == len(w_all)
        for g, w in zip(g_all, w_all):
            for a, b in zip(g, w):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert torch.equal(a, b)


def test_prefill_then_decode_equals_stepwise_decode(model, ssd):
    _, cfg = _cfgs(model, ssd)
    tp = model[3]
    b, s = 2, 10
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 1)))
    pos = torch.arange(s)[None].repeat(b, 1)
    _, caches = lm.prefill(tp, {"tokens": toks[:, :s], "positions": pos},
                           cfg, max_len=32)
    lg_a, _ = lm.decode_step(tp, {"tokens": toks[:, s:s + 1],
                                  "positions": pos[:, :1]}, caches, cfg)
    caches2 = lm.make_cache(cfg, b, max_len=32, device="cpu")
    for t in range(s + 1):
        lg_b, caches2 = lm.decode_step(tp, {"tokens": toks[:, t:t + 1],
                                            "positions": pos[:, :1]},
                                       caches2, cfg)
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), atol=2e-3,
                               rtol=2e-3)


def test_donated_decode_writes_each_applications_pages(model, batch):
    _, cfg, _, tp = model
    _, caches = lm.prefill(tp, batch[2], cfg, max_len=64)
    step = {"tokens": torch.from_numpy(batch[0][:, S:S + 1]).long(),
            "positions": torch.zeros((B, 1), dtype=torch.long)}
    lg_a, new_a = lm.decode_step(tp, step, caches, cfg)
    lg_b, new_b = lm.decode_step(tp, step, caches, cfg, donate=True)
    assert torch.equal(lg_a, lg_b)
    for a, b, c in zip(new_a["kv"], new_b["kv"], caches["kv"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert b.k_pages.data_ptr() == c.k_pages.data_ptr()


# -------------------------------------------------------------- server

def test_server_tokens_identical_to_jax(model):
    """Six requests over four slots: two slots are freed and reused
    mid-run, so the per-slot merge of the SSM states and of the shared
    block's paged caches, together, shows."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(6)]
    max_new = [12, 5, 12, 7, 9, 12]
    js = JServer(jcfg, jp, max_batch=4, max_len=256)
    want = js.run([JRequest(rid=i, prompt=p, max_new=m)
                   for i, (p, m) in enumerate(zip(prompts, max_new))])
    ts = Server(cfg, tp, max_batch=4, max_len=256, device="cpu")
    got = ts.run([Request(rid=i, prompt=p, max_new=m)
                  for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert got == want
    assert ts.stats == js.stats
    assert ts.stats["prefills"] == 6


def test_launch_serve_smoke_on_cpu(capsys):
    outs, server, _ = tserve.main(["--arch", ARCH, "--smoke", "--device",
                                   "cpu", "--requests", "2", "--max-new",
                                   "3"])
    assert sorted(outs) == [0, 1] and all(len(v) == 3 for v in outs.values())
    assert all(0 <= t < 127 for v in outs.values() for t in v)
    assert server.stats == {"prefills": 2, "decode_steps": 2, "tokens_out": 4}
    out = capsys.readouterr().out
    assert "req 1:" in out and "tok/s on cpu" in out


def test_training_raises_naming_its_roadmap_item(model, batch):
    _, cfg, _, tp = model
    with pytest.raises(NotImplementedError, match="ROADMAP item 9.13"):
        lm.loss_fn(tp, {"inputs": batch[2], "labels": batch[2]["tokens"]},
                   cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9.13"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_entry_points_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = model[1]
    for call in (lambda: lm.init_params(cfg, 0),
                 lambda: lm.make_cache(cfg, 1, 8),
                 lambda: Server(cfg, model[3]),
                 lambda: tserve.main(["--arch", ARCH, "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
