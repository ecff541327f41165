"""Port parity: the dense configs nemotron-4-15b (GQA 2, squared-ReLU
non-gated MLP, untied LM head), minicpm-2b (MHA, gated SiLU) and
granite-34b (MQA) against the JAX package, at their SMOKE sizes in
float32.

The reference's params cross over with ``convert.lm_params_from_jax`` (the
two packages draw different numbers from one seed).  Tolerance atol = rtol
= 1e-4 for layers, hidden states, logits and caches (float32 sums taken in
another order); the Server must give identical greedy tokens; port
prefill-then-decode ≡ port stepwise decode within 2e-3, as
``tests/test_models.py:171-200`` holds the reference.  Decode runs K8's
plain version on every layer of these archs (none has a window), where
the reference gathers the cache for ``decode_attention_ref``.  Inputs come
from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.runtime import Request as JRequest
from repro.runtime import Server as JServer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import paged_decode as tpd
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, lm
from repro_torch.runtime import Request, Server

ARCHS = ["nemotron-4-15b", "minicpm-2b", "granite-34b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 20
# The reference's own param_count of each FULL config.
PARAMS = {"nemotron-4-15b": 15_628_376_064, "minicpm-2b": 2_724_880_896,
          "granite-34b": 46_947_932_160}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    """(jax cfg, port cfg, jax params, port params) of ``arch``'s SMOKE."""
    if arch not in _MODELS:
        jcfg = jget_config(arch, smoke=True).replace(kernels="ref")
        cfg = get_config(arch, smoke=True)
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                        "cpu")
        _MODELS[arch] = (jcfg, cfg, jp, tp)
    return _MODELS[arch]


@pytest.fixture(params=ARCHS)
def model(request):
    return _model(request.param)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    jin = {"tokens": jnp.asarray(toks[:, :S]), "positions": jnp.asarray(pos)}
    tin = {"tokens": torch.from_numpy(toks[:, :S]).long(),
           "positions": torch.from_numpy(pos)}
    return toks, jin, tin


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_the_reference(arch):
    for smoke in (False, True):
        j, t = jget_config(arch, smoke), get_config(arch, smoke)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "mlp_act", "mlp_gated",
                  "tie_embeddings", "local_window", "attn_softcap",
                  "logit_softcap", "post_norm", "scale_embeddings", "dtype",
                  "rms_eps", "rope_theta", "vocab_padded"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_count() == j.param_count()
    assert get_config(arch).param_count() == PARAMS[arch]


def test_init_params_shapes_and_the_head_leaf(model):
    jcfg, cfg, jp, tp = model
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert jax.tree.map(np.shape, jax.tree.map(np.asarray, tp)) == \
        jax.tree.map(np.shape, mine)
    assert ("head" in mine["embed"]) == (not cfg.tie_embeddings)
    assert ("gate" in mine["blocks"][0]["mlp"]) == cfg.mlp_gated
    n = sum(t.numel() for t in jax.tree.leaves(mine))
    # the reference counts the padded vocab rows out, and so does its count
    pad = (cfg.vocab_padded - cfg.vocab_size) * cfg.d_model
    assert n == cfg.param_count() + pad * (1 if cfg.tie_embeddings else 2)
    if not cfg.tie_embeddings:
        head = mine["embed"]["head"]
        assert head.shape == (cfg.d_model, cfg.vocab_padded)
        assert float(head.abs().max()) <= 2 / cfg.d_model ** 0.5
        assert torch.equal(tp["embed"]["head"],
                           torch.from_numpy(np.array(jp["embed"]["head"])))


# -------------------------------------------------------------- layers

def test_mlp_and_lm_head_match_jax(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32) * 3
    jmlp = jax.tree.map(lambda a: a[1], jp["blocks"]["mlp"])
    _close(layers.mlp(tp["blocks"][1]["mlp"], torch.from_numpy(x), cfg),
           jlayers.mlp(jmlp, jnp.asarray(x), jcfg))
    got = layers.lm_head(tp["embed"], torch.from_numpy(x), cfg)
    assert got.shape == (2, 5, cfg.vocab_padded)
    _close(got, jlayers.lm_head(jp["embed"], jnp.asarray(x), jcfg))
    assert bool((got[..., cfg.vocab_size:] == -1e30).all())


# --------------------------------------------------------------- model

def test_forward_hidden_and_logits_match_jax(model):
    jcfg, cfg, jp, tp = model
    _, jin, tin = _batch(cfg)
    h = lm.forward_hidden(tp, tin, cfg)
    jh = jlm.forward_hidden(jp, jin, jcfg)
    _close(h, jh)
    _close(lm.logits_fn(tp, h, cfg), jlm.logits_fn(jp, jh, jcfg))


def test_prefill_caches_and_decode_match_jax(model):
    jcfg, cfg, jp, tp = model
    toks, jin, tin = _batch(cfg, seed=1)
    jl, jc = jlm.prefill(jp, jin, jcfg, max_len=64)
    tl, tc = lm.prefill(tp, tin, cfg, max_len=64)
    assert tl.shape == (B, 1, cfg.vocab_padded)
    _close(tl, jl)
    want_c = convert.lm_caches_from_jax(jc, cfg, "cpu")
    assert len(tc["kv"]) == len(want_c["kv"]) == cfg.n_layers
    for got, want in zip(tc["kv"], want_c["kv"]):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g, w.numpy())
    nxt = toks[:, S:S + 1]
    zeros = np.zeros((B, 1), np.int32)
    jd, jc2 = jlm.decode_step(jp, {"tokens": jnp.asarray(nxt),
                                   "positions": jnp.asarray(zeros)}, jc, jcfg)
    tin1 = {"tokens": torch.from_numpy(nxt).long(),
            "positions": torch.from_numpy(zeros)}
    tpd.reset_launches()
    td, tc2 = lm.decode_step(tp, tin1, tc, cfg)
    assert tpd.LAUNCHES["paged_decode_attention"] == 0     # CPU: plain
    _close(td, jd)
    for got, want in zip(tc2["kv"], convert.lm_caches_from_jax(
            jc2, cfg, "cpu")["kv"]):
        for g, w in zip(got, want):
            _close(g, w.numpy())
    td2, _ = lm.decode_step(tp, tin1, want_c, cfg)           # carried across
    _close(td2, jd)
    assert [int(c.lengths[0]) for c in tc["kv"]] == [S] * cfg.n_layers


def test_donated_decode_step_equals_the_out_of_place_one(model):
    """``donate=True`` writes the new rows into the pages passed in and
    gives the same logits and caches."""
    _, cfg, _, tp = model
    toks, _, tin = _batch(cfg, seed=2)
    _, caches = lm.prefill(tp, tin, cfg, max_len=64)
    step = {"tokens": torch.from_numpy(toks[:, S:S + 1]).long(),
            "positions": torch.zeros((B, 1), dtype=torch.long)}
    lg_a, new_a = lm.decode_step(tp, step, caches, cfg)
    pages = [c.k_pages.clone() for c in caches["kv"]]
    lg_b, new_b = lm.decode_step(tp, step, caches, cfg, donate=True)
    assert torch.equal(lg_a, lg_b)
    for a, b, c, old in zip(new_a["kv"], new_b["kv"], caches["kv"], pages):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert b.k_pages.data_ptr() == c.k_pages.data_ptr()
        assert not torch.equal(c.k_pages, old)               # written in place
        assert torch.equal(c.lengths, torch.full((B,), S, dtype=torch.int32))


def test_prefill_then_decode_equals_stepwise_decode(model):
    _, cfg, _, tp = model
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


# -------------------------------------------------------------- server

def test_server_tokens_identical_to_jax(model):
    """Six requests on four slots: two slots are freed and reused as they
    stand (their lengths run on), so K8's plain version reads through the
    page table past a reused slot's earlier tokens, as the reference's
    gather does."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(6)]
    js = JServer(jcfg, jp, max_batch=4, max_len=256)
    want = js.run([JRequest(rid=i, prompt=p, max_new=12)
                   for i, p in enumerate(prompts)])
    ts = Server(cfg, tp, max_batch=4, max_len=256, device="cpu")
    got = ts.run([Request(rid=i, prompt=p, max_new=12)
                  for i, p in enumerate(prompts)])
    assert got == want
    assert ts.stats == js.stats == {"prefills": 6, "decode_steps": 22,
                                    "tokens_out": 66}


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    outs, server, _ = tserve.main(["--arch", arch, "--smoke", "--device",
                                   "cpu", "--requests", "2", "--max-new",
                                   "3"])
    assert sorted(outs) == [0, 1] and all(len(v) == 3 for v in outs.values())
    vocab = get_config(arch, smoke=True).vocab_size
    assert all(0 <= t < vocab for v in outs.values() for t in v)
    assert server.stats == {"prefills": 2, "decode_steps": 2, "tokens_out": 4}
    out = capsys.readouterr().out
    assert "req 1:" in out and "tok/s on cpu" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_default_device_raises_without_a_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = get_config(arch, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", arch, "--smoke"])
