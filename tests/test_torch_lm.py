"""Port parity: the gemma2-2b serving path of ``repro_torch`` against the
JAX package, at the SMOKE size in float32.

The reference's params cross over with ``convert.lm_params_from_jax`` (the
two packages draw different numbers from one seed).  Tolerance atol = rtol
= 1e-4 for layers, hidden states, logits and caches: float32 sums taken in
another order, over four layers.  The Server must give identical greedy
tokens; port prefill-then-decode ≡ port stepwise decode within 2e-3, as
``tests/test_models.py:171-200`` holds the reference.  Inputs come from
numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import rope as jrope
from repro.runtime import Request as JRequest
from repro.runtime import Server as JServer
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import batch_to_torch, make_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, lm, rope
from repro_torch.runtime import Request, Server

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24                      # S = 3 × the smoke window of 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("gemma2-2b", smoke=True).replace(kernels="ref")
    cfg = get_config("gemma2-2b", smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 199, (B, S + 1)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    jin = {"tokens": jnp.asarray(toks[:, :S]), "positions": jnp.asarray(pos)}
    tin = {"tokens": torch.from_numpy(toks[:, :S]).long(),
           "positions": torch.from_numpy(pos)}
    return toks, jin, tin


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------- configs

def test_config_matches_the_reference():
    for smoke in (False, True):
        j, t = jget_config("gemma2-2b", smoke), get_config("gemma2-2b", smoke)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "local_window", "attn_softcap",
                  "logit_softcap", "post_norm", "scale_embeddings", "mlp_act",
                  "dtype", "rms_eps", "rope_theta", "vocab_padded"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_count() == j.param_count()
    assert get_config("gemma2-2b").param_count() == 2_614_222_080
    assert get_config("gemma2-2b", True).vocab_padded == 256
    # all ten of the reference's archs (the two frontend stubs since 9.6)
    from repro.configs import ARCH_IDS as JARCH
    assert ARCH_IDS == ("gemma2-2b", "falcon-mamba-7b", "nemotron-4-15b",
                        "minicpm-2b", "granite-34b", "granite-moe-3b-a800m",
                        "phi3.5-moe-42b-a6.6b", "zamba2-1.2b",
                        "musicgen-medium", "qwen2-vl-2b")
    assert sorted(ARCH_IDS) == sorted(JARCH)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("family", ["moe", "hybrid", "audio", "vlm"])
def test_other_families_raise(family, model):
    """No family is refused for training or init any more: the MoE and
    hybrid families train since ROADMAP item 9.13, the frontend stubs
    (audio, vlm) since 9.6 (tests/test_torch_frontend.py), so the loss of
    each family's SMOKE arch on a pipeline batch is finite.  What still
    raises is serving a frontend stub: the Server takes token prompts
    only, as the reference's asserts."""
    arch = {"moe": "granite-moe-3b-a800m", "hybrid": "zamba2-1.2b",
            "audio": "musicgen-medium", "vlm": "qwen2-vl-2b"}[family]
    fcfg = get_config(arch, smoke=True)
    assert fcfg.family == family
    batch = batch_to_torch(make_batch(fcfg, 0, 0, 1, 8), "cpu")
    loss = lm.loss_fn(lm.init_params(fcfg, 0, device="cpu"), batch, fcfg)
    assert bool(torch.isfinite(loss))
    cfg = model[1].replace(family=family)
    if family in ("audio", "vlm"):       # dense blocks under another name
        assert len(lm.make_cache(cfg, 1, 8, device="cpu")["kv"]) == \
            cfg.n_layers
        params = lm.init_params(cfg, 0, device="cpu")
        with pytest.raises(ValueError, match="token-input"):
            Server(cfg.replace(frontend_stub=True), params, device="cpu")


# -------------------------------------------------------------- layers

def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 12), np.float32)
    pos = rng.integers(0, 5000, (2, 24)).astype(np.int32)
    _close(rope.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jrope.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


def test_rms_norm_and_mlp_match_jax(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48), np.float32) * 3
    gain = rng.standard_normal(48).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(gain), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(gain), 1e-6))
    jmlp = jax.tree.map(lambda a: a[1, 0], jp["blocks"]["mlp"])
    _close(layers.mlp(tp["blocks"][2]["mlp"], torch.from_numpy(x), cfg),
           jlayers.mlp(jmlp, jnp.asarray(x), jcfg))


def test_lm_head_masks_the_pad_rows(model):
    jcfg, cfg, jp, tp = model
    x = np.random.default_rng(3).standard_normal((2, 3, 48), np.float32) * 20
    got = layers.lm_head(tp["embed"], torch.from_numpy(x), cfg)
    assert got.shape == (2, 3, 256)
    _close(got, jlayers.lm_head(jp["embed"], jnp.asarray(x), jcfg))
    assert bool((got[..., 199:] == -1e30).all())
    assert bool((got[..., :199].abs() <= 30.0).all())       # softcap 30


def test_attention_layers_match_jax(model, batch):
    """One local and one global attention layer, with their (k, v)."""
    jcfg, cfg, jp, tp = model
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, 48), np.float32)
    for i, window in ((0, 8), (1, None)):
        jpl = jax.tree.map(lambda a: a[0, i], jp["blocks"]["attn"])
        jout, (jk, jv) = jattn.attention(jpl, jnp.asarray(x),
                                         batch[1]["positions"], jcfg,
                                         window=window, return_kv=True)
        out, (k, v) = tattn.attention(tp["blocks"][i]["attn"],
                                      torch.from_numpy(x),
                                      batch[2]["positions"], cfg,
                                      window=window, return_kv=True)
        for g, w in ((out, jout), (k, jk), (v, jv)):
            _close(g, w)


def test_init_params_shapes_and_distributions(model):
    jcfg, cfg, jp, tp = model
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert jax.tree.map(np.shape, jax.tree.map(
        np.asarray, convert.lm_params_from_jax(
            jax.tree.map(np.asarray, jp), cfg, "cpu"))) == \
        jax.tree.map(np.shape, mine)
    blk = mine["blocks"][0]
    assert not any(blk[k].any() for k in ("ln1", "ln2", "post_ln1",
                                          "post_ln2"))
    assert not mine["final_norm"].any()
    assert float(blk["mlp"]["down"].abs().max()) <= 2 / 96 ** 0.5
    assert 0.015 < float(mine["embed"]["table"].std()) < 0.025
    again = lm.init_params(cfg, 0, device="cpu")
    assert torch.equal(again["embed"]["table"], mine["embed"]["table"])
    half = lm.init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(half["blocks"][3]["attn"]["wq"],
                       mine["blocks"][3]["attn"]["wq"].bfloat16())


# --------------------------------------------------------------- model

def test_forward_hidden_matches_jax(model, batch):
    jcfg, cfg, jp, tp = model
    _close(lm.forward_hidden(tp, batch[2], cfg),
           jlm.forward_hidden(jp, batch[1], jcfg))


def test_prefill_and_decode_match_jax(model, batch):
    jcfg, cfg, jp, tp = model
    toks = batch[0]
    jl, jc = jlm.prefill(jp, batch[1], jcfg, max_len=64)
    tl, tc = lm.prefill(tp, batch[2], cfg, max_len=64)
    assert tl.shape == (B, 1, 256)
    _close(tl, jl)
    want_c = convert.lm_caches_from_jax(jc, cfg, "cpu")
    for got, want in zip(tc["kv"], want_c["kv"]):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g, w.numpy())
    nxt = toks[:, S:S + 1]
    zeros = np.zeros((B, 1), np.int32)
    jd, _ = jlm.decode_step(jp, {"tokens": jnp.asarray(nxt),
                                 "positions": jnp.asarray(zeros)}, jc, jcfg)
    tin = {"tokens": torch.from_numpy(nxt).long(),
           "positions": torch.from_numpy(zeros)}
    td, tc2 = lm.decode_step(tp, tin, tc, cfg)
    _close(td, jd)
    # the same step from the reference's own caches, carried across
    td2, _ = lm.decode_step(tp, tin, want_c, cfg)
    _close(td2, jd)
    assert [int(c.lengths[0]) for c in tc2["kv"]] == [S + 1] * 4
    assert [int(c.lengths[0]) for c in tc["kv"]] == [S] * 4   # untouched


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


def test_launch_serve_smoke_on_cpu(capsys):
    outs, server, _ = tserve.main(["--arch", "gemma2-2b", "--smoke",
                                   "--device", "cpu", "--requests", "2",
                                   "--max-new", "3"])
    assert sorted(outs) == [0, 1] and all(len(v) == 3 for v in outs.values())
    assert server.stats == {"prefills": 2, "decode_steps": 2, "tokens_out": 4}
    out = capsys.readouterr().out
    assert "req 1:" in out and "tok/s on cpu" in out


def test_default_device_raises_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = model[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, model[3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "gemma2-2b", "--smoke"])
