"""Port parity: the frontend-stub families — musicgen-medium (audio: MHA,
non-gated GELU MLP) and qwen2-vl-2b (vision: GQA 2 and M-RoPE) — against
the JAX package, at their SMOKE sizes in float32.

The inputs are embeddings (B, S, d) in place of token ids, and qwen's
positions are (B, S, 3): a text prefix that repeats one position in all
three streams, then a patch grid whose streams differ (t fixed, h and w
running), since M-RoPE equals RoPE wherever the streams agree and a wrong
band-to-stream split would pass there.  The reference's params cross over
with ``convert.lm_params_from_jax``; it runs its plain attention
(``kernels="ref"``), the port the plain versions of K6, K6-with-LSE, K7
and K8 (CPU tensors).  Tolerances: ``mrope`` within 1e-6 (float32 cos and
sin of the same angles); forward, logits, prefill caches and decode
within atol = rtol = 1e-4; the loss within rtol 1e-5 and each gradient
leaf within ‖Δ‖ ≤ 1e-4 ‖g‖; three train steps as
``tests/test_torch_train.py`` holds them; batches bit for bit.  Inputs
come from numpy seeds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.models import rope as jrope
from repro.runtime import Server as JServer
from repro.runtime import train_loop as jtrain
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import paged_decode as tpd
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm, rope
from repro_torch.runtime import Server, TrainSettings, make_train_step

ARCHS = ["musicgen-medium", "qwen2-vl-2b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 20
GRID = 4                          # qwen's patch grid: GRID x GRID after a prefix
# The reference's own param_count of each FULL config.
PARAMS = {"musicgen-medium": 1_362_249_216, "qwen2-vl-2b": 1_543_656_960}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jax cfg, port cfg, jax params, port params) of ``arch``'s SMOKE."""
    jcfg = jget_config(arch, smoke=True).replace(kernels="ref")
    cfg = get_config(arch, smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(params=ARCHS)
def model(request):
    return _model(request.param)


def grid_positions(b, s, grid=GRID, offset=0) -> np.ndarray:
    """(b, s, 3) int32: a text prefix of s − grid² tokens (one position in
    all three streams), then a grid² patch grid at temporal position p = the
    prefix length, height p + i // grid and width p + i % grid; row r is
    shifted by ``offset · r``."""
    p = s - grid * grid
    assert p >= 0
    text = np.arange(p, dtype=np.int32)
    i = np.arange(grid * grid, dtype=np.int32)
    pos = np.concatenate([
        np.stack([text] * 3, axis=1),
        np.stack([np.full_like(i, p), p + i // grid, p + i % grid], axis=1)])
    return np.stack([pos + offset * r for r in range(b)]).astype(np.int32)


def _positions(cfg, b, s):
    if cfg.mrope:
        return grid_positions(b, s, grid=min(GRID, int(s ** 0.5)), offset=3)
    return np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))


def _inputs(cfg, b, s, seed):
    """(embeds (b, s + 1, d) float32, the first s as JAX and port inputs)."""
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((b, s + 1, cfg.d_model)) * 0.5).astype(
        np.float32)
    pos = _positions(cfg, b, s)
    jin = {"embeds": jnp.asarray(emb[:, :s]), "positions": jnp.asarray(pos)}
    tin = {"embeds": torch.from_numpy(emb[:, :s]),
           "positions": torch.from_numpy(pos)}
    return emb, jin, tin


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_the_reference(arch):
    for smoke in (False, True):
        j, t = jget_config(arch, smoke), get_config(arch, smoke)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "vocab_size", "mlp_act",
                  "mlp_gated", "tie_embeddings", "frontend_stub", "mrope",
                  "mrope_sections", "rope_theta", "dtype", "rms_eps",
                  "vocab_padded"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_count() == j.param_count()
        # the count takes the table once for a frontend stub, tied or not
        assert (t.replace(tie_embeddings=False).param_count()
                == j.replace(tie_embeddings=False).param_count()
                == t.param_count())
    assert get_config(arch).param_count() == PARAMS[arch]


def test_init_params_shapes(model):
    _, cfg, _, tp = model
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, jax.tree.map(np.asarray, tp)) == \
        jax.tree.map(np.shape, mine)
    assert "head" not in mine["embed"]
    assert ("gate" in mine["blocks"][0]["mlp"]) == cfg.mlp_gated
    n = sum(t.numel() for t in jax.tree.leaves(mine))
    assert n == cfg.param_count() + (cfg.vocab_padded - cfg.vocab_size) * \
        cfg.d_model


# ---------------------------------------------------------------- M-RoPE

MROPE_CASES = [  # x shape, sections
    ((2, 24, 4, 16), (2, 3, 3)),          # qwen2-vl SMOKE
    ((1, 40, 3, 128), (16, 24, 24)),      # qwen2-vl FULL
    ((3, 7, 2, 8), (1, 2, 1)),
]


@pytest.mark.parametrize("shape,sections", MROPE_CASES)
def test_mrope_matches_jax_on_differing_streams(shape, sections):
    rng = np.random.default_rng(len(sections) + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4096, shape[:2] + (3,)).astype(np.int32)
    assert (pos[..., 0] != pos[..., 1]).any()
    got = rope.mrope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
                     sections)
    want = jrope.mrope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, sections)
    _close(got, want, atol=1e-6, rtol=1e-6)
    # the split matters on these positions: another one gives other values
    other = tuple(reversed(sections))
    if other != sections:
        wrong = rope.mrope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0, other)
        assert float((wrong - got).abs().max()) > 1e-2


def test_mrope_band_to_stream_map():
    """Pair i turns with stream sec_id[i]: give one stream at a time a
    nonzero position and only its band of pairs turns."""
    sections = (2, 3, 3)
    x = torch.ones((1, 1, 1, 16))
    for j, (lo, hi) in enumerate(((0, 2), (2, 5), (5, 8))):
        pos = torch.zeros((1, 1, 3), dtype=torch.int64)
        pos[..., j] = 7
        got = rope.mrope(x, pos, 10_000.0, sections)[0, 0, 0]
        moved = (got != x[0, 0, 0]).nonzero().flatten() % 8
        assert sorted(set(moved.tolist())) == list(range(lo, hi)), j
    with pytest.raises(AssertionError):
        rope.mrope(x, pos, 10_000.0, (2, 3, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_equals_rope_on_text_positions(dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 30, 4, 16)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 9000, (2, 30)))
    got = rope.mrope(x, pos[..., None].expand(-1, -1, 3), 10_000.0, (2, 3, 3))
    assert torch.equal(got, rope.rope(x, pos, 10_000.0))


# ----------------------------------------------------------------- model

def test_forward_hidden_and_logits_match_jax(model):
    jcfg, cfg, jp, tp = model
    _, jin, tin = _inputs(cfg, B, S, 0)
    h = lm.forward_hidden(tp, tin, cfg)
    jh = jlm.forward_hidden(jp, jin, jcfg)
    _close(h, jh)
    _close(lm.logits_fn(tp, h, cfg), jlm.logits_fn(jp, jh, jcfg))
    if cfg.mrope:     # the streams matter: text positions give other values
        flat = dict(tin, positions=tin["positions"][..., :1].expand(
            -1, -1, 3).contiguous())
        assert float((lm.forward_hidden(tp, flat, cfg) - h).abs().max()) \
            > 1e-3


def test_embeds_take_the_place_of_the_tokens(model):
    """With embeds in the inputs the table is not read; the tokens of the
    same rows give the same hidden states as their table rows fed as
    embeds."""
    _, cfg, _, tp = model
    emb, _, tin = _inputs(cfg, 1, 6, 1)
    toks = torch.arange(6)[None] % cfg.vocab_size
    h = lm.forward_hidden(tp, {**tin, "tokens": toks}, cfg)
    assert torch.equal(h, lm.forward_hidden(tp, tin, cfg))
    rows = {"embeds": tp["embed"]["table"][toks],
            "positions": tin["positions"]}
    assert torch.equal(lm.forward_hidden(tp, {"tokens": toks, "positions":
                                              tin["positions"]}, cfg),
                       lm.forward_hidden(tp, rows, cfg))


def test_prefill_caches_and_decode_match_jax(model):
    jcfg, cfg, jp, tp = model
    emb, jin, tin = _inputs(cfg, B, S, 2)
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
    nxt = emb[:, S:S + 1]
    zeros = np.zeros((B, 1, 3) if cfg.mrope else (B, 1), np.int32)
    jd, jc2 = jlm.decode_step(jp, {"embeds": jnp.asarray(nxt),
                                   "positions": jnp.asarray(zeros)}, jc, jcfg)
    step = {"embeds": torch.from_numpy(nxt), "positions":
            torch.from_numpy(zeros)}
    tpd.reset_launches()
    td, tc2 = lm.decode_step(tp, step, tc, cfg)
    assert tpd.LAUNCHES["paged_decode_attention"] == 0     # CPU: plain
    _close(td, jd)
    for got, want in zip(tc2["kv"], convert.lm_caches_from_jax(
            jc2, cfg, "cpu")["kv"]):
        for g, w in zip(got, want):
            _close(g, w.numpy())
    td2, _ = lm.decode_step(tp, step, want_c, cfg)          # carried across
    _close(td2, jd)


def test_prefill_then_decode_equals_stepwise_decode(model):
    """On text positions (decode rotates with the cache length in every
    stream, as the reference's does)."""
    _, cfg, _, tp = model
    b, s = 2, 10
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, s + 1, cfg.d_model)).astype(np.float32))
    pos = torch.arange(s)[None].repeat(b, 1)
    if cfg.mrope:
        pos = pos[..., None].expand(-1, -1, 3)
    _, caches = lm.prefill(tp, {"embeds": emb[:, :s], "positions": pos},
                           cfg, max_len=32)
    lg_a, _ = lm.decode_step(tp, {"embeds": emb[:, s:s + 1],
                                  "positions": pos[:, :1]}, caches, cfg)
    caches2 = lm.make_cache(cfg, b, max_len=32, device="cpu")
    for t in range(s + 1):
        lg_b, caches2 = lm.decode_step(tp, {"embeds": emb[:, t:t + 1],
                                            "positions": pos[:, :1]},
                                       caches2, cfg)
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), atol=2e-3,
                               rtol=2e-3)


# -------------------------------------------------------------- training

def _port_params(jp, cfg):
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                        "cpu")
    return T.tree_map(lambda p: p.requires_grad_(True), params)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_jax(arch, remat):
    jcfg, cfg, jp, _ = _model(arch)
    cfg = cfg.replace(remat=remat)
    batch = jdata.make_batch(jcfg, 3, 0, B, S)
    assert "embeds" in batch["inputs"] and "tokens" not in batch["inputs"]
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    params = _port_params(jp, cfg)
    loss = lm.loss_fn(params, tdata.batch_to_torch(batch, "cpu"), cfg)
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                      "cpu")
    pairs = list(zip(T.flatten_with_path(T.unflatten(params, grads)),
                     T.flatten_with_path(want)))
    assert len(pairs) == len(grads) == 2 + len(
        T.leaves(params["blocks"][0])) * cfg.n_layers
    for (path, g), (_, w) in pairs:
        assert _rel(g, w.numpy()) <= 1e-4, path


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_jax(model, micro):
    jcfg, cfg, jp0, _ = model
    s = TrainSettings(batch=4, seq=16, steps=3, lr=1e-3, warmup_steps=1,
                      num_microbatches=micro)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainSettings(
        **{f: getattr(s, f) for f in ("batch", "seq", "steps", "lr",
                                      "warmup_steps", "num_microbatches",
                                      "grad_compression")})))
    jp, jopt, jres = jp0, joptim.init(jp0), jnp.zeros(())
    params = _port_params(jp0, cfg)
    opt = toptim.init(params)
    step_fn = make_train_step(cfg, s)
    res = None
    for step in range(3):
        batch = jdata.make_batch(jcfg, s.seed, step, s.batch, s.seq)
        jp, jopt, jres, jm = jstep(jp, jopt, jres,
                                   jax.tree.map(jnp.asarray, batch),
                                   jnp.asarray(step, jnp.int32))
        params, opt, res, m = step_fn(params, opt, res, tdata.batch_to_torch(
            tdata.make_batch(cfg, s.seed, step, s.batch, s.seq), "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    start = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp0), cfg,
                                       "cpu")
    final = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")
    for (path, p), (_, p0), (_, pj) in zip(T.flatten_with_path(params),
                                           T.flatten_with_path(start),
                                           T.flatten_with_path(final)):
        assert float((p.detach() - pj).norm()) <= 1e-3 * float(
            (pj - p0).norm()), path
    jopt_t = convert.opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg,
                                        "cpu")
    assert opt.step == jopt_t.step == 3
    for mine, theirs in ((opt.m, jopt_t.m), (opt.v, jopt_t.v)):
        for (path, a), (_, b) in zip(T.flatten_with_path(mine),
                                     T.flatten_with_path(theirs)):
            assert float((a - b).norm()) <= 1e-3 * float(b.norm()), path


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("arch,smoke", [("musicgen-medium", True),
                                        ("musicgen-medium", False),
                                        ("qwen2-vl-2b", True)])
def test_make_batch_bit_identical(arch, smoke):
    """Embeds and (for qwen) 3-row positions, at SMOKE and, for musicgen,
    at FULL width (a 2048 x 1536 codebook; qwen's FULL one, 151,936 x
    1536, is a 3.7 GB peak in the reference's draw)."""
    cfg, jcfg = get_config(arch, smoke), jget_config(arch, smoke)
    seq = 24 if smoke else 6
    got = tdata.make_batch(cfg, 7, 3, 2, seq)
    want = jdata.make_batch(jcfg, 7, 3, 2, seq)
    assert sorted(got["inputs"]) == sorted(want["inputs"]) == [
        "embeds", "positions"]
    for k in got["inputs"]:
        assert got["inputs"][k].dtype == want["inputs"][k].dtype
        assert got["inputs"][k].shape == want["inputs"][k].shape
        np.testing.assert_array_equal(got["inputs"][k], want["inputs"][k])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["inputs"]["embeds"].shape == (2, seq, cfg.d_model)
    assert got["inputs"]["positions"].shape == (
        (2, seq, 3) if cfg.mrope else (2, seq))
    t = tdata.batch_to_torch(got, "cpu")
    assert t["inputs"]["embeds"].dtype == torch.float32
    assert t["inputs"]["positions"].shape == got["inputs"]["positions"].shape
    assert "tokens" not in t["inputs"]


def test_codebook_is_drawn_once_with_the_reference_bits():
    cfg = get_config("qwen2-vl-2b", smoke=True)
    book = tdata.codebook(cfg.vocab_size, cfg.d_model)
    assert tdata.codebook(cfg.vocab_size, cfg.d_model) is book
    assert not book.flags.writeable
    rng = np.random.default_rng(1234)
    want = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32) * 0.02
    assert book.dtype == np.float32
    np.testing.assert_array_equal(book, want)
    b = tdata.make_batch(cfg, 0, 0, 2, 8)
    toks = tdata.synth_tokens(0, 0, 2, 9, cfg.vocab_size)[:, :8]
    np.testing.assert_array_equal(b["inputs"]["embeds"], want[toks])


# ----------------------------------------------------- server, launchers

def test_server_refuses_the_frontend_stubs(model):
    jcfg, cfg, jp, tp = model
    with pytest.raises(AssertionError, match="token-input"):
        JServer(jcfg, jp)
    with pytest.raises(ValueError, match="token-input"):
        Server(cfg, tp, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_refuses_them_too(arch):
    with pytest.raises(ValueError, match="token-input"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_smoke_on_cpu(arch, capsys):
    out = tlaunch.main(["--arch", arch, "--smoke", "--steps", "3",
                        "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


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
        tlaunch.main(["--arch", arch, "--smoke", "--steps", "1"])
