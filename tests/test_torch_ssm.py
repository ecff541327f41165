"""Port parity: the falcon-mamba serving path of ``repro_torch`` (mamba1
blocks over K9's plain version on the CPU) against the JAX package, at the
SMOKE size in float32.

The reference's params cross over with ``convert.lm_params_from_jax`` (the
two packages draw different numbers from one seed).  At the init's
``dt_bias`` of -4.6 (Δ ≈ 0.01) and SMOKE's widths (B and C near 0.1) the
scan state adds about 1% to y next to D·x, and a wrong state hides below
the tolerances; so both packages get the same params with ``dt_bias`` -1
(Δ ≈ 0.3) and ``x_proj`` scaled by 10 (B and C near 1), where the state
carries y.  Tolerance atol = rtol
= 1e-4 for layers, hidden states, logits and the decode state: float32 sums
taken in another order, over three layers.  The reference's full forward
runs its Pallas scan in interpret mode and its plain scan (``kernels=
"interpret"`` and ``"ref"``).  The Server must give identical greedy
tokens; port prefill-then-decode ≡ port stepwise decode ≡ port forward
within 2e-3, as ``tests/test_models.py:61-96,171-200`` holds the
reference.  Inputs come from numpy seeds.

Training: the loss and every gradient leaf against ``jax.value_and_grad``
of the reference's ``loss_fn`` (its plain scan, ``kernels="ref"``), remat
on and off, within the dense families' tolerances (loss rtol 1e-5, each
leaf ‖Δ‖ ≤ 1e-4 ‖g‖): the port's gradient runs the plain version of
K9-bwd through ``ops._MambaScan``.  Three optimizer steps against the
reference's jitted train step as ``tests/test_torch_train.py`` holds
gemma2-2b's (losses rtol 1e-4; params, m and v within 1e-3 of each leaf's
change or size).  The training entry points run and print a finite loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.runtime import Request as JRequest
from repro.runtime import Server as JServer
from repro.runtime import train_loop as jtrain
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_to_torch
from repro_torch.kernels import mamba_scan as tms
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm, ssm
from repro_torch.models.blocks import mamba_block
from repro_torch.runtime import Request, Server, TrainSettings, \
    make_train_step

ARCH = "falcon-mamba-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 20
DT_BIAS = -1.0
X_PROJ_SCALE = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, smoke=True).replace(kernels="ref")
    cfg = get_config(ARCH, smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    mamba = jp["blocks"]["mamba"]
    mamba["dt_bias"] = jnp.full_like(mamba["dt_bias"], DT_BIAS)
    mamba["x_proj"] = mamba["x_proj"] * X_PROJ_SCALE
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 89, (B, S + 1)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    jin = {"tokens": jnp.asarray(toks[:, :S]), "positions": jnp.asarray(pos)}
    tin = {"tokens": torch.from_numpy(toks[:, :S]).long(),
           "positions": torch.from_numpy(pos)}
    return toks, jin, tin


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tokens(toks):
    zeros = np.zeros((toks.shape[0], 1), np.int32)
    return ({"tokens": jnp.asarray(toks), "positions": jnp.asarray(zeros)},
            {"tokens": torch.from_numpy(toks).long(),
             "positions": torch.from_numpy(zeros)})


# ------------------------------------------------------------- configs

def test_config_matches_the_reference():
    for smoke in (False, True):
        j, t = jget_config(ARCH, smoke), get_config(ARCH, smoke)
        for f in ("family", "n_layers", "d_model", "n_heads", "d_ff",
                  "vocab_size", "ssm_state", "ssm_conv", "ssm_expand",
                  "mamba_version", "tie_embeddings", "dtype", "rms_eps",
                  "d_inner", "dt_rank", "attention_free", "vocab_padded"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_count() == j.param_count()
    full = get_config(ARCH)
    assert (full.d_inner, full.dt_rank, full.vocab_padded) == (8192, 256,
                                                               65024)
    assert full.param_count() == 7_006_064_640
    assert get_config("gemma2-2b").param_count() == \
        jget_config("gemma2-2b").param_count()


def test_params_carry_across_and_init_matches_their_layout(model):
    jcfg, cfg, jp, tp = model
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = lambda p: jax.tree.map(np.shape, jax.tree.map(  # noqa: E731
        np.asarray, p))
    assert shapes(tp) == shapes(mine)
    assert len(tp["blocks"]) == 3 and sorted(tp["blocks"][0]) == ["ln",
                                                                  "mamba"]
    for i in range(cfg.n_layers):
        for k, v in tp["blocks"][i]["mamba"].items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jp["blocks"]["mamba"][k][i]))
    blk = mine["blocks"][1]["mamba"]
    assert torch.equal(blk["a_log"][5], torch.log(torch.arange(1., 5.)))
    assert bool((blk["dt_bias"] == -4.6).all()) and not blk["conv_b"].any()
    assert bool((blk["d_skip"] == 1).all())
    assert float(blk["in_proj"].abs().max()) <= 2 / 32 ** 0.5
    assert 0.05 < float(blk["conv_w"].std()) < 0.15
    again = lm.init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(again["blocks"][2]["mamba"]["x_proj"],
                       mine["blocks"][2]["mamba"]["x_proj"].bfloat16())


# -------------------------------------------------------------- layers

def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 16), np.float32)
    w = rng.standard_normal((4, 16), np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, jssm._causal_conv(*map(jnp.asarray, (x, w, b))))
    short = ssm._causal_conv(*map(torch.from_numpy, (x[:, :2], w, b)))
    _close(short, got[:, :2])


def test_mamba_block_matches_jax(model):
    jcfg, cfg, jp, tp = model
    from repro.models.blocks import mamba_block as jmamba_block
    x = np.random.default_rng(2).standard_normal((B, S, 32), np.float32)
    for kernels in ("interpret", "ref"):
        jpl = jax.tree.map(lambda a: a[1], jp["blocks"])
        want = jmamba_block(jpl, jnp.asarray(x), jcfg.replace(
            kernels=kernels), version=1)
        _close(mamba_block(tp["blocks"][1], torch.from_numpy(x), cfg), want)


# --------------------------------------------------------------- model

@pytest.mark.parametrize("kernels", ["interpret", "ref"])
def test_forward_and_logits_match_jax(model, batch, kernels):
    jcfg, cfg, jp, tp = model
    jcfg = jcfg.replace(kernels=kernels)
    jh = jlm.forward_hidden(jp, batch[1], jcfg)
    th = lm.forward_hidden(tp, batch[2], cfg)
    _close(th, jh)
    got = lm.logits_fn(tp, th, cfg)
    assert got.shape == (B, S, 256)
    _close(got, jlm.logits_fn(jp, jh, jcfg))
    assert bool((got[..., 89:] == -1e30).all())


def test_init_params_forward_and_prefill_match_jax(batch):
    """The reference's init params as they are (Δ ≈ 0.01), carried across."""
    jcfg = jget_config(ARCH, smoke=True).replace(kernels="ref")
    cfg = get_config(ARCH, smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    _close(lm.forward_hidden(tp, batch[2], cfg),
           jlm.forward_hidden(jp, batch[1], jcfg))
    jl, jc = jlm.prefill(jp, batch[1], jcfg)
    tl, tc = lm.prefill(tp, batch[2], cfg)
    _close(tl, jl)
    for got, w in zip(tc["ssm"], convert.lm_caches_from_jax(
            jc, cfg, "cpu")["ssm"]):
        _close(got.h, w.h.numpy())


def test_prefill_matches_jax(model, batch):
    jcfg, cfg, jp, tp = model
    jl, jc = jlm.prefill(jp, batch[1], jcfg, max_len=64)
    tms.reset_launches()
    tl, tc = lm.prefill(tp, batch[2], cfg, max_len=64)
    assert tms.LAUNCHES == {"mamba_scan": 0,           # CPU: plain versions
                            "mamba_scan_bwd": 0}
    assert tl.shape == (B, 1, 256)
    _close(tl, jl)
    want = convert.lm_caches_from_jax(jc, cfg, "cpu")
    assert len(tc["ssm"]) == len(want["ssm"]) == cfg.n_layers
    for got, w in zip(tc["ssm"], want["ssm"]):
        assert got.conv.shape == w.conv.shape == (B, 3, 64)
        assert got.h.shape == w.h.shape == (B, 64, 4)
        assert got.h.dtype == w.h.dtype == torch.float32
        _close(got.conv, w.conv.numpy())
        _close(got.h, w.h.numpy())
        assert got.conv.untyped_storage().nbytes() == got.conv.nbytes


def test_decode_step_matches_jax(model, batch):
    jcfg, cfg, jp, tp = model
    toks = batch[0]
    _, jc = jlm.prefill(jp, batch[1], jcfg, max_len=64)
    _, tc = lm.prefill(tp, batch[2], cfg, max_len=64)
    jin, tin = _tokens(toks[:, S:S + 1])
    jd, jc2 = jlm.decode_step(jp, jin, jc, jcfg)
    td, tc2 = lm.decode_step(tp, tin, tc, cfg)
    _close(td, jd)
    # the same step from the reference's own caches, carried across
    want = convert.lm_caches_from_jax(jc, cfg, "cpu")
    td2, tc3 = lm.decode_step(tp, tin, want, cfg)
    _close(td2, jd)
    for got, w in zip(tc3["ssm"], convert.lm_caches_from_jax(
            jc2, cfg, "cpu")["ssm"]):
        _close(got.conv, w.conv.numpy())
        _close(got.h, w.h.numpy())
    for st, w in zip(tc["ssm"], want["ssm"]):         # untouched
        _close(st.h, w.h.numpy())


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


def test_stepwise_decode_equals_forward(model):
    _, cfg, _, tp = model
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s)))
    pos = torch.arange(s)[None].repeat(b, 1)
    full = lm.logits_fn(tp, lm.forward_hidden(
        tp, {"tokens": toks, "positions": pos}, cfg), cfg)
    caches = lm.make_cache(cfg, b, max_len=32, device="cpu")
    steps = []
    for t in range(s):
        lg, caches = lm.decode_step(tp, {"tokens": toks[:, t:t + 1],
                                         "positions": pos[:, t:t + 1]},
                                    caches, cfg)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


# -------------------------------------------------------------- server

def test_server_tokens_identical_to_jax(model):
    """Six requests over four slots: two slots are freed and reused
    mid-run, so the per-slot merge of the conv tails and scan states (and
    the reference's reuse of a freed slot's state as it stands) shows."""
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
    assert all(0 <= t < 89 for v in outs.values() for t in v)
    assert server.stats == {"prefills": 2, "decode_steps": 2, "tokens_out": 4}
    out = capsys.readouterr().out
    assert "req 1:" in out and "tok/s on cpu" in out


def test_untied_head_raises_naming_its_roadmap_item(model, batch):
    """The untied LM head is ported (nemotron-4-15b's): an untied
    falcon-mamba SMOKE gets its own head leaf and the reference's logits.
    Its training, which raised naming ROADMAP item 9.10 until K9 had a
    backward, now gives the reference's loss and a gradient for the head
    leaf."""
    jcfg, cfg, jp, _ = model
    jcfg, cfg = (c.replace(tie_embeddings=False) for c in (jcfg, cfg))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    mine = lm.init_params(cfg, 0, device="cpu")
    assert mine["embed"]["head"].shape == tp["embed"]["head"].shape == \
        (cfg.d_model, cfg.vocab_padded)
    _close(lm.logits_fn(tp, lm.forward_hidden(tp, batch[2], cfg), cfg),
           jlm.logits_fn(jp, jlm.forward_hidden(jp, batch[1], jcfg), jcfg))
    head = tp["embed"]["head"].requires_grad_(True)
    loss = lm.loss_fn(tp, {"inputs": batch[2], "labels": batch[2]["tokens"]},
                      cfg)
    jloss = jlm.loss_fn(jp, {"inputs": batch[1], "labels": batch[1]["tokens"]},
                        jcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    (g,) = torch.autograd.grad(loss, [head])
    assert g.shape == head.shape and bool(torch.isfinite(g).all())
    assert float(g.norm()) > 0


def test_training_raises_naming_its_roadmap_item(model, batch, capsys):
    """Training falcon-mamba raised, naming ROADMAP item 9.10, until K9 had
    a backward: ``loss_fn`` now gives the reference's loss, and the CLI
    trains SMOKE on the CPU to a finite final loss."""
    jcfg, cfg, jp, tp = model
    labels = {"inputs": batch[2], "labels": batch[2]["tokens"]}
    loss = lm.loss_fn(tp, labels, cfg)
    jloss = jlm.loss_fn(jp, {"inputs": batch[1],
                             "labels": batch[1]["tokens"]}, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    out = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "3"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


# ------------------------------------------------------------ training

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach() - want).norm() / max(float(want.norm()),
                                                    1e-30))


def _port_params(jp, cfg):
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                        "cpu")
    return T.tree_map(lambda p: p.requires_grad_(True), params)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grad_match_jax(model, remat):
    jcfg, cfg, jp, _ = model
    cfg = cfg.replace(remat=remat)
    batch = jmake_batch(jcfg, 3, 0, B, 24)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    params = _port_params(jp, cfg)
    tms.reset_launches()
    loss = lm.loss_fn(params, batch_to_torch(batch, "cpu"), cfg)
    grads = torch.autograd.grad(loss, T.leaves(params))
    assert tms.LAUNCHES == {"mamba_scan": 0, "mamba_scan_bwd": 0}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                      "cpu")
    pairs = list(zip(T.flatten_with_path(want), grads))
    assert len(pairs) == 2 + 10 * cfg.n_layers    # embed, final norm, blocks
    for (path, w), g in pairs:
        assert _rel(g, w) <= 1e-4, path


def test_three_train_steps_match_jax(model):
    """Three AdamW steps of falcon-mamba SMOKE from the same params and
    batches against the reference's jitted step."""
    jcfg, cfg, jp0, _ = model
    s = TrainSettings(batch=4, seq=16, steps=3, lr=1e-3, warmup_steps=1)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainSettings(
        batch=4, seq=16, steps=3, lr=1e-3, warmup_steps=1)))
    jp, jopt, jres = jp0, joptim.init(jp0), jnp.zeros(())
    params = _port_params(jp0, cfg)
    opt = toptim.init(params)
    step_fn = make_train_step(cfg, s)
    for step in range(3):
        batch = jmake_batch(jcfg, s.seed, step, s.batch, s.seq)
        jp, jopt, jres, jm = jstep(jp, jopt, jres,
                                   jax.tree.map(jnp.asarray, batch),
                                   jnp.asarray(step, jnp.int32))
        params, opt, _, m = step_fn(params, opt, None,
                                    batch_to_torch(batch, "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    start = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp0), cfg,
                                       "cpu")
    end = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    for (path, p), (_, p0), (_, pj) in zip(T.flatten_with_path(params),
                                           T.flatten_with_path(start),
                                           T.flatten_with_path(end)):
        assert float((p.detach() - pj).norm()) <= 1e-3 * float(
            (pj - p0).norm()), path
    jopt_t = convert.opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg,
                                        "cpu")
    assert opt.step == jopt_t.step == 3
    for mine, theirs in ((opt.m, jopt_t.m), (opt.v, jopt_t.v)):
        for (path, a), (_, b) in zip(T.flatten_with_path(mine),
                                     T.flatten_with_path(theirs)):
            assert float((a - b).norm()) <= 1e-3 * float(b.norm()), path


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
