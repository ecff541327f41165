"""Port parity: gemma2-2b training in ``repro_torch`` against the JAX
package, at the SMOKE size in float32 (the loss and gradient also for
nemotron-4-15b, minicpm-2b and granite-34b), plus the reference's
behaviour tests of the training runtime, run in the port.

The reference's params cross over with ``convert.lm_params_from_jax`` and
its optimizer state with ``convert.opt_state_from_jax``.  The reference
runs its plain attention (``kernels="ref"``) under ``jax.value_and_grad``;
the port's attention runs the plain versions of K6-with-LSE and K7 through
its autograd Function (CPU tensors).  The two take float32 sums in other
orders, so: the loss within rtol 1e-5 and each gradient leaf within
‖Δ‖ ≤ 1e-4 ‖g‖; over three optimizer steps the losses within rtol 1e-4
and each leaf of params, m and v within 1e-3 of the size of that leaf's
change (AdamW normalizes each element's step, which magnifies the
gradients' rounding differences; with int8 compression both codecs are
fed the reference's gradient, see the test).  Batches come from both
packages' ``make_batch`` (bit-identical, ``tests/test_torch_data.py``).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import lm as jlm
from repro.runtime import train_loop as jtrain
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch import tree as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_to_torch, make_batch
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm
from repro_torch.runtime import (FaultInjector, StragglerWatchdog,
                                 TrainSettings, make_train_step, train)
from repro_torch.runtime import train_loop as ttrain

B, S = 2, 24                      # S = 3 × the smoke window of 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: The dense archs the training entry point accepts, held at SMOKE.
DENSE_ARCHS = ["gemma2-2b", "nemotron-4-15b", "minicpm-2b", "granite-34b"]


@functools.lru_cache(maxsize=None)
def _make_model(arch):
    jcfg = jget_config(arch, smoke=True).replace(kernels="ref")
    cfg = get_config(arch, smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp


@pytest.fixture(scope="module")
def model():
    return _make_model("gemma2-2b")


def _port_params(jp, cfg):
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                        "cpu")
    return T.tree_map(lambda p: p.requires_grad_(True), params)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def _leafwise(t_tree, j_tree, cfg):
    """(path, port leaf, reference leaf carried to the port's layout)."""
    j = convert.lm_params_from_jax(jax.tree.map(np.asarray, j_tree), cfg,
                                   "cpu")
    return [(p, a, b) for (p, a), (_, b) in zip(T.flatten_with_path(t_tree),
                                                T.flatten_with_path(j))]


# ---------------------------------------------------------- loss + grad

def _n_leaves(jtree, cfg):
    """Leaves of the reference's tree in the port's layout: each leaf under
    ``blocks`` is stacked over the layers, the others are one leaf."""
    return sum(cfg.n_layers if jax.tree_util.keystr(path).startswith(
        "['blocks']") else 1
        for path, _ in jax.tree_util.tree_leaves_with_path(jtree))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grad_match_jax(arch, remat):
    jcfg, cfg, jp = _make_model(arch)
    cfg = cfg.replace(remat=remat)
    batch = jmake_batch(jcfg, 3, 0, B, S)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    params = _port_params(jp, cfg)
    loss = lm.loss_fn(params, batch_to_torch(batch, "cpu"), cfg)
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    pairs = _leafwise(T.unflatten(params, grads), jgrads, cfg)
    assert len(pairs) == len(grads) == _n_leaves(jgrads, cfg)
    if arch == "gemma2-2b":                 # embed, final norm, blocks
        assert len(pairs) == 2 + 11 * cfg.n_layers
    for path, g, want in pairs:
        assert _rel(g, want.numpy()) <= 1e-4, path


def test_loss_masks_negative_labels(model):
    jcfg, cfg, jp = model
    batch = jmake_batch(jcfg, 4, 0, B, S)
    batch["labels"][0, ::3] = -1
    jloss = jlm.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.no_grad():
        loss = lm.loss_fn(_port_params(jp, cfg), batch_to_torch(batch, "cpu"),
                          cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_remat_gives_the_same_gradient(model):
    _, cfg, jp = model
    batch = batch_to_torch(make_batch(cfg, 5, 0, B, S), "cpu")
    grads = []
    for remat in (True, False):
        params = _port_params(jp, cfg)
        loss = lm.loss_fn(params, batch, cfg.replace(remat=remat))
        grads.append(torch.autograd.grad(loss, T.leaves(params)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------ the train step

def _feed_reference_codec_input(monkeypatch, cfg):
    """Makes both packages' int8 codecs quantize the reference's input.

    The codec rounds each element to one of 255 levels, so a difference of
    one ulp in its input (the gradient plus the carried residual) can move
    an element a whole level, and AdamW's per-element step turns that into
    a visibly different update.  The reference's codec input is caught as
    it runs.  The port's step checks its own gradient and residual against
    it (‖Δ‖ ≤ 1e-4 ‖g‖ per leaf, as the gradient test, and 1e-4 of the
    residual, see below) and then quantizes the reference's, so the codec,
    the residual it leaves and AdamW are held at the step's tolerance."""
    seen = []
    jorig, torig = jtrain.compress_lib.int8_compress, \
        ttrain.compress_lib.int8_compress

    def jcodec(grads, residual):
        jax.debug.callback(lambda *x: seen.append(x), grads, residual,
                           ordered=True)
        return jorig(grads, residual)

    def tcodec(grads, residual):
        jax.effects_barrier()
        want = [convert.lm_params_from_jax(x, cfg, "cpu")
                for x in seen.pop()]
        for got, w in zip((grads, residual), want):
            for (path, g), (_, x) in zip(T.flatten_with_path(got),
                                         T.flatten_with_path(w)):
                assert _rel(g, x.numpy()) <= 1e-4, path
        return torig(*want)
    monkeypatch.setattr(jtrain.compress_lib, "int8_compress", jcodec)
    monkeypatch.setattr(ttrain.compress_lib, "int8_compress", tcodec)


@pytest.mark.parametrize("micro,comp", [(1, "none"), (2, "none"),
                                        (1, "int8")])
def test_three_train_steps_match_jax(model, micro, comp, monkeypatch):
    jcfg, cfg, jp0 = model
    s = TrainSettings(batch=4, seq=16, steps=3, lr=1e-3, warmup_steps=1,
                      num_microbatches=micro, grad_compression=comp)
    if comp == "int8":
        _feed_reference_codec_input(monkeypatch, cfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainSettings(
        **{f: getattr(s, f) for f in ("batch", "seq", "steps", "lr",
                                      "warmup_steps", "num_microbatches",
                                      "grad_compression")})))
    jp, jopt = jp0, joptim.init(jp0)
    jres = (jax.tree.map(lambda p: jnp.zeros_like(p, jnp.float32), jp)
            if comp != "none" else jnp.zeros(()))
    params = _port_params(jp0, cfg)
    opt = toptim.init(params)
    res = (T.tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                      params) if comp != "none" else None)
    step_fn = make_train_step(cfg, s)
    for step in range(3):
        batch = jmake_batch(jcfg, s.seed, step, s.batch, s.seq)
        jp, jopt, jres, jm = jstep(jp, jopt, jres,
                                   jax.tree.map(jnp.asarray, batch),
                                   jnp.asarray(step, jnp.int32))
        params, opt, res, m = step_fn(params, opt, res,
                                      batch_to_torch(batch, "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
        # int8: the error-feedback residual, every step.  It is the codec
        # input less its dequantized value, within half a level (1/254 of
        # its block's largest value), so one ulp of the input is some
        # hundreds of ulp of the residual: 1e-4 of its norm.
        if comp == "int8":
            want = convert.lm_params_from_jax(
                jax.tree.map(np.asarray, jres), cfg, "cpu")
            for (path, r), (_, w) in zip(T.flatten_with_path(res),
                                         T.flatten_with_path(want)):
                assert _rel(r, w.numpy()) <= 1e-4, path
    tol = 1e-3
    jopt_t = convert.opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg,
                                        "cpu")
    assert opt.step == jopt_t.step == 3
    start = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp0), cfg,
                                       "cpu")
    for (path, p), (_, p0), (_, pj) in zip(
            T.flatten_with_path(params), T.flatten_with_path(start),
            T.flatten_with_path(convert.lm_params_from_jax(
                jax.tree.map(np.asarray, jp), cfg, "cpu"))):
        moved = float((pj - p0).norm())
        assert float((p.detach() - pj).norm()) <= tol * moved, path
    for mine, theirs in ((opt.m, jopt_t.m), (opt.v, jopt_t.v)):
        for (path, a), (_, b) in zip(T.flatten_with_path(mine),
                                     T.flatten_with_path(theirs)):
            assert float((a - b).norm()) <= tol * float(b.norm()), path


# ------------------------------------------- the reference's behaviour

def test_loss_decreases():
    """tests/test_system.py:14-19, on gemma2-2b SMOKE."""
    cfg = get_config("gemma2-2b", smoke=True)
    s = TrainSettings(batch=4, seq=32, steps=15, lr=1e-2, warmup_steps=3,
                      log_every=100)
    out = train(cfg, s, verbose=False, device="cpu")
    assert len(out["losses"]) == 15 and out["restarts"] == 0
    assert out["losses"][-1] < out["losses"][0]


def test_microbatching_matches_full_batch():
    """tests/test_system.py:29-40: accumulation over 2 microbatches == one
    batch step."""
    cfg = get_config("gemma2-2b", smoke=True)
    base = dict(batch=4, seq=16, steps=3, lr=1e-3, warmup_steps=0,
                schedule="constant", log_every=100)
    out1 = train(cfg, TrainSettings(**base, num_microbatches=1),
                 verbose=False, device="cpu")
    out2 = train(cfg, TrainSettings(**base, num_microbatches=2),
                 verbose=False, device="cpu")
    np.testing.assert_allclose(out1["losses"], out2["losses"], rtol=2e-3)


def test_crash_restore_replay_matches_uninterrupted(tmp_path):
    """tests/test_checkpoint.py:92-112: a crash at step 7 with a checkpoint
    every 3 steps replays to the uninterrupted run.  A port checkpoint is
    labelled with the next step to run, so the replay repeats no step and
    every loss is the uninterrupted run's, bit for bit."""
    cfg = get_config("gemma2-2b", smoke=True)
    base = dict(batch=2, seq=16, steps=10, lr=1e-3, warmup_steps=2,
                log_every=100)
    s1 = TrainSettings(**base, ckpt_every=3, ckpt_dir=str(tmp_path / "a"))
    out1 = train(cfg, s1, fault=FaultInjector(fault_step=7), verbose=False,
                 device="cpu")
    assert out1["restarts"] == 1
    assert ckpt.latest_step(str(tmp_path / "a")) == 10
    s2 = TrainSettings(**base, ckpt_every=0, ckpt_dir=str(tmp_path / "b"))
    out2 = train(cfg, s2, verbose=False, device="cpu")
    np.testing.assert_allclose(out1["losses"][-1], out2["losses"][-1],
                               rtol=1e-5)
    assert out1["losses"] == out2["losses"]


def test_fault_from_the_environment_and_restart_from_checkpoint(
        tmp_path, monkeypatch):
    """REPRO_FAULT_STEP arms the injector; a new run over the same
    directory resumes from its latest checkpoint."""
    monkeypatch.setenv("REPRO_FAULT_STEP", "2")
    assert FaultInjector().fault_step == 2
    cfg = get_config("gemma2-2b", smoke=True)
    s = TrainSettings(batch=2, seq=8, steps=5, lr=1e-3, warmup_steps=0,
                      ckpt_every=2, ckpt_dir=str(tmp_path), log_every=100)
    out = train(cfg, s, verbose=False, device="cpu")
    assert out["restarts"] == 1 and len(out["losses"]) == 5 + 2
    again = train(cfg, dataclasses.replace(s, steps=7),
                  fault=FaultInjector(fault_step=-1), verbose=False,
                  device="cpu")
    assert len(again["losses"]) == 7 - 5      # resumed at step 5


def test_watchdog():
    """tests/test_checkpoint.py:116-126."""
    wd = StragglerWatchdog(warmup_steps=2, strikes_to_evict=2, threshold=2.0)
    verdicts = [wd.observe(i, 0.1) for i in range(5)]
    assert verdicts[:2] == ["warmup", "warmup"] and verdicts[-1] == "ok"
    assert wd.observe(5, 0.5) == "slow"
    assert wd.observe(6, 0.5) == "evict"
    assert wd.events
    assert abs(wd.ewma - 0.1) < 0.02        # slow steps do not poison it


# ---------------------------------------------------------- checkpoints

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)},
            "e": [torch.tensor([1.5, -2.0], dtype=torch.bfloat16)],
            "opt": toptim.AdamWState(7, {"m": torch.zeros(2)},
                                     {"m": torch.ones(2)})}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    template = T.tree_map(lambda x: torch.zeros_like(x)
                          if isinstance(x, torch.Tensor) else 0, t)
    got = ckpt.restore(str(tmp_path), 7, template)
    for (p, a), (_, b) in zip(T.flatten_with_path(t),
                              T.flatten_with_path(got)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), p
        else:
            assert a == b and type(a) is type(b), p
    manifest = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert manifest["step"] == 7
    assert "opt__step" in manifest["leaves"]
    assert manifest["leaves"]["e__0"]["dtype"] == "float32"


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    entries = os.listdir(tmp_path)
    assert "step_00000001" in entries
    assert not any(e.endswith(".tmp") for e in entries)


def test_checkpoint_gc_keeps_last_three(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, _tree())
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004", "step_00000005"]


def test_async_checkpointer_and_its_errors(tmp_path):
    ck = ckpt.AsyncCheckpointer(str(tmp_path / "ok"))
    for s in (1, 2):
        ck.save(s, _tree())
    ck.wait()
    assert ckpt.latest_step(str(tmp_path / "ok")) == 2
    ck.close()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = ckpt.AsyncCheckpointer(str(blocker))
    bad.save(1, _tree())
    with pytest.raises(OSError):
        bad.wait()
    with pytest.raises(OSError):
        bad.save(2, _tree())


# ------------------------------------------------------------------ CLI

def test_cli_smoke_on_the_cpu(capsys):
    out = tlaunch.main(["--arch", "gemma2-2b", "--smoke", "--steps", "3",
                        "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


def test_cli_refuses_what_is_not_ported(capsys):
    """A tensor-parallel mesh (9.8) and the frontend archs (9.6) raise,
    naming their ROADMAP items.  falcon-mamba-7b, which raised naming 9.10
    until K9 had a backward, trains."""
    with pytest.raises(NotImplementedError, match="9.8"):
        tlaunch.main(["--arch", "gemma2-2b", "--smoke", "--tp", "2",
                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="9.6"):
        tlaunch.main(["--arch", "musicgen-medium", "--smoke", "--device",
                      "cpu"])
    out = tlaunch.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                        "cpu", "--steps", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(get_config("gemma2-2b", smoke=True), TrainSettings(steps=1))
    assert ttrain.TrainSettings().ckpt_dir.endswith("repro_torch_ckpt")
