"""Port parity: the MoE family (granite-moe-3b-a800m: 40 experts padded to
48, top-8; phi3.5-moe-42b-a6.6b: 16 experts, top-2, untied head) against
the JAX package, at the SMOKE sizes in float32.

The reference's params cross over with ``convert.lm_params_from_jax``.
Bit for bit: the router's expert ids (and its top values on the same
logits, ties broken towards the lower index as ``jax.lax.top_k`` breaks
them), the slots and keep mask of the capacity buckets, the capacity, the
configs' ``param_count`` and ``active_param_count``.  The router weights
are a softmax of the top values: XLA's ``exp`` and torch's differ in the
last bit, so on the same logits the weights are held to 4 ulps, and from
the same inputs (the router matmul sums in another order) to 1e-4.
Within atol = rtol = 1e-4: the index-form ``moe_einsum``
against the reference's and against the port's one-hot plain version
(``ref.moe_einsum_onehot``), with and without dropped pairs; forward,
prefill logits and caches, decode.  The Server's greedy tokens are
identical to JAX's.  Prefill-then-decode ≡ stepwise decode at 2e-3 (as
``tests/test_models.py:171-200`` holds the reference) runs at a capacity
that drops nothing: a decode step's capacity is its own (1 a row), so at
the reference's capacity the two differ by design, as in the reference;
the drops there are held to JAX's instead.  Inputs come from numpy seeds.

Training: ``moe_einsum``'s gradients (the input, the router weights, the
router and the experts) against autograd of the one-hot plain version,
with dropped pairs present: within 1e-4, and exactly 0 where the one-hot
form gives 0 (a dropped pair's weight, whose row lands on the spare row
no one reads).  The loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``, remat on and off,
within the dense families' tolerances (loss rtol 1e-5, each leaf ‖Δ‖ ≤
1e-4 ‖g‖); the training entry points run and print a finite loss.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.runtime import Request as JRequest
from repro.runtime import Server as JServer
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_to_torch
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import blocks, lm, moe
from repro_torch.runtime import Request, Server

ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 12
# The reference's own counts of each FULL config.
PARAMS = {"granite-moe-3b-a800m": (3_298_793_472, 882_874_368),
          "phi3.5-moe-42b-a6.6b": (41_872_527_360, 6_640_373_760)}
NO_DROPS = 8.0                # a capacity_factor under which nothing drops


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


def _layer(jp, tp, i=0):
    """Layer i's moe params in each package."""
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["moe"]),
            tp["blocks"][i]["moe"])


def _x(cfg, b=3, s=17, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model), np.float32) * scale


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


def _jax_slots(ids, n_experts, cap):
    """The reference's slot assignment, as ``repro/models/moe.py:72-78``
    writes it inside ``moe_einsum``."""
    flat = ids.reshape(ids.shape[0], -1)
    oh = jax.nn.one_hot(flat, n_experts, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(oh, axis=1) * oh, axis=-1) - 1
    return np.asarray(slot), np.asarray((slot >= 0) & (slot < cap))


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_the_reference(arch):
    for smoke in (False, True):
        j, t = jget_config(arch, smoke), get_config(arch, smoke)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "n_experts", "top_k",
                  "moe_dispatch", "capacity_factor", "mlp_act", "mlp_gated",
                  "tie_embeddings", "dtype", "rms_eps", "rope_theta",
                  "vocab_padded", "experts_padded", "is_moe"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    full = get_config(arch)
    assert (full.param_count(), full.active_param_count()) == PARAMS[arch]
    assert not get_config("gemma2-2b").is_moe
    assert get_config("gemma2-2b").experts_padded == 0


def test_init_params_layout_matches_the_reference(model):
    """The port's own init has the reference's leaves and shapes (the
    padded experts included), fan-in scaled over d for up and gate and
    over d_ff for down."""
    jcfg, cfg, jp, tp = model
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = lambda p: jax.tree.map(np.shape, jax.tree.map(  # noqa: E731
        np.asarray, p))
    assert shapes(tp) == shapes(mine)
    blk = mine["blocks"][1]
    assert "mlp" not in blk and sorted(blk["moe"]) == ["down", "gate",
                                                       "router", "up"]
    e, d, ff = cfg.experts_padded, cfg.d_model, cfg.d_ff
    assert blk["moe"]["up"].shape == (e, d, ff)
    assert blk["moe"]["down"].shape == (e, ff, d)
    assert float(blk["moe"]["up"].abs().max()) <= 2 / d ** 0.5
    assert float(blk["moe"]["down"].abs().max()) <= 2 / ff ** 0.5
    n = sum(t.numel() for t in jax.tree.leaves(mine))
    pad_vocab = (cfg.vocab_padded - cfg.vocab_size) * d
    pad_experts = cfg.n_layers * (e - cfg.n_experts) * (
        cfg._expert_params() + d)
    assert n == cfg.param_count() + pad_vocab * (
        1 if cfg.tie_embeddings else 2) + pad_experts
    for k, v in tp["blocks"][1]["moe"].items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jp["blocks"]["moe"][k][1]))


# -------------------------------------------------------------- router

@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_route_ids_match_jax_bit_for_bit(model, scale):
    jcfg, cfg, jp, tp = model
    jm, tm = _layer(jp, tp, 1)
    x = _x(cfg, seed=3, scale=scale)
    jw, jids = jmoe._route(jm, jnp.asarray(x), jcfg)
    tw, tids = moe._route(tm, torch.from_numpy(x), cfg)
    assert tids.dtype == torch.int32 and tids.shape == (3, 17, cfg.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tw.dtype == torch.float32
    _close(tw, jw)
    assert bool((tids < cfg.n_experts).all())
    # on the same logits the top values are the same bits, and their
    # softmax within 4 ulps (XLA's exp and torch's differ in the last bit)
    logits = np.array(jnp.asarray(x) @ jm["router"])
    logits[..., cfg.n_experts:] = -np.inf
    jtop, jtid = jax.lax.top_k(jnp.asarray(logits), cfg.top_k)
    ttop, ttid = moe.top_k(torch.from_numpy(logits), cfg.top_k)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(ttid.numpy(), np.asarray(jtid))
    np.testing.assert_array_max_ulp(torch.softmax(ttop, -1).numpy(),
                                    np.asarray(jax.nn.softmax(jtop, -1)),
                                    maxulp=4)


def test_top_k_breaks_ties_towards_the_lower_index():
    """Equal logits come out in ascending expert order, as
    ``jax.lax.top_k`` returns them; the order within k sets the slots."""
    rng = np.random.default_rng(5)
    logits = rng.integers(0, 3, (64, 48)).astype(np.float32)
    logits[0] = 1.0                                       # all tied
    logits[1, 40:] = -np.inf                              # dead experts
    for k in (1, 2, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = moe.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert moe.top_k(torch.from_numpy(logits[:1]), 8)[1].tolist() == [
        list(range(8))]


def test_padded_experts_are_never_chosen():
    """granite-moe's SMOKE pads 5 experts to 16: a router whose padded
    columns dwarf the live ones still picks live experts only."""
    jcfg, cfg, jp, tp = _model("granite-moe-3b-a800m")
    assert (cfg.n_experts, cfg.experts_padded) == (5, 16)
    _, tm = _layer(jp, tp)
    tm = dict(tm, router=tm["router"].clone())
    tm["router"][:, cfg.n_experts:] = 1e6
    w, ids = moe._route(tm, torch.from_numpy(_x(cfg)), cfg)
    assert bool((ids < cfg.n_experts).all())
    assert sorted(set(ids[0, 0].tolist())) == sorted(ids[0, 0].tolist())
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


# --------------------------------------------------------------- slots

@pytest.mark.parametrize("s,factor", [(17, 1.25), (1, 1.25), (40, 0.5),
                                      (17, NO_DROPS)])
def test_slots_and_keep_match_the_reference_bit_for_bit(model, s, factor):
    jcfg, cfg, jp, tp = model
    cfg = cfg.replace(capacity_factor=factor)
    jm, tm = _layer(jp, tp)
    _, jids = jmoe._route(jm, jnp.asarray(_x(cfg, b=3, s=s, seed=4)), jcfg)
    _, tids = moe._route(tm, torch.from_numpy(_x(cfg, b=3, s=s, seed=4)),
                         cfg)
    slot, keep, cap = moe.dispatch_slots(tids, cfg)
    assert cap == max(1, int(math.ceil(s * cfg.top_k / cfg.experts_padded
                                       * factor)))
    want_slot, want_keep = _jax_slots(jids, cfg.experts_padded, cap)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if factor == NO_DROPS:
        assert bool(keep.all())
    if s == 40:
        assert not bool(keep.all())


def test_capacity_at_the_full_configs():
    """One slot a row at decode (granite: ceil(8/48 · 1.25) = 1), and the
    buckets of a 32768-token prefill row."""
    granite, phi = (get_config(a) for a in ARCHS)
    assert moe.capacity(1, granite) == moe.capacity(1, phi) == 1
    assert moe.capacity(32768, granite) == 6827
    assert moe.capacity(32768, phi) == 5120
    assert moe.capacity(4096, phi) == 640


# ------------------------------------------------------------- dispatch

@pytest.mark.parametrize("case", ["drops", "no_drops", "decode"])
def test_moe_einsum_matches_jax_and_the_onehot_plain_version(model, case):
    jcfg, cfg, jp, tp = model
    b, s, factor = {"drops": (3, 17, 1.25), "no_drops": (3, 17, NO_DROPS),
                    "decode": (4, 1, 1.25)}[case]
    jcfg, cfg = (c.replace(capacity_factor=factor) for c in (jcfg, cfg))
    jm, tm = _layer(jp, tp, 1)
    x = _x(cfg, b=b, s=s, seed=6, scale=2.0)
    got = moe.moe_einsum(tm, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, jmoe.moe_einsum(jm, jnp.asarray(x), jcfg))
    w, ids = moe._route(tm, torch.from_numpy(x), cfg)
    _, keep, cap = moe.dispatch_slots(ids, cfg)
    plain = R.moe_einsum_onehot(torch.from_numpy(x), w, ids,
                                cfg.experts_padded, cap,
                                lambda xin: moe._expert_ffn(tm, xin, cfg))
    _close(got, plain.numpy())
    dropped = int((~keep).sum())
    if case == "drops":
        assert dropped > 0
    else:
        assert dropped == 0


def test_index_dispatch_matches_the_onehot_form_in_bfloat16(model):
    """The card's dtype: the two forms round the combine's products the
    same way (bfloat16 weight times bfloat16 row, summed in float32)."""
    jcfg, cfg, jp, tp = model
    cfg = cfg.replace(dtype="bfloat16")
    _, tm = _layer(jp, tp)
    tm = {k: v.bfloat16() for k, v in tm.items()}
    x = torch.from_numpy(_x(cfg, seed=7, scale=2.0)).bfloat16()
    got = moe.moe_einsum(tm, x, cfg)
    assert got.dtype == torch.bfloat16
    w, ids = moe._route(tm, x, cfg)
    _, _, cap = moe.dispatch_slots(ids, cfg)
    plain = R.moe_einsum_onehot(x, w, ids, cfg.experts_padded, cap,
                                lambda xin: moe._expert_ffn(tm, xin, cfg))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_moe_follows_the_single_device_rule(model):
    """No mesh: einsum, as the reference without a mesh.  On a mesh whose
    device grid the tokens do not tile, or with the einsum dispatch, the
    reference's rule also runs einsum (``repro/models/moe.py:161-171``),
    touching no process group; the roomy dispatch on a mesh is held to
    the reference in ``test_torch_mesh.py``."""
    jcfg, cfg, jp, tp = model
    assert cfg.moe_dispatch == "roomy"
    jm, tm = _layer(jp, tp)
    x = _x(cfg, seed=8)
    got = moe.moe(tm, torch.from_numpy(x), cfg)
    _close(got, jmoe.moe(jm, jnp.asarray(x), jcfg, None))

    class Untiled:                        # a (1, B·S + 1) grid: no tiling
        shape = {"data": 1, "model": x.shape[0] * x.shape[1] + 1}
    assert torch.equal(moe.moe(tm, torch.from_numpy(x), cfg, Untiled()),
                       got)
    again = moe.moe(tm, torch.from_numpy(x), cfg.replace(
        moe_dispatch="einsum"), Untiled())
    assert torch.equal(got, again)


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
    td, tc2 = lm.decode_step(tp, {"tokens": torch.from_numpy(nxt).long(),
                                  "positions": torch.from_numpy(zeros)},
                             tc, cfg)
    _close(td, jd)
    for got, want in zip(tc2["kv"], convert.lm_caches_from_jax(
            jc2, cfg, "cpu")["kv"]):
        for g, w in zip(got, want):
            _close(g, w.numpy())


def _captured_moe_inputs(tp, tin, cfg):
    """Each layer's MoE input in a port prefill, and the prefill's
    logits."""
    seen = []
    orig = blocks.moe

    def wrapped(p, x, cfg_, group=None):
        seen.append(x.clone())
        return orig(p, x, cfg_, group)
    blocks.moe = wrapped
    try:
        logits, _ = lm.prefill(tp, tin, cfg)
    finally:
        blocks.moe = orig
    return seen, logits


def test_prefill_drops_match_jax_at_the_reference_capacity(model):
    """At the configs' capacity_factor 1.25 a prefill drops pairs: on each
    layer's MoE input the port's ids, slots and keep mask are JAX's, bit
    for bit, so it drops the same (token, choice) pairs; the logits agree."""
    jcfg, cfg, jp, tp = model
    _, jin, tin = _batch(cfg, seed=2)
    seen, logits = _captured_moe_inputs(tp, tin, cfg)
    assert len(seen) == cfg.n_layers
    total = 0
    for i, x in enumerate(seen):
        jm, tm = _layer(jp, tp, i)
        _, jids = jmoe._route(jm, jnp.asarray(x.numpy()), jcfg)
        _, tids = moe._route(tm, x, cfg)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        slot, keep, cap = moe.dispatch_slots(tids, cfg)
        want_slot, want_keep = _jax_slots(jids, cfg.experts_padded, cap)
        np.testing.assert_array_equal(slot.numpy(), want_slot)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
        total += int((~keep).sum())
    assert total > 0
    _close(logits, jlm.prefill(jp, jin, jcfg)[0])


def test_prefill_then_decode_equals_stepwise_decode(model):
    """At a capacity under which the prefill drops nothing (checked), the
    prefill and the stepwise decode route every pair alike."""
    _, cfg, _, tp = model
    cfg = cfg.replace(capacity_factor=NO_DROPS)
    b, s = 2, 10
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 1)))
    pos = torch.arange(s)[None].repeat(b, 1)
    seen, _ = _captured_moe_inputs(tp, {"tokens": toks[:, :s],
                                        "positions": pos}, cfg)
    for i, x in enumerate(seen):
        _, keep, _ = moe.dispatch_slots(moe._route(
            tp["blocks"][i]["moe"], x, cfg)[1], cfg)
        assert bool(keep.all())
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
    stand; every decode step routes each row in its own capacity group."""
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
def test_training_raises_naming_its_roadmap_item(arch, capsys):
    """Training the MoE family raised, naming ROADMAP item 9.13, until it
    was ported: ``loss_fn`` now gives the reference's loss, and the CLI
    trains SMOKE on the CPU to a finite final loss."""
    jcfg, cfg, jp, tp = _model(arch)
    _, jin, tin = _batch(cfg)
    loss = lm.loss_fn(tp, {"inputs": tin, "labels": tin["tokens"]}, cfg)
    jloss = jlm.loss_fn(jp, {"inputs": jin, "labels": jin["tokens"]}, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    out = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "3"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


# ------------------------------------------------------------ training

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach() - want).norm() / max(float(want.norm()),
                                                    1e-30))


def _leaf_copy(tree):
    return T.tree_map(lambda p: p.detach().clone().requires_grad_(True), tree)


def test_moe_einsum_gradient_matches_the_onehot_form(model, monkeypatch):
    """With dropped pairs: the index form's gradients equal the one-hot
    form's under autograd, for the input, the router and the experts; and
    for the router weights given as a leaf, exactly 0 at every dropped
    pair (the one-hot's 0), the rest within 1e-4."""
    jcfg, cfg, jp, tp = model
    _, tm = _layer(jp, tp, 1)
    xn = _x(cfg, b=3, s=17, seed=8, scale=2.0)
    dy = torch.from_numpy(_x(cfg, b=3, s=17, seed=9))
    grads = {}
    for form in ("index", "onehot"):
        p = _leaf_copy(tm)
        x = torch.from_numpy(xn).requires_grad_(True)
        w, ids = moe._route(p, x, cfg)
        _, keep, cap = moe.dispatch_slots(ids, cfg)
        if form == "index":
            out = moe.moe_einsum(p, x, cfg)
        else:
            out = R.moe_einsum_onehot(x, w, ids, cfg.experts_padded, cap,
                                      lambda xin: moe._expert_ffn(p, xin,
                                                                  cfg))
        grads[form] = dict(zip(["x"] + sorted(p), torch.autograd.grad(
            out, [x] + [p[k] for k in sorted(p)], dy)))
    assert not bool(keep.all())                  # dropped pairs present
    for k, want in grads["onehot"].items():
        got = grads["index"][k]
        assert _rel(got, want) <= 1e-4, k
        assert bool((got[want == 0] == 0).all()), k
    # the router weights as a leaf: a dropped pair's weight gets exactly 0
    w, ids = moe._route(tm, torch.from_numpy(xn), cfg)
    dws = {}
    for form in ("index", "onehot"):
        wl = w.detach().clone().requires_grad_(True)
        if form == "index":
            monkeypatch.setattr(moe, "_route", lambda *a: (wl, ids))
            out = moe.moe_einsum(tm, torch.from_numpy(xn), cfg)
            monkeypatch.undo()
        else:
            out = R.moe_einsum_onehot(torch.from_numpy(xn), wl, ids,
                                      cfg.experts_padded, cap,
                                      lambda xin: moe._expert_ffn(tm, xin,
                                                                  cfg))
        (dws[form],) = torch.autograd.grad(out, [wl], dy)
    dropped = ~keep.reshape(ids.shape)
    for dw in dws.values():
        assert bool((dw[dropped] == 0).all())
        assert bool((dw[~dropped] != 0).all())
    _close(dws["index"], dws["onehot"].numpy())


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grad_match_jax(model, remat):
    jcfg, cfg, jp, _ = model
    cfg = cfg.replace(remat=remat)
    batch = jmake_batch(jcfg, 3, 0, B, 24)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    params = _leaf_copy(convert.lm_params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, "cpu"))
    loss = lm.loss_fn(params, batch_to_torch(batch, "cpu"), cfg)
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                      "cpu")
    pairs = list(zip(T.flatten_with_path(want), grads))
    assert len(pairs) == len(T.leaves(params))
    for (path, w), g in pairs:
        assert _rel(g, w) <= 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_default_device_raises_without_a_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = get_config(arch, smoke=True)
    for call in (lambda: lm.init_params(cfg, 0),
                 lambda: lm.make_cache(cfg, 1, 8),
                 lambda: Server(cfg, _model(arch)[3]),
                 lambda: tserve.main(["--arch", arch, "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
