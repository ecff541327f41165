"""Model assembly: init, forward, prefill, decode — the dense family (with
gemma2's alternating local/global layers, and the untied LM head of
nemotron), the MoE family (granite-moe, phi3.5-moe: the dense block with
``models/moe.py`` for its MLP), the ssm family (falcon-mamba, mamba1
blocks over K9) and the hybrid family (zamba2: mamba2 blocks with one
shared attention block between segments of them).

Port of ``repro/models/lm.py``.  Entry points:

  init_params(cfg, gen, device=, dtype=)      → params
  forward_hidden(params, inputs, cfg)         → (B, S, d)
  logits_fn(params, hidden, cfg)              → (B, S, vocab_padded)
  loss_fn(params, batch, cfg)                 → scalar mean cross-entropy
  prefill(params, inputs, cfg, max_len=)      → (last logits (B, 1, V), caches)
  decode_step(params, inputs, caches, cfg,
              donate=False)                   → (logits (B, 1, V), caches)
  make_cache(cfg, batch, max_len, device=)    → empty caches

``inputs``: {"tokens": (B, S) integer, "positions": (B, S) integer}.
Layout: the reference stacks its blocks and caches over layers ((L, …),
or (L/2, 2, …) local/global pairs for gemma2) to scan over them; the port
runs eagerly and keeps one entry per layer, in order: ``params["blocks"]``
is a list of L block dicts, and ``caches["kv"]`` a list of L ``PagedKV``
(``caches["ssm"]`` a list of L ``SSMState`` for the ssm family).
With ``cfg.local_global_pattern`` the even layers are local (sliding
window ``cfg.local_window``) and the odd ones global.  The hybrid family
has ``params["shared"]``, one transformer block, run after each segment
of ``_hybrid_segments`` that asks for it, and caches {"ssm": one
``SSMState`` a mamba2 layer, "kv": one ``PagedKV`` an application of the
shared block}.
``convert.lm_params_from_jax`` / ``lm_caches_from_jax`` carry the
reference's stacked pytrees across.

The frontend families raise ``NotImplementedError`` naming the ROADMAP
item that ports them.  Every other family trains: ``loss_fn``'s gradient
runs through K6-with-LSE and K7 (attention) and K9 and K9-bwd (the
selective scan) on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..core import paged
from .blocks import (init_mamba_block, init_transformer_block, mamba_block,
                     mamba_block_decode, mamba_block_prefill,
                     transformer_block, transformer_block_decode)
from .config import ModelConfig
from .layers import cdtype, embed_tokens, init_embedding, lm_head, rms_norm
from .ssm import init_ssm_state

PAGE_SIZE = 128

_NOT_PORTED = {"audio": "9.6 (frontend stubs)", "vlm": "9.6 (frontend stubs)"}


def _ported(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet: ROADMAP item {_NOT_PORTED[cfg.family]}")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a family whose training is not ported: the frontend
    families (audio, vlm), which are not ported at all.  The dense, MoE,
    ssm and hybrid families train."""
    _ported(cfg)


def _hybrid_segments(cfg: ModelConfig):
    """[(start, end, apply_shared_after)] covering all layers
    (``repro/models/lm.py:39-50``)."""
    k = cfg.shared_attn_every
    segs, start = [], 0
    for i in range(cfg.n_layers):
        if k and (i + 1) % k == 0:
            segs.append((start, i + 1, True))
            start = i + 1
    if start < cfg.n_layers:
        segs.append((start, cfg.n_layers, False))
    return segs


def n_shared_applications(cfg: ModelConfig) -> int:
    return sum(1 for *_, shared in _hybrid_segments(cfg) if shared)


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Each layer's sliding window: local (even) layers of the gemma2
    pattern get ``cfg.local_window``, every other layer None (global)."""
    return [cfg.local_window if cfg.local_global_pattern and i % 2 == 0
            else None for i in range(cfg.n_layers)]


# ---------------------------------------------------------------- init

def init_params(cfg: ModelConfig, gen, *, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random params on ``device`` (default "cuda"), stored in ``dtype``.
    ``gen`` is a ``torch.Generator`` on that device, or an int seed."""
    _ported(cfg)
    if cfg.local_global_pattern and cfg.n_layers % 2:
        raise ValueError("the local/global pattern needs an even n_layers")
    dev = _device.resolve(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    kw = dict(device=dev, dtype=dtype)
    params = {"embed": init_embedding(gen, cfg, **kw),
              "final_norm": torch.zeros((cfg.d_model,), **kw)}
    if cfg.family in ("ssm", "hybrid"):
        version = 1 if cfg.family == "ssm" else 2
        params["blocks"] = [init_mamba_block(gen, cfg, version=version, **kw)
                            for _ in range(cfg.n_layers)]
    else:
        params["blocks"] = [init_transformer_block(gen, cfg, **kw)
                            for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        params["shared"] = init_transformer_block(gen, cfg, **kw)
    return params


# ------------------------------------------------------------- forward

def _embed(params, inputs: Dict, cfg: ModelConfig) -> torch.Tensor:
    x = embed_tokens(params["embed"], inputs["tokens"], cfg)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def forward_hidden(params, inputs: Dict, cfg: ModelConfig) -> torch.Tensor:
    """With ``cfg.remat`` and grad mode on, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    and recomputed in the backward, as the reference's ``_maybe_remat``
    does with ``jax.checkpoint`` (``repro/models/lm.py:120-121,148-159``):
    every transformer block, and every mamba block of the ssm and hybrid
    families.  The hybrid's shared block runs after each segment that asks
    for it, never rematted, as in the reference."""
    _ported(cfg)
    x = _embed(params, inputs, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    if cfg.family in ("ssm", "hybrid"):
        version = 1 if cfg.family == "ssm" else 2

        def body(p_l, x):
            if remat:
                return checkpoint(mamba_block, p_l, x, cfg, version=version,
                                  use_reentrant=False)
            return mamba_block(p_l, x, cfg, version=version)
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l in params["blocks"][s0:s1]:
                x = body(p_l, x)
            if shared:
                x = transformer_block(params["shared"], x,
                                      inputs["positions"], cfg)
        return rms_norm(x, params["final_norm"], cfg.rms_eps)
    for p_l, w in zip(params["blocks"], layer_windows(cfg)):
        if remat:
            x = checkpoint(transformer_block, p_l, x, inputs["positions"],
                           cfg, window=w, use_reentrant=False)
        else:
            x = transformer_block(p_l, x, inputs["positions"], cfg, window=w)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def logits_fn(params, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return lm_head(params["embed"], hidden, cfg)


def loss_fn(params, batch: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is >= 0, on
    float32 logits (``repro/models/lm.py:192-216`` on one device).
    ``batch``: {"inputs": {"tokens", "positions"}, "labels": (B, S)}."""
    check_trainable(cfg)
    hidden = forward_hidden(params, batch["inputs"], cfg)
    logits = logits_fn(params, hidden, cfg).float()
    labels = batch["labels"].long()
    mask = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


# ------------------------------------------------------ caches / decode

def _round_len(max_len: int) -> int:
    return -(-max_len // PAGE_SIZE) * PAGE_SIZE


def _kv_to_pages(k, v, max_len: int, cfg: ModelConfig):
    """(B, S, kvh, hd) → (B·pps, ps, kvh, hd) pages under the identity
    table: a pad to max_len and a reshape, no scatter."""
    b, s, kvh, hd = k.shape
    pad = max_len - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    shape = (b * (max_len // PAGE_SIZE), PAGE_SIZE, kvh, hd)
    return (k.reshape(shape).to(cdtype(cfg)),
            v.reshape(shape).to(cdtype(cfg)))


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Empty decode caches: one ``PagedKV`` per layer; for the ssm family
    one zero ``SSMState`` per layer (``max_len`` unused); for the hybrid
    family one mamba2 ``SSMState`` per layer and one ``PagedKV`` per
    application of the shared block."""
    _ported(cfg)
    dev = _device.resolve(device)
    max_len = _round_len(max_len)

    def kv(n):
        return [paged.make(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                           page_size=PAGE_SIZE, dtype=cdtype(cfg), device=dev)
                for _ in range(n)]
    if cfg.family in ("ssm", "hybrid"):
        version = 1 if cfg.family == "ssm" else 2
        caches = {"ssm": [init_ssm_state(cfg, batch, dev, version)
                          for _ in range(cfg.n_layers)]}
        if cfg.family == "hybrid":
            caches["kv"] = kv(n_shared_applications(cfg))
        return caches
    return {"kv": kv(cfg.n_layers)}


def prefill(params, inputs: Dict, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Full forward that builds the decode caches; returns (logits of the
    last position (B, 1, V), caches).  For the ssm family the caches are
    each layer's ``SSMState`` after the prompt (K9's final state and the
    conv's last inputs); ``max_len`` is unused.  The hybrid family's are
    each mamba2 layer's ``SSMState`` and each shared-block application's
    ``PagedKV``."""
    _ported(cfg)
    x = _embed(params, inputs, cfg)
    if cfg.family == "ssm":
        states = []
        for p_l in params["blocks"]:
            x, st = mamba_block_prefill(p_l, x, cfg)
            states.append(st)
        hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states}
    b, s = x.shape[0], x.shape[1]
    max_len = _round_len(max_len or s)
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    table = paged.identity_table(b, max_len // PAGE_SIZE, x.device)
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)

    def attend(p_l, x, window=None):
        x, (k, v) = transformer_block(p_l, x, inputs["positions"], cfg,
                                      window=window, return_kv=True)
        kp, vp = _kv_to_pages(k, v, max_len, cfg)
        return x, paged.PagedKV(kp, vp, table, lengths)
    caches = []
    if cfg.family == "hybrid":
        states = []
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l in params["blocks"][s0:s1]:
                x, st = mamba_block_prefill(p_l, x, cfg, version=2)
                states.append(st)
            if shared:
                x, c = attend(params["shared"], x)
                caches.append(c)
        hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states, "kv": caches}
    for p_l, w in zip(params["blocks"], layer_windows(cfg)):
        x, c = attend(p_l, x, w)
        caches.append(c)
    hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return logits_fn(params, hidden, cfg), {"kv": caches}


def decode_step(params, inputs: Dict, caches, cfg: ModelConfig, *,
                donate: bool = False):
    """One-token step.  inputs: {"tokens": (B, 1)}; rope positions come
    from the caches' lengths.  Returns (logits (B, 1, V), new caches);
    the caches passed in are left as they were, unless ``donate``: then
    each layer's new K/V row is written into the pages passed in (the
    returned caches share them), as the reference's decode step donates
    its caches to ``jit`` (``repro/launch/dryrun.py:188-191``), so a step
    holds one copy of the cache and moves none of it.  Every unwindowed
    attention layer reads its cache with K8 (the hybrid's shared block
    once per application, each over its own cache)."""
    _ported(cfg)
    x = _embed(params, inputs, cfg)
    if cfg.family == "ssm":
        states = []
        for p_l, st in zip(params["blocks"], caches["ssm"]):
            x, st = mamba_block_decode(p_l, x, st, cfg)
            states.append(st)
        hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states}
    if cfg.family == "hybrid":
        states, new = [], []
        kv = iter(caches["kv"])
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l, st in zip(params["blocks"][s0:s1],
                               caches["ssm"][s0:s1]):
                x, st = mamba_block_decode(p_l, x, st, cfg, version=2)
                states.append(st)
            if shared:
                x, c = transformer_block_decode(params["shared"], x,
                                                next(kv), cfg, donate=donate)
                new.append(c)
        hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states, "kv": new}
    new = []
    for p_l, c, w in zip(params["blocks"], caches["kv"], layer_windows(cfg)):
        x, c = transformer_block_decode(p_l, x, c, cfg, window=w,
                                        donate=donate)
        new.append(c)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return logits_fn(params, hidden, cfg), {"kv": new}
