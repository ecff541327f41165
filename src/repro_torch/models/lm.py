"""Model assembly: init, forward, prefill, decode — the dense family, with
gemma2's alternating local/global layers.

Port of ``repro/models/lm.py``.  Entry points:

  init_params(cfg, gen, device=, dtype=)      → params
  forward_hidden(params, inputs, cfg)         → (B, S, d)
  logits_fn(params, hidden, cfg)              → (B, S, vocab_padded)
  loss_fn(params, batch, cfg)                 → scalar mean cross-entropy
  prefill(params, inputs, cfg, max_len=)      → (last logits (B, 1, V), caches)
  decode_step(params, inputs, caches, cfg)    → (logits (B, 1, V), caches)
  make_cache(cfg, batch, max_len, device=)    → empty caches

``inputs``: {"tokens": (B, S) integer, "positions": (B, S) integer}.
Layout: the reference stacks its blocks and caches over layers ((L, …),
or (L/2, 2, …) local/global pairs for gemma2) to scan over them; the port
runs eagerly and keeps one entry per layer, in order: ``params["blocks"]``
is a list of L block dicts and ``caches["kv"]`` a list of L ``PagedKV``.
With ``cfg.local_global_pattern`` the even layers are local (sliding
window ``cfg.local_window``) and the odd ones global.
``convert.lm_params_from_jax`` / ``lm_caches_from_jax`` carry the
reference's stacked pytrees across.

The ssm, hybrid, MoE and frontend families raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..core import paged
from .blocks import (init_transformer_block, transformer_block,
                     transformer_block_decode)
from .config import ModelConfig
from .layers import cdtype, embed_tokens, init_embedding, lm_head, rms_norm

PAGE_SIZE = 128

_NOT_PORTED = {"ssm": "9.3 (models/ssm.py over K9)",
               "moe": "9.4 (models/moe.py over core/delayed)",
               "hybrid": "9.5 (hybrid mamba2 + shared attention)",
               "audio": "9.6 (frontend stubs)", "vlm": "9.6 (frontend stubs)"}


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet: ROADMAP item {_NOT_PORTED[cfg.family]}")


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
    _dense_only(cfg)
    if cfg.local_global_pattern and cfg.n_layers % 2:
        raise ValueError("the local/global pattern needs an even n_layers")
    dev = _device.resolve(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    kw = dict(device=dev, dtype=dtype)
    return {"embed": init_embedding(gen, cfg, **kw),
            "blocks": [init_transformer_block(gen, cfg, **kw)
                       for _ in range(cfg.n_layers)],
            "final_norm": torch.zeros((cfg.d_model,), **kw)}


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
    does with ``jax.checkpoint`` (``repro/models/lm.py:120-121``)."""
    _dense_only(cfg)
    x = _embed(params, inputs, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
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
    """Empty decode caches: one ``PagedKV`` per layer."""
    _dense_only(cfg)
    dev = _device.resolve(device)
    max_len = _round_len(max_len)
    return {"kv": [paged.make(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                              page_size=PAGE_SIZE, dtype=cdtype(cfg),
                              device=dev)
                   for _ in range(cfg.n_layers)]}


def prefill(params, inputs: Dict, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Full forward that builds the decode caches; returns (logits of the
    last position (B, 1, V), caches)."""
    _dense_only(cfg)
    x = _embed(params, inputs, cfg)
    b, s = x.shape[0], x.shape[1]
    max_len = _round_len(max_len or s)
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    table = paged.identity_table(b, max_len // PAGE_SIZE, x.device)
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    caches = []
    for p_l, w in zip(params["blocks"], layer_windows(cfg)):
        x, (k, v) = transformer_block(p_l, x, inputs["positions"], cfg,
                                      window=w, return_kv=True)
        kp, vp = _kv_to_pages(k, v, max_len, cfg)
        caches.append(paged.PagedKV(kp, vp, table, lengths))
    hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return logits_fn(params, hidden, cfg), {"kv": caches}


def decode_step(params, inputs: Dict, caches, cfg: ModelConfig):
    """One-token step.  inputs: {"tokens": (B, 1)}; rope positions come
    from the caches' lengths.  Returns (logits (B, 1, V), new caches);
    the caches passed in are left as they were."""
    _dense_only(cfg)
    x = _embed(params, inputs, cfg)
    new = []
    for p_l, c, w in zip(params["blocks"], caches["kv"], layer_windows(cfg)):
        x, c = transformer_block_decode(p_l, x, c, cfg, window=w)
        new.append(c)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return logits_fn(params, hidden, cfg), {"kv": new}
