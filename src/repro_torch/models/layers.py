"""Shared layers: RMSNorm, the MLP, embeddings and the LM head.

Port of ``repro/models/layers.py`` for the dense path.  Initialization
follows the reference's distributions on an explicit ``torch.Generator``:
fan-in truncated normal (±2σ) for projections and the untied LM head,
N(0, 0.02²) for the embedding table, zeros for norm gains (applied as
``1 + gain``).  The two packages draw different numbers from one seed, so
the tests carry the reference's params across with
``convert.lm_params_from_jax``.

Params may be stored in float32 or in the compute dtype; every layer casts
to ``cdtype(cfg)`` at use, which is a no-op for params already stored in
it (casting once gives the same values as casting at each use).  The
mesh-only embedding path of the reference (``_roomy_embed``) waits for
``distributed/``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, *, device, dtype,
               in_axis: int = 0) -> torch.Tensor:
    """Truncated normal on [-2, 2], divided by sqrt(fan_in =
    shape[in_axis]); drawn in float32, then cast."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(shape[in_axis])).to(dtype)


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gain.float())
    return out.to(x.dtype)


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ------------------------------------------------------------------- MLP

def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, device,
             dtype) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    p = {"up": dense_init(gen, (d, ff), **kw),
         "down": dense_init(gen, (ff, d), **kw)}
    if cfg.mlp_gated:
        p["gate"] = dense_init(gen, (d, ff), **kw)
    return p


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    act = _act(cfg.mlp_act)
    h = x @ p["up"].to(dt)
    if cfg.mlp_gated:
        h = act(x @ p["gate"].to(dt)) * h
    else:
        h = act(h)
    return h @ p["down"].to(dt)


# ------------------------------------------------------------ embeddings

def init_embedding(gen: torch.Generator, cfg: ModelConfig, *, device,
                   dtype) -> dict:
    e = torch.empty((cfg.vocab_padded, cfg.d_model), dtype=torch.float32,
                    device=device)
    e.normal_(0.0, 1.0, generator=gen)
    p = {"table": (e * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_padded),
                               device=device, dtype=dtype)
    return p


def embed_tokens(p: dict, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """ids (B, S) → (B, S, d): a plain row take of the table."""
    return p["table"][ids].to(cdtype(cfg))


def lm_head(p_embed: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits against the tied embedding table, or the untied ``head``
    (d, vocab_padded), softcapped; the pad rows past ``vocab_size`` are
    -1e30."""
    w = (p_embed["table"].to(cdtype(cfg)).T if cfg.tie_embeddings
         else p_embed["head"].to(cdtype(cfg)))
    logits = x @ w
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.vocab_padded != cfg.vocab_size:      # mask pad-to-shard rows
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=x.device), logits)
    return logits
