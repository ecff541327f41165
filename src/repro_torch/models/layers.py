"""Shared layers: RMSNorm, the MLP, embeddings (the plain take and the
Roomy bucket exchange on a mesh) and the LM head.

Port of ``repro/models/layers.py``.  Initialization
follows the reference's distributions on an explicit ``torch.Generator``:
fan-in truncated normal (±2σ) for projections and the untied LM head,
N(0, 0.02²) for the embedding table, zeros for norm gains (applied as
``1 + gain``).  The two packages draw different numbers from one seed, so
the tests carry the reference's params across with
``convert.lm_params_from_jax``.

Params may be stored in float32 or in the compute dtype; every layer casts
to ``cdtype(cfg)`` at use, which is a no-op for params already stored in
it (casting once gives the same values as casting at each use).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import delayed as roomy_delayed
from ..core import sharding as SH
from ..kernels import ops as kops
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


def embed_tokens(p: dict, ids: torch.Tensor, cfg: ModelConfig,
                 mesh=None) -> torch.Tensor:
    """ids (B, S) → (B, S, d).  A plain row take of the table; or, under
    ``embedding_dispatch="roomy"`` on a mesh with a ``model`` axis whose
    tokens tile the device grid, the explicit bucket exchange
    (``_roomy_embed``), as ``repro/models/layers.py:84-97``.  The grid is
    every axis for global ids (serving), ``model`` alone for a data
    rank's rows (training; ``core/sharding.py``'s two conventions)."""
    if cfg.embedding_dispatch == "roomy" and mesh is not None \
            and "model" in SH.mesh_axes(mesh):
        n_dev = SH.axis_size(mesh, SH.token_axes(mesh))
        if ids.numel() % n_dev == 0:
            return _roomy_embed(p["table"], ids, cfg, mesh).to(cdtype(cfg))
    return p["table"][ids].to(cdtype(cfg))


class _OwnerRows(torch.autograd.Function):
    """The owner's row gather of the roomy embedding: ``table_loc[local]``
    forward.  Backward, the paper's delayed update: the received gradient
    rows fold into a zero float32 gradient of the owner's striped shard
    through ``ops.bucket_scatter_add`` (K5 on the card, its plain version
    on the CPU), rows not valid sent to an index K5 drops (past the
    shard).  K5 may sum a row's duplicates in another order than the plain
    version, so on the card the table gradient matches the plain fold
    within K5's tolerance, not bit for bit."""

    @staticmethod
    def forward(ctx, table_loc, local, valid, impl):
        ctx.save_for_backward(local, valid)
        ctx.rows, ctx.impl = table_loc.shape[0], impl
        return table_loc[local]

    @staticmethod
    def backward(ctx, g):
        local, valid = ctx.saved_tensors
        idx = torch.where(valid, local, ctx.rows).reshape(-1).to(torch.int32)
        zero = g.new_zeros((ctx.rows, g.shape[-1]), dtype=torch.float32)
        fold = kops.bucket_scatter_add(
            zero, idx, g.reshape(-1, g.shape[-1]).float(), impl=ctx.impl)
        return fold, None, None, None


def _roomy_embed(table: torch.Tensor, ids: torch.Tensor, cfg: ModelConfig,
                 mesh) -> torch.Tensor:
    """The explicit Roomy gather: each rank's tokens issue delayed
    accesses to the vocab-sharded table; one all-to-all each way over the
    ``model`` group resolves them.

    Ownership is striped (owner = id mod S, S the model axis), so row r of
    shard s holds id r·S + s and frequent low ids spread over the shards;
    buckets carry 4× the uniform per-owner load, ``max(8, min(t_loc,
    4·ceil(t_loc / S)))`` for t_loc tokens a rank; an overflowing token
    embeds as zeros, as in the reference.  Under the global convention ids
    are (B, S) on every rank: this rank takes its block of the B·S tokens
    split over every axis (data axes, then ``model``), and the blocks are
    gathered back, so every rank returns the whole (B, S, d).  Under the
    local one ids are this data rank's rows, split and gathered over
    ``model`` alone.  Differentiable in ``table``: the owner's gather is
    ``_OwnerRows``, whose backward folds the gradient rows through K5."""
    s_model = SH.mesh_axes(mesh)["model"]
    group, m_idx, _ = SH.axis_group(mesh, "model")
    shard_axes = SH.token_axes(mesh)
    rows_per = -(-cfg.vocab_padded // s_model)
    b, s = ids.shape
    n_dev = SH.axis_size(mesh, shard_axes)
    t_loc = max(1, (b * s) // n_dev)
    capacity = max(8, min(t_loc, 4 * (-(-t_loc // s_model))))
    # the striped shard: row r of shard m_idx is vocab id r·S + m_idx
    table_loc = _pad_rows(table, rows_per * s_model).view(
        rows_per, s_model, -1)[:, m_idx]
    flat = SH.shard_leading(ids.reshape(b * s), mesh, shard_axes)
    dest = (flat % s_model).to(torch.int32)
    valid = torch.ones_like(flat, dtype=torch.bool)

    def owner_fn(recv, recv_valid):
        # recv: (S, C, 1) global ids; the striped layout → local row id // S
        local = (recv[..., 0] // s_model).clamp(max=table_loc.shape[0] - 1)
        return _OwnerRows.apply(table_loc, local.long(), recv_valid,
                                cfg.kernels)

    out, ok, _ = roomy_delayed.bucket_sync_access(
        dest, flat[:, None].to(torch.int32), valid, group, s_model,
        capacity, owner_fn)
    out = torch.where(ok[:, None], out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))
    return SH.gather_leading(out, mesh, shard_axes).reshape(b, s, -1)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, n - x.shape[0]))


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
