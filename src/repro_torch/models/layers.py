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

Serving and training on a mesh hand the layers each model rank's param
shards (``core/sharding.py``'s ``MeshView``, ``model_shards``), and
each layer splits its compute where ``sharding_rules.model_dim`` says its
weight is split (``tp_dim``): the MLP column-parallel in ``up`` /
``gate`` and row-parallel in ``down``, joined by one all-reduce over
``model`` (under autograd its backward is the all-reduce of the
gradient); the embedding's take and the LM head vocab-parallel on the
rank's vocab block of ``table`` (or ``head``), or, where the vocab does
not split and the rules put ``d`` over ``model`` instead, a row-parallel
product over the rank's block of ``d``.  The loss keeps the LM head's
vocab columns on their rank (``lm_head(..., gather=False)``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import delayed as roomy_delayed
from ..core import sharding as SH
from ..distributed import sharding_rules as SR
from ..kernels import ops as kops
from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def tp_dim(cfg: ModelConfig, mesh, leaf: str):
    """The dim of ``leaf`` (``sharding_rules.model_dim``'s names) split
    over ``model`` where the layers hold model shards (serving or training
    on a mesh), else None: the layer runs on the whole weight."""
    if not SH.model_shards(mesh):
        return None
    return SR.model_dim(cfg, mesh, leaf)


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


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
        mesh=None) -> torch.Tensor:
    """The (gated) MLP; where ``down`` is split over ``model`` (so are
    ``up`` and ``gate``: one role) each rank runs its ff columns and the
    partials join by one all-reduce."""
    dt = cdtype(cfg)
    act = _act(cfg.mlp_act)
    h = x @ p["up"].to(dt)
    if cfg.mlp_gated:
        h = act(x @ p["gate"].to(dt)) * h
    else:
        h = act(h)
    out = h @ p["down"].to(dt)
    if tp_dim(cfg, mesh, "mlp/down") is not None:
        out = SH.all_reduce(out, mesh, "model")
    return out


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
    rank's rows (training; ``core/sharding.py``'s two conventions).  With
    model shards (serving) the plain take is split as the table is: each
    rank takes the ids in its vocab block, zeros elsewhere, summed over
    ``model`` (one term is not zero: the table's own bits); or its block
    of ``d``, gathered over ``model``.  The roomy exchange stripes the
    vocab over the model ranks, so it gathers the table whole first."""
    table, dim = p["table"], tp_dim(cfg, mesh, "embed/table")
    if cfg.embedding_dispatch == "roomy" and mesh is not None \
            and "model" in SH.mesh_axes(mesh):
        n_dev = SH.axis_size(mesh, SH.token_axes(mesh))
        if ids.numel() % n_dev == 0:
            if dim is not None:
                table = SH.all_gather(table, mesh, "model", dim)
            return _roomy_embed(table, ids, cfg, mesh).to(cdtype(cfg))
    if dim is None:
        return table[ids].to(cdtype(cfg))
    if dim == 1:
        return SH.all_gather(table[ids].to(cdtype(cfg)), mesh, "model", 2)
    rows = table.shape[0]
    local = ids - SH.axis_index(mesh, "model") * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].to(cdtype(cfg))
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return SH.all_reduce(x, mesh, "model")


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


def lm_head(p_embed: dict, x: torch.Tensor, cfg: ModelConfig,
            mesh=None, gather: bool = True) -> torch.Tensor:
    """Logits against the tied embedding table, or the untied ``head``
    (d, vocab_padded), softcapped; the pad rows past ``vocab_size`` are
    -1e30.  With model shards: vocab-parallel on the rank's columns (the
    softcap and the pad mask at their global indices), the columns
    gathered over ``model`` unless ``gather`` is False (the loss's
    vocab-parallel cross-entropy: then the rank's ``V / tp`` columns,
    which ``vocab_block`` places); or, where the rules split ``d``
    instead, a row-parallel product joined by one all-reduce."""
    tied = cfg.tie_embeddings
    w = (p_embed["table"].to(cdtype(cfg)).T if tied
         else p_embed["head"].to(cdtype(cfg)))               # (d, V)
    split = _vocab_split(cfg, mesh)
    if split == "d":
        d0 = SH.axis_index(mesh, "model") * w.shape[0]
        logits = SH.all_reduce(x[..., d0:d0 + w.shape[0]] @ w, mesh,
                               "model")
    else:
        logits = x @ w
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.vocab_padded != cfg.vocab_size:      # mask pad-to-shard rows
        v0 = (SH.axis_index(mesh, "model") * w.shape[1] if split == "vocab"
              else 0)
        pad = torch.arange(v0, v0 + w.shape[1], device=x.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=x.device), logits)
    if split == "vocab" and gather:
        logits = SH.all_gather(logits, mesh, "model", logits.dim() - 1)
    return logits


def _vocab_split(cfg: ModelConfig, mesh):
    """How the LM head's weight is split over ``model``: "vocab", "d", or
    None (whole)."""
    tied = cfg.tie_embeddings
    dim = tp_dim(cfg, mesh, "embed/table" if tied else "embed/head")
    if dim is None:
        return None
    return "vocab" if dim == (0 if tied else 1) else "d"


def vocab_block(cfg: ModelConfig, mesh):
    """(first column, width) of this rank's block of the vocab where the
    LM head is vocab-parallel, else None (every rank holds every
    column)."""
    if _vocab_split(cfg, mesh) != "vocab":
        return None
    width = cfg.vocab_padded // SH.axis_size(mesh, "model")
    return SH.axis_index(mesh, "model") * width, width
