"""Mixture-of-Experts: the router and the two dispatch engines of
``repro/models/moe.py`` (``init_moe``, ``_route``, ``_expert_ffn``,
``moe_einsum``, ``moe_roomy``, ``moe``).

``moe`` follows the reference's rule (``repro/models/moe.py:161-171``):
``moe_roomy`` with ``moe_dispatch == "roomy"`` on a mesh with a ``model``
axis whose device grid the B·S tokens tile, else ``moe_einsum`` (no mesh,
or a decode batch too small to tile the grid).

``moe_einsum`` gives the reference's result by index, not by its one-hot
matmuls: each batch row is a capacity group of ``cap = max(1, ceil(s·k /
E · capacity_factor))`` slots an expert (E the padded experts); a
(token, choice) takes the next slot of its expert in token-major order of
the flattened (s·k) axis (the cumsum of the one-hot ids), and one past
the last slot is dropped: it adds 0, and the kept weights are not
renormalised.  Each kept pair's token row is written into ``xin[e,
b·cap + slot]``, the experts run batched over (E, B·cap, d), and each
kept row comes back, times its router weight, summed over the k choices.
The reference's 5-D one-hot (b, s, k, E, cap) would hold 171.8 GB at
granite-moe's 1 × 32768 prefill in bfloat16; the index form holds the
(E, B·cap, d) buffer (1.0 GB there).  ``kernels/ref.py``'s
``moe_einsum_onehot`` keeps the one-hot form as the plain version the
tests hold this one to.

The padded experts are masked to -inf before the top-k, so with top_k ≤
n_experts they are never chosen; their rows of ``xin`` stay zero.  No
kernel of the port lies on this path: routing and dispatch are torch ops,
the experts batched matmuls.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..core import delayed as roomy_delayed
from ..core import sharding as SH
from .config import ModelConfig
from .layers import _act, dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device,
             dtype) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.experts_padded
    kw = dict(device=device, dtype=dtype)
    p = {"router": dense_init(gen, (d, e), **kw),
         "up": dense_init(gen, (e, d, ff), in_axis=1, **kw),
         "down": dense_init(gen, (e, ff, d), in_axis=1, **kw)}
    if cfg.mlp_gated:
        p["gate"] = dense_init(gen, (e, d, ff), in_axis=1, **kw)
    return p


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, largest first, equal values in
    ascending index order, as ``jax.lax.top_k`` orders them: a stable
    descending sort (``torch.topk`` does not promise an order for ties)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(p: dict, x: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) → (weights (..., k) float32, ids (..., k) int32): the
    router in float32, padded experts at -inf, softmax over the top k."""
    logits = x.float() @ p["router"].float()
    dead = torch.arange(cfg.experts_padded, device=x.device) >= cfg.n_experts
    logits = logits.masked_fill(dead, -math.inf)
    top, ids = top_k(logits, cfg.top_k)
    return torch.softmax(top, dim=-1), ids.to(torch.int32)


def capacity(s: int, cfg: ModelConfig) -> int:
    """Slots an expert takes from one batch row of ``s`` tokens, in Python
    floats as ``repro/models/moe.py:69``."""
    return max(1, int(math.ceil(s * cfg.top_k / cfg.experts_padded
                                * cfg.capacity_factor)))


def dispatch_slots(ids: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """ids (B, S, k) → (slot (B, S·k) int64, keep (B, S·k) bool, cap): the
    slot of each (token, choice) in its expert's bucket of its batch row,
    token-major over the flattened (S·k) axis, and whether it is below
    ``cap`` (``repro/models/moe.py:72-78``)."""
    b, s, k = ids.shape
    flat = ids.reshape(b, s * k).long()
    # the one-hot laid out (B, E, S·k), so that the cumsum runs along the
    # innermost dim (a scan along an outer dim of (B, S·k, E) gives each
    # of the E columns one thread walking all S·k rows)
    experts = torch.arange(cfg.experts_padded, device=ids.device)
    oh = (flat[:, None, :] == experts[None, :, None]).to(torch.int32)
    slot = oh.cumsum(-1, dtype=torch.int32).gather(1, flat[:, None, :])[
        :, 0].long() - 1
    cap = capacity(s, cfg)
    return slot, slot < cap, cap


def _expert_ffn(p: dict, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xin (E, C, d) → (E, C, d), batched over the expert axis."""
    dt = xin.dtype
    act = _act(cfg.mlp_act)
    h = torch.bmm(xin, p["up"].to(dt))
    if cfg.mlp_gated:
        h = act(torch.bmm(xin, p["gate"].to(dt))) * h
    else:
        h = act(h)
    return torch.bmm(h, p["down"].to(dt))


def moe_einsum(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's einsum dispatch, by index.  x (B, S, d) → (B, S, d)
    in x.dtype; each batch row is its own capacity group."""
    b, s, d = x.shape
    e, k = cfg.experts_padded, cfg.top_k
    w, ids = _route(p, x, cfg)                              # (b, s, k)
    slot, keep, cap = dispatch_slots(ids, cfg)              # (b, s·k)
    rows = (ids.reshape(b, s * k).long() * (b * cap)
            + torch.arange(b, device=x.device)[:, None] * cap + slot)
    spare = e * b * cap                   # a dropped pair's row, never read
    rows = torch.where(keep, rows, spare).reshape(b * s, k)
    keep = keep.reshape(b * s, k)
    xf = x.reshape(b * s, d)
    xin = x.new_zeros((spare + 1, d))
    for j in range(k):
        xin.index_put_((rows[:, j],), xf)
    hout = _expert_ffn(p, xin[:spare].view(e, b * cap, d), cfg).view(
        spare, d)
    del xin
    wk = torch.where(keep, w.reshape(b * s, k).to(x.dtype), 0).float()
    rows = torch.where(keep, rows, 0)
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out += hout[rows[:, j]].float() * wk[:, j:j + 1]
    return out.to(x.dtype).reshape(b, s, d)


def _combine(y: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """y (t, k, d), w (t, k) → Σ_j y[:, j] · w[:, j] in float32, the
    weights rounded to ``dtype`` first, summed in choice order, then cast:
    ``moe_einsum``'s combine."""
    wk = w.to(dtype).float()
    out = torch.zeros(y.shape[::2], dtype=torch.float32, device=y.device)
    for j in range(y.shape[1]):
        out += y[:, j].float() * wk[:, j:j + 1]
    return out.to(dtype)


def moe_roomy(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's dispatch on a mesh.  x (B, S, d): the same on every
    rank (serving's global convention), or this data rank's rows, the same
    on every rank of its model group (training's local one; see
    ``core/sharding.py``); returns (out (B, S, d) as x is held, dropped:
    int32 (2,) pairs dropped over the whole mesh at the exchange and at
    the experts).

    The router runs on the whole of x (replicated, as the reference's);
    this rank's t_loc tokens (x's B·S split over every axis in mesh order,
    or over ``model`` alone for a data rank's rows) send their k pairs as
    rows [x, local expert id] to the model rank owning expert id // (E/S);
    the owner bins what it received by local expert (``bin_by_dest``,
    cap2), runs ``_expert_ffn`` on its E/S experts' slice of the params,
    and each row goes back to its pair.  The combine is ``moe_einsum``'s
    (float32, the weights rounded to the compute dtype) where the
    reference sums in x's dtype; the ranks' outputs are gathered over the
    axes the tokens were split over.  Under autograd every step carries
    the gradient (the exchanges' backward is the reverse all-to-all, the
    slices' zeros elsewhere, the gather's a reduce-scatter); the drop
    count is a forward reading."""
    b, s, d = x.shape
    k = cfg.top_k
    shape = SH.mesh_axes(mesh)
    axes = SH.token_axes(mesh)
    group, m_idx, s_model = SH.axis_group(mesh, "model")
    e_loc = cfg.experts_padded // s_model
    # capacities in Python floats, as repro/models/moe.py:108-115 (t_loc
    # tokens a device: the same under either convention)
    m = max(1, (b * s) // SH.axis_size(mesh, axes)) * k
    cap1 = max(8, int(math.ceil(m / s_model * cfg.capacity_factor)))
    cap2 = max(8, int(math.ceil(s_model * cap1 / e_loc
                                * cfg.capacity_factor)))

    w_all, ids_all = _route(p, x, cfg)             # (b, s, k) on every rank
    x_loc = SH.shard_leading(x.reshape(b * s, d), mesh, axes)
    w_loc = SH.shard_leading(w_all.reshape(b * s, k), mesh, axes)
    ids_loc = SH.shard_leading(ids_all.reshape(b * s, k), mesh, axes)
    t = x_loc.shape[0]
    ek = ids_loc.reshape(-1)
    dest = (ek // e_loc).to(torch.int32)
    e_local = (ek % e_loc).to(x.dtype)
    payload = torch.cat([x_loc.repeat_interleave(k, 0), e_local[:, None]], 1)
    valid = torch.ones_like(dest, dtype=torch.bool)
    # the expert params are this rank's experts already where serving
    # holds them as model shards
    mine = (slice(None) if _experts_split(cfg, mesh)
            else slice(m_idx * e_loc, (m_idx + 1) * e_loc))
    pp = {name: p[name][mine].to(x.dtype) for name in ("up", "down", "gate")
          if name in p}
    expert_drops = []

    def owner_fn(recv, recv_valid):
        # recv (S, C1, d+1): bin again by local expert id
        flat = recv.reshape(-1, d + 1)
        binned = roomy_delayed.bin_by_dest(
            flat[:, d].to(torch.int32), flat[:, :d], recv_valid.reshape(-1),
            e_loc, cap2)
        expert_drops.append(binned.dropped)
        y = _expert_ffn(pp, binned.payload, cfg)            # (E_loc, C2, d)
        y = torch.where(binned.valid[..., None], y, 0.0)
        back = roomy_delayed.unbin(y, binned.src_idx, flat.shape[0])
        return back.reshape(recv.shape[0], recv.shape[1], d)

    y, ok, dropped1 = roomy_delayed.bucket_sync_access(
        dest, payload, valid, group, s_model, cap1, owner_fn)
    y = torch.where(ok[:, None], y, 0.0)
    out = _combine(y.reshape(t, k, d), w_loc, x.dtype)
    # dropped1 is already summed over the model group: one rank of each
    # group adds it in, and the expert drops of every rank, over the mesh
    dropped = torch.stack([dropped1 if m_idx == 0
                           else torch.zeros_like(dropped1),
                           expert_drops[0]]).to(torch.int32)
    dist.all_reduce(dropped, group=SH.axis_group(mesh, tuple(shape))[0])
    return SH.gather_leading(out, mesh, axes).reshape(b, s, d), dropped


def _experts_split(cfg: ModelConfig, mesh) -> bool:
    """The expert leaves are this model rank's experts (serving's model
    shards, where the rules split the expert dim over ``model``)."""
    from .layers import tp_dim
    return tp_dim(cfg, mesh, "moe/up") == 0


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None
        ) -> torch.Tensor:
    """x (B, S, d) → (B, S, d): ``moe_roomy`` on a mesh where the
    reference runs it, else ``moe_einsum`` (on every expert: model shards
    of them are gathered over ``model`` first)."""
    if cfg.moe_dispatch == "roomy" and mesh is not None \
            and "model" in SH.mesh_axes(mesh):
        # Roomy dispatch needs tokens to tile the device grid (the model
        # axis for a data rank's rows); tiny decode batches fall back to
        # the einsum path (capacity 1-2 there anyway).
        if (x.shape[0] * x.shape[1]) % SH.axis_size(
                mesh, SH.token_axes(mesh)) == 0:
            return moe_roomy(p, x, cfg, mesh)[0]
    if _experts_split(cfg, mesh):
        p = {k: SH.all_gather(v, mesh, "model", 0) if k != "router" else v
             for k, v in p.items()}
    return moe_einsum(p, x, cfg)
