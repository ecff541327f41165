"""Mixture-of-Experts on one device: the router and the capacity-bucketed
dispatch of ``repro/models/moe.py`` (``init_moe``, ``_route``,
``_expert_ffn``, ``moe_einsum``, ``moe``).

The reference's single-device rule holds: without a mesh, ``moe`` runs
``moe_einsum`` (``repro/models/moe.py:161-171``); the paper's bucket
exchange (``moe_roomy``) needs a mesh, ROADMAP item 9.8, and ``moe``
raises when handed a process group with ``moe_dispatch == "roomy"``.

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
from typing import Optional, Tuple

import torch

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


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
        group: Optional[object] = None) -> torch.Tensor:
    """x (B, S, d) → (B, S, d).  With no process group this is
    ``moe_einsum``, the reference's rule on one device; the roomy dispatch
    over a group is not ported."""
    if group is not None and cfg.moe_dispatch == "roomy":
        raise NotImplementedError(
            "the roomy MoE dispatch (a bucket exchange over a device mesh) "
            "is not ported to repro_torch yet: ROADMAP item 9.8")
    return moe_einsum(p, x, cfg)
