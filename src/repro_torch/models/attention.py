"""Attention layer: prefill (the flash kernel, K6) and paged decode, on one
device or on a mesh.

Port of ``repro/models/attention.py``.  Activations are (B, S, H, D); the
flash path views them as (B, H, S, D) without a copy (the kernel takes
strides) and gets its output back in the same layout.

Decode uses the Roomy paged-KV store (``core/paged.py``): append is one
scatter; then a global layer reads the pages through the table with K8
(the paged-decode kernel), and a windowed layer gathers them for the
plain ``decode_attention_ref`` with the window mask, as the reference's
single-host branch does (``attention.py:145-156``, which splits on
``window is None`` too).

On a mesh (``launch/mesh.py``) ``decode_attention`` dispatches as the
reference (``attention.py:137-157``), each ``shard_map`` region an
explicit function of this rank's tensors.  The input x and the output
are global, the same on every rank; the cache is this rank's shard
(``paged.shard_layout``), and no step moves a page to a rank that does
not own it (the owner-compute rule of ``attention.py:119-123``):

* batch % dp == 0, batch > 1 (``_paged_decode_batched``): each data rank
  owns B/dp rows and their pages under the batch-major identity table;
  it projects its rows, appends locally and reads its pages with K8 on
  the local table ``table − off`` (windowed layers: gather + the plain
  version), and the rows are gathered back over dp;
* batch 1, no window (``_paged_decode_cp``): the pages split over dp;
  only the tail page's owner appends; each rank attends over its pages
  in float32 and the partials merge by one all-reduce MAX and two SUMs;
* otherwise the single-device body, on the whole cache (a batch that
  does not tile dp keeps its cache whole on every rank); a windowed
  layer at batch 1 gathers its page shards first, as GSPMD does there in
  the reference, and keeps its own shard after.

Prefill attention runs replicated on every rank; ``_attn_act_spec`` is
the reference's placement of its activations over ``model``, ported as
the decision only (it changes no number).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core import paged
from ..core import sharding as SH
from ..kernels import ops as kops
from ..kernels import ref as kref
from .config import ModelConfig
from .layers import cdtype, dense_init
from .rope import mrope, rope


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, device,
                   dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), **kw),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), **kw),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), **kw),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), **kw),
    }


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = cdtype(cfg)
    b, s, _ = x.shape
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _apply_rope(q, k, positions, cfg: ModelConfig):
    """RoPE over (..., S) positions, or M-RoPE over (..., S, 3) ones."""
    if cfg.mrope:
        return (mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta)


def _attn_act_spec(cfg: ModelConfig, mesh, b: int, s: int):
    """When q-heads don't divide the model axis (attention weights are
    replicated by the sharding rules), the reference spreads the attention
    *activations* over 'model' instead — batch if it tiles the whole grid,
    else sequence.  Returns (in_spec, out_spec) or None, as
    ``repro/models/attention.py:57-77``."""
    from ..distributed.sharding_rules import PartitionSpec as P
    if cfg.attn_activation_shard != "auto" or mesh is None:
        return None
    shape = SH.mesh_axes(mesh)
    tp = shape.get("model", 1)
    if tp <= 1 or cfg.n_heads % tp == 0:
        return None                       # weights TP-shard fine already
    dp = SH.data_axes(mesh)
    n_dp = math.prod(shape[a] for a in dp)
    dp_ax = dp if len(dp) > 1 else (dp[0] if dp else None)
    if dp and b % (n_dp * tp) == 0:
        return (P(dp + ("model",), None, None), P(dp_ax, None, None))
    if s % tp == 0 and (not dp or b % n_dp == 0):
        return (P(dp_ax, "model", None), P(dp_ax, None, None))
    return None


def attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, window: Optional[int] = None,
              return_kv: bool = False):
    """Full-sequence causal attention (prefill).  ``window``: the layer's
    sliding window, None for a global layer.  With ``return_kv`` also
    returns the rotated (k, v), (B, S, Hkv, D), for the cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _apply_rope(q, k, positions, cfg)
    out = kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, softcap=cfg.attn_softcap or None,
        impl=cfg.kernels)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = out @ p["wo"].to(cdtype(cfg))
    if return_kv:
        return out, (k, v)
    return out


def decode_attention(p: dict, x: torch.Tensor, cache: paged.PagedKV,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     donate: bool = False, mesh=None
                     ) -> Tuple[torch.Tensor, paged.PagedKV]:
    """One-token decode step against the paged cache.

    x: (B, 1, d).  Rope positions are the cache's lengths (repeated into
    the three streams under M-RoPE, as the reference does).  After the
    append, a layer without a window reads the pages through the table
    with K8 (``ops.paged_decode_attention``); a windowed layer gathers the
    cache and runs the plain ``decode_attention_ref`` under the window
    mask, as the reference does (K8 has no window).  ``donate``: append in
    place (``paged.append``).  ``mesh``: the module docstring's branches;
    ``cache`` is then this rank's shard.  Returns (out (B, 1, d), the
    updated cache)."""
    b = x.shape[0]
    softcap = cfg.attn_softcap or None
    dp = SH.data_axes(mesh)
    layout = (paged.shard_layout(b, cache.pages_per_seq,
                                 SH.axis_size(mesh, dp)) if dp else None)
    if layout == "rows":
        out, cache = _paged_decode_batched(
            p, SH.shard_leading(x, mesh, dp), cache, cfg, mesh, dp, softcap,
            window, donate)
        return SH.gather_leading(out, mesh, dp), cache
    q, k, v = _qkv_rope(p, x, cache.lengths, cfg)
    if dp and b == 1 and window is None:
        if layout != "pages":
            raise ValueError(f"context-parallel decode needs the "
                             f"{cache.pages_per_seq} pages a sequence to "
                             f"split over the data axes {dp}")
        out, cache = _paged_decode_cp(q[:, 0], k[:, 0], v[:, 0], cache, cfg,
                                      mesh, dp, softcap, donate)
    elif layout == "pages":
        whole = paged.gather_pages(cache, mesh, dp)
        out, whole = _decode_local(q, k, v, whole, cfg, window, softcap,
                                   donate=True)
        cache = paged.own_shard(whole, mesh, dp)
    else:
        out, cache = _decode_local(q, k, v, cache, cfg, window, softcap,
                                   donate)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(cdtype(cfg)), cache


def _qkv_rope(p: dict, x: torch.Tensor, lengths: torch.Tensor,
              cfg: ModelConfig):
    """q, k, v of one decode step, (B, 1, H/KVH, D), rotated to the
    positions ``lengths``."""
    q, k, v = _qkv(p, x, cfg)
    positions = lengths[:, None]                    # (B, 1)
    if cfg.mrope:
        positions = positions[..., None].expand(-1, -1, 3)
    q, k = _apply_rope(q, k, positions, cfg)
    return q, k, v


def _decode_local(q, k, v, cache: paged.PagedKV, cfg: ModelConfig, window,
                  softcap, donate):
    """The single-device body: append, then K8 (no window) or the gather
    and the plain version under the window mask.  q (B, 1, Hq, D)."""
    cache = paged.append(cache, k[:, 0], v[:, 0], inplace=donate)
    return _attend(q[:, 0], cache, cfg, window, softcap), cache


def _attend(q, cache: paged.PagedKV, cfg: ModelConfig, window, softcap):
    """q (B, Hq, D) over the appended cache → (B, Hq, D)."""
    if window is None:
        return kops.paged_decode_attention(
            q, cache.k_pages, cache.v_pages, cache.page_table,
            cache.lengths, softcap=softcap, impl=cfg.kernels)
    kf, vf, mask = paged.gather(cache)              # batched access
    pos_in_seq = torch.arange(mask.shape[1], device=mask.device)[None, :]
    cur = cache.lengths[:, None] - 1
    mask = mask & (pos_in_seq >= cur - window)
    return kref.decode_attention_ref(q, kf, vf, mask, softcap=softcap)


def _paged_decode_batched(p: dict, x_l: torch.Tensor, cache: paged.PagedKV,
                          cfg: ModelConfig, mesh, dp, softcap, window,
                          donate):
    """Batch-sharded decode (``repro/models/attention.py:161-208``): this
    rank's rows x_l (B/dp, 1, d) and their pages live here (batch-major
    identity layout), so append and read stay local.  The cache's table
    holds global page ids; ``table − off`` is the local one.  Returns
    (this rank's rows of the output (B/dp, 1, d), the updated shard)."""
    q, k, v = _qkv_rope(p, x_l, cache.lengths, cfg)
    off = SH.axis_index(mesh, dp) * cache.k_pages.shape[0]
    local = cache._replace(page_table=cache.page_table - off)
    out, local = _decode_local(q, k, v, local, cfg, window, softcap, donate)
    out = out.reshape(x_l.shape[0], 1, cfg.n_heads * cfg.head_dim)
    return (out @ p["wo"].to(cdtype(cfg)),
            local._replace(page_table=cache.page_table))


def _cp_logits(q, k_pages, pos0: int, new_len, scale: float, softcap,
               group_size: int):
    """One rank's scores in a context-parallel step: q (Hq, D) against its
    pages (P_loc, ps, kvh, D) holding positions pos0, pos0 + 1, …, in
    float32, masked to the positions below ``new_len`` (NEG_INF past
    them).  Returns (logits (Hq, S_loc), mask (S_loc,))."""
    n, ps, kvh, hd = k_pages.shape
    kf = k_pages.reshape(n * ps, kvh, hd).float().repeat_interleave(
        group_size, dim=1)                           # (S_loc, Hq, hd)
    pos = pos0 + torch.arange(n * ps, device=q.device)
    mask = pos < new_len
    logits = torch.einsum("hd,shd->hs", q.float(), kf) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return torch.where(mask[None, :], logits, kref.NEG_INF), mask


def _paged_decode_cp(q, k_new, v_new, cache: paged.PagedKV,
                     cfg: ModelConfig, mesh, dp, softcap, donate):
    """Context-parallel single-sequence decode under the identity table
    (``repro/models/attention.py:211-282``): the pages split over dp; the
    owner of the tail page takes the append; every rank attends over its
    pages in float32; the partials merge with one all-reduce MAX and two
    SUMs (flash-decoding), a rank with no visible position adding zeros,
    and a sum of 0 read as 1.  q, k_new, v_new: (1, Hq|kvh, D).  Returns
    (out (1, Hq, D), the updated shard)."""
    group, idx, _ = SH.axis_group(mesh, dp)
    kp, vp = cache.k_pages, cache.v_pages
    p_loc, ps = kp.shape[0], cache.page_size
    off = idx * p_loc
    length = cache.lengths[:1].long()
    loc = length // ps - off                        # identity table
    offset = length % ps
    mine = ((loc >= 0) & (loc < p_loc))[:, None, None]
    loc = loc.clamp(0, p_loc - 1)

    def write(pages, new):
        new = torch.where(mine, new.to(pages.dtype), pages[loc, offset])
        if donate:
            return pages.index_put_((loc, offset), new)
        return pages.index_put((loc, offset), new)
    kp, vp = write(kp, k_new), write(vp, v_new)
    new_len = cache.lengths[0] + 1
    logits, mask = _cp_logits(q[0], kp, off * ps, new_len,
                              1.0 / math.sqrt(cfg.head_dim), softcap,
                              cfg.n_heads // cfg.n_kv_heads)
    m = logits.max(dim=1).values                     # (Hq,)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p_ = torch.where(mask[None, :], torch.exp(logits - m[:, None]), 0.0)
    l = p_.sum(dim=1)
    vf = vp.reshape(p_loc * ps, *vp.shape[2:]).float().repeat_interleave(
        cfg.n_heads // cfg.n_kv_heads, dim=1)
    acc = torch.einsum("hs,shd->hd", p_, vf)
    dist.all_reduce(l, group=group)
    dist.all_reduce(acc, group=group)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[:, None]).to(q.dtype)[None]
    return out, cache._replace(k_pages=kp, v_pages=vp,
                               lengths=cache.lengths + 1)
