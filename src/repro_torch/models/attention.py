"""Attention layer: prefill (the flash kernel, K6) and paged decode.

Port of ``repro/models/attention.py`` for one device.  Activations are
(B, S, H, D); the flash path views them as (B, H, S, D) without a copy
(the kernel takes strides) and gets its output back in the same layout.

Decode uses the Roomy paged-KV store (``core/paged.py``): append is one
scatter; then a global layer reads the pages through the table with K8
(the paged-decode kernel), and a windowed layer gathers them for the
plain ``decode_attention_ref`` with the window mask, as the reference's
single-host branch does (``attention.py:145-156``, which splits on
``window is None`` too).  The reference's ``shard_map`` branches wait for
``distributed/``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import paged
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
                     donate: bool = False
                     ) -> Tuple[torch.Tensor, paged.PagedKV]:
    """One-token decode step against the paged cache.

    x: (B, 1, d).  Rope positions are the cache's lengths (repeated into
    the three streams under M-RoPE, as the reference does).  After the
    append, a layer without a window reads the pages through the table
    with K8 (``ops.paged_decode_attention``); a windowed layer gathers the
    cache and runs the plain ``decode_attention_ref`` under the window
    mask, as the reference does (K8 has no window).  ``donate``: append in
    place (``paged.append``).  Returns (out (B, 1, d), the updated
    cache)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)                       # (B, 1, H/KVH, D)
    positions = cache.lengths[:, None]              # (B, 1)
    if cfg.mrope:
        positions = positions[..., None].expand(-1, -1, 3)
    q, k = _apply_rope(q, k, positions, cfg)
    cache = paged.append(cache, k[:, 0], v[:, 0], inplace=donate)
    softcap = cfg.attn_softcap or None
    if window is None:
        out = kops.paged_decode_attention(
            q[:, 0], cache.k_pages, cache.v_pages, cache.page_table,
            cache.lengths, softcap=softcap, impl=cfg.kernels)
    else:
        kf, vf, mask = paged.gather(cache)          # batched access
        pos_in_seq = torch.arange(mask.shape[1], device=mask.device)[None, :]
        cur = cache.lengths[:, None] - 1
        mask = mask & (pos_in_seq >= cur - window)
        out = kref.decode_attention_ref(q[:, 0], kf, vf, mask,
                                        softcap=softcap)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(cdtype(cfg)), cache
