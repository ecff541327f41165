"""Attention layer: prefill (the flash kernel, K6) and paged decode (K8),
on one device or on a mesh.

Port of ``repro/models/attention.py``.  Activations are (B, S, H, D); the
flash path views them as (B, H, S, D) without a copy (the kernel takes
strides) and gets its output back in the same layout.

Decode uses the Roomy paged-KV store (``core/paged.py``): append is one
scatter; then a global layer reads the pages through the table with K8
(the paged-decode kernel), and a windowed layer gathers them for the
plain ``decode_attention_ref`` with the window mask, as the reference's
single-host branch does (``attention.py:145-156``, which splits on
``window is None`` too).

On a mesh (``launch/mesh.py``) serving splits a layer's work as the
reference's ``jit`` partitions it over its param shardings
(``repro/distributed/sharding_rules.py:24-56``): x holds the rows of this
rank's model group (a data rank's rows where the batch tiles the data
axes, ``core/sharding.py``'s two conventions), and the layer gets this
rank's shards of ``wq`` / ``wk`` / ``wv`` / ``wo`` (``sharding_rules
.model_dim`` says which are split over ``model``).

* **Heads over ``model``** (``n_heads % tp == 0``, ``head_plan``): a rank
  computes q for its ``n_heads / tp`` heads from its ``wq`` column shard,
  and k / v for the kv heads those read, from its ``wk`` / ``wv`` shard
  when ``n_kv_heads % tp == 0``, else cut from the replicated weights; it
  runs K6 (or K8) on those heads, one call a run of equal GQA groups
  (one run on every shipped config); ``wo`` is row-parallel and its
  partials join by one all-reduce over ``model``.  The caches keep every
  kv head on each model rank (``cache_specs``), so the k / v rows a rank
  did not compute are gathered over ``model`` before they are written;
  K8 reads the rank's kv-head range of the pages in place
  (``pages[:, :, k0:k1]``, a view).
* **Activations over ``model``** (heads do not divide ``tp``: the rules
  replicate the attention weights): prefill takes the reference's
  ``_attn_act_spec``.  The batch branch gives each model rank its block
  of the data rank's rows; the sequence branch gives it its block of
  query rows, gathers k / v over ``model``, and runs K6 on the diagonal
  block (causal) and on the keys before it (no causal mask, the window
  moved by the block's offset), the two joined by their row LSEs; the
  outputs are gathered back.  Decode, which has no such spec in the
  reference (its ``shard_map`` regions replicate attention within a model
  group), gives each rank ceil or floor ``n_heads / tp`` heads cut from
  the replicated weights, K8 on those, ``wo``'s rows for them, and the
  same all-reduce (a rank may get none and add zeros).  This split is the
  port's own: at 32k tokens of cache decode's FLOPs are attention's, and
  replicated within a model group they would cut a rank's decode by the
  data axes alone (16 on 16 x 16).  ``attn_activation_shard="none"``
  replicates decode attention, as the reference does, and prefill's too.

The decode dispatch is the reference's (``attention.py:137-157``), each
``shard_map`` region an explicit function of this rank's tensors; the
cache is this rank's shard (``paged.shard_layout``), and no step moves a
page to a rank that does not own it (``attention.py:119-123``):

* batch % dp == 0, batch > 1: each data rank owns its rows (x holds
  them) and their pages under the batch-major identity table; it appends
  locally and reads its pages with K8 on the local table ``table − off``
  (windowed layers: gather + the plain version);
* batch 1, no window (``_paged_decode_cp``): the pages split over dp;
  only the tail page's owner appends; each rank attends over its pages
  in float32 and the partials merge by one all-reduce MAX and two SUMs;
* otherwise the single-device body, on the whole cache (a batch that
  does not tile dp keeps its cache whole on every rank); a windowed
  layer at batch 1 gathers its page shards first, as GSPMD does there in
  the reference, and keeps its own shard after.

Training (``lm.loss_fn`` on a mesh) takes the same prefill branches under
autograd, on the same model shards: the heads branch runs K6-LSE forward
and K7 backward (``ops._FlashAttention``) on the rank's heads, ``wo``
row-parallel, whose all-reduce has the all-reduce of the gradient as its
backward; the batch branch needs nothing more than the collectives'
backwards; the sequence branch's join runs K7 on each piece with the
joined O and LSE (``ops.flash_attention_join``).  The gradients of
replicated weights (cut by head, or by rows) are summed over ``model``
where ``gather_fsdp`` gathered them (``core/sharding.py``, rule 3).  A
training call returns no k / v, so nothing is gathered for a cache.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core import paged
from ..core import sharding as SH
from ..kernels import ops as kops
from ..kernels import ref as kref
from .config import ModelConfig
from .layers import cdtype, dense_init, tp_dim
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


class Heads(NamedTuple):
    """This model rank's share of a layer's heads under tensor
    parallelism: its q heads [q0, q1) (from its ``wq`` / ``wo`` shards, or
    cut from the replicated weights when ``q_cut``), the kv heads they
    read [k0, k1) (its own ``wk`` / ``wv`` shard when ``kv_owned``, else
    cut from the replicated weights), the runs (q0, q1, k0, k1) of one GQA
    group size each (one K6 / K8 call a run), and for the cache, where
    each kv head lies among every rank's ``width`` heads gathered over
    ``model`` (``owners``, flat indices)."""
    q0: int
    q1: int
    k0: int
    k1: int
    kv_owned: bool
    runs: Tuple[Tuple[int, int, int, int], ...]
    width: int
    owners: Tuple[int, ...]
    q_cut: bool = False


@functools.lru_cache(maxsize=None)
def _heads(hq: int, kvh: int, tp: int, m: int, kv_owned: bool,
           q_cut: bool = False) -> Heads:
    """Rank m's share of ``hq`` heads over ``tp`` ranks: hq / tp each, or
    where tp does not divide hq, ceil(r·hq / tp) up to ceil((r + 1)·hq /
    tp) for rank r (rank 0 among the busiest; a rank may get none)."""
    g = hq // kvh

    def q_range(r):
        return -(-r * hq // tp), -(-(r + 1) * hq // tp)

    def kv_range(r):
        a, b = q_range(r)
        return (a // g, (b - 1) // g + 1) if b > a else (a // g, a // g)
    q0, q1 = q_range(m)
    runs = []
    h = q0
    while h < q1:                       # cut the rank's heads at each group
        kh = h // g
        end = min(q1, (kh + 1) * g)
        if runs and runs[-1][1] - runs[-1][0] == \
                (end - h) * (runs[-1][3] - runs[-1][2]):
            runs[-1] = (runs[-1][0], end, runs[-1][2], kh + 1)
        else:
            runs.append((h, end, kh, kh + 1))
        h = end
    ranges = [kv_range(r) for r in range(tp)]
    width = max(b - a for a, b in ranges)
    owners = []
    for j in range(kvh):
        r = next(r for r, (a, b) in enumerate(ranges) if a <= j < b)
        owners.append(r * width + j - ranges[r][0])
    return Heads(q0, q1, *kv_range(m), kv_owned, tuple(runs), width,
                 tuple(owners), q_cut)


def head_plan(cfg: ModelConfig, mesh, decode: bool = False
              ) -> Optional[Heads]:
    """This rank's ``Heads`` where ``wq`` is split over ``model`` (serving
    on a mesh with ``n_heads % tp == 0``); in a decode step where the
    heads do not divide ``model`` (the rules replicate the attention
    weights) and ``attn_activation_shard`` is "auto", a share of ceil or
    floor n_heads / tp heads cut from them (beyond the reference, which
    replicates decode attention there: with "none" the port does too);
    else None: every head here."""
    if tp_dim(cfg, mesh, "attn/wq") is not None:
        return _heads(cfg.n_heads, cfg.n_kv_heads,
                      SH.axis_size(mesh, "model"),
                      SH.axis_index(mesh, "model"),
                      tp_dim(cfg, mesh, "attn/wk") is not None)
    if (decode and cfg.attn_activation_shard == "auto"
            and SH.model_shards(mesh) and SH.axis_size(mesh, "model") > 1):
        return _heads(cfg.n_heads, cfg.n_kv_heads,
                      SH.axis_size(mesh, "model"),
                      SH.axis_index(mesh, "model"), False, True)
    return None


def _all_runs(cfg: ModelConfig):
    return ((0, cfg.n_heads, 0, cfg.n_kv_heads),)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
         plan: Optional[Heads] = None):
    """q, k, v (B, S, heads, D): every head, or ``plan``'s q heads and the
    kv heads they read."""
    dt = cdtype(cfg)
    b, s, _ = x.shape
    hd = cfg.head_dim
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if plan is not None and not plan.kv_owned:
        cols = slice(plan.k0 * hd, plan.k1 * hd)
        wk, wv = wk[:, cols], wv[:, cols]
    if plan is not None and plan.q_cut:
        wq = wq[:, plan.q0 * hd:plan.q1 * hd]
    q = x @ wq.to(dt)
    k, v = x @ wk.to(dt), x @ wv.to(dt)
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


def _apply_rope(q, k, positions, cfg: ModelConfig):
    """RoPE over (..., S) positions, or M-RoPE over (..., S, 3) ones."""
    if cfg.mrope:
        return (mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta)


def _kv_all(kv: torch.Tensor, plan: Optional[Heads], mesh) -> torch.Tensor:
    """(..., heads, D) of the kv heads this rank computed → every kv head,
    gathered over ``model`` (the caches hold them all on each rank)."""
    if plan is None:
        return kv
    pad = plan.width - (plan.k1 - plan.k0)
    if pad:
        kv = torch.cat([kv, kv.new_zeros(kv.shape[:-2] + (pad,)
                                          + kv.shape[-1:])], -2)
    every = SH.all_gather(kv, mesh, "model", kv.dim() - 2)
    if plan.owners == tuple(range(every.shape[-2])):
        return every
    return every[..., list(plan.owners), :]


def _attn_act_spec(cfg: ModelConfig, mesh, b: int, s: int):
    """When q-heads don't divide the model axis (attention weights are
    replicated by the sharding rules), the reference spreads the attention
    *activations* over 'model' instead — batch if it tiles the whole grid,
    else sequence.  Returns (in_spec, out_spec) or None, as
    ``repro/models/attention.py:57-77``; ``b`` is the global batch."""
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


def _flash_runs(q, k, v, runs, base: int, cfg: ModelConfig, window,
                **kw) -> torch.Tensor:
    """K6 on each run of heads: q (B, S, nq, D) holds heads [base, …),
    k, v (B, S, nk, D) the kv heads from ``runs[0][2]``; → (B, S, nq·D)."""
    kb = runs[0][2]
    outs = []
    for q0, q1, k0, k1 in runs:
        outs.append(kops.flash_attention(
            q[:, :, q0 - base:q1 - base].transpose(1, 2),
            k[:, :, k0 - kb:k1 - kb].transpose(1, 2),
            v[:, :, k0 - kb:k1 - kb].transpose(1, 2),
            window=window, softcap=cfg.attn_softcap or None,
            impl=cfg.kernels, **kw).transpose(1, 2))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 2)
    b, s = q.shape[:2]
    return out.reshape(b, s, -1)


def _flash_offset(q, k, v, s0: int, cfg: ModelConfig, window):
    """Causal attention of query rows at positions s0, s0 + 1, … over the
    keys at 0, 1, …, s0 + n − 1: K6 for the first block, else
    ``ops.flash_attention_join`` (the diagonal block causal, the keys
    before it with no causal mask and the window moved by the block's
    offset, joined by their row LSEs; K7 on each piece under a gradient).
    q (B, H, n, D), k, v (B, Hkv, s0 + n, D) → (B, H, n, D)."""
    kw = dict(softcap=cfg.attn_softcap or None, impl=cfg.kernels)
    if s0 == 0:
        return kops.flash_attention(q, k, v, window=window, **kw)
    return kops.flash_attention_join(q, k, v, s0, window=window, **kw)


def _attention_heads(p: dict, x, positions, cfg: ModelConfig, window,
                     plan: Optional[Heads], mesh, return_kv: bool = True):
    """Every head, or ``plan``'s with ``wo`` row-parallel: (out (B, S, d),
    (k, v) of every kv head, or None without ``return_kv``)."""
    q, k, v = _qkv(p, x, cfg, plan)
    q, k = _apply_rope(q, k, positions, cfg)
    runs, base = (_all_runs(cfg), 0) if plan is None else (plan.runs,
                                                             plan.q0)
    out = _flash_runs(q, k, v, runs, base, cfg, window, causal=True)
    out = out @ p["wo"].to(cdtype(cfg))
    if plan is not None:
        out = _sum_over_model(out, mesh)
    if not return_kv:
        return out, None
    return out, (_kv_all(k, plan, mesh), _kv_all(v, plan, mesh))


def _sum_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The row-parallel ``wo``'s partials joined over ``model``."""
    return SH.all_reduce(x, mesh, "model")


def _attention_seq(p: dict, x, positions, cfg: ModelConfig, window, mesh):
    """The sequence branch of ``_attn_act_spec``: this model rank's block
    of query rows, k / v gathered over ``model``, the output gathered
    back."""
    b, s, _ = x.shape
    n = s // SH.axis_size(mesh, "model")
    s0 = SH.axis_index(mesh, "model") * n
    q, k, v = _qkv(p, x[:, s0:s0 + n], cfg)
    q, k = _apply_rope(q, k, positions[:, s0:s0 + n], cfg)
    k = SH.all_gather(k, mesh, "model", 1)
    v = SH.all_gather(v, mesh, "model", 1)
    out = _flash_offset(q.transpose(1, 2), k[:, :s0 + n].transpose(1, 2),
                        v[:, :s0 + n].transpose(1, 2), s0, cfg, window)
    out = out.transpose(1, 2).reshape(b, n, -1) @ p["wo"].to(cdtype(cfg))
    return SH.all_gather(out, mesh, "model", 1), (k, v)


def attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, window: Optional[int] = None,
              return_kv: bool = False, mesh=None):
    """Full-sequence causal attention (prefill).  ``window``: the layer's
    sliding window, None for a global layer.  With ``return_kv`` also
    returns the rotated (k, v), (B, S, Hkv, D), of every kv head, for the
    cache.  ``mesh``: serving's split of the module docstring where the
    mesh view holds model shards; else every head here."""
    b, s, _ = x.shape
    plan = head_plan(cfg, mesh)
    spec = None
    if plan is None and SH.model_shards(mesh) and SH.rows_local(mesh):
        dp = SH.data_axes(mesh)
        spec = _attn_act_spec(cfg, mesh, b * SH.axis_size(mesh, dp), s)
    if spec is None:
        out, kv = _attention_heads(p, x, positions, cfg, window, plan, mesh,
                                   return_kv)
    elif isinstance(spec[0][0], tuple) and "model" in spec[0][0]:  # batch
        out, kv = _attention_heads(
            p, SH.shard_dim(x, mesh, "model", 0),
            SH.shard_dim(positions, mesh, "model", 0), cfg, window, None,
            mesh, return_kv)
        out = SH.all_gather(out, mesh, "model", 0)
        if return_kv:
            kv = tuple(SH.all_gather(t, mesh, "model", 0) for t in kv)
    else:                                                     # sequence
        out, kv = _attention_seq(p, x, positions, cfg, window, mesh)
    return (out, kv) if return_kv else out


def decode_attention(p: dict, x: torch.Tensor, cache: paged.PagedKV,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     donate: bool = False, mesh=None
                     ) -> Tuple[torch.Tensor, paged.PagedKV]:
    """One-token decode step against the paged cache.

    x: (B, 1, d), the rows this rank serves.  Rope positions are the
    cache's lengths (repeated into the three streams under M-RoPE, as the
    reference does).  After the append, a layer without a window reads the
    pages through the table with K8 (``ops.paged_decode_attention``); a
    windowed layer gathers the cache and runs the plain
    ``decode_attention_ref`` under the window mask, as the reference does
    (K8 has no window).  ``donate``: append in place (``paged.append``).
    ``mesh``: the module docstring's branches; ``cache`` is then this
    rank's shard, and under tensor parallelism each rank attends with its
    q heads over its kv heads' view of the pages.  Returns (out (B, 1, d),
    the updated cache)."""
    b = x.shape[0]
    softcap = cfg.attn_softcap or None
    plan = head_plan(cfg, mesh, decode=True)
    dp = SH.data_axes(mesh)
    n_dp = SH.axis_size(mesh, dp) if dp else 1
    batch = b * n_dp if SH.rows_local(mesh) else b
    layout = (paged.shard_layout(batch, cache.pages_per_seq, n_dp) if dp
              else None)
    q, k, v = _qkv_rope(p, x, cache.lengths, cfg, plan)
    k, v = _kv_all(k, plan, mesh), _kv_all(v, plan, mesh)
    if layout == "rows":
        if not SH.rows_local(mesh):
            raise ValueError(f"a batch of {batch} tiles the data axes {dp}: "
                             "x must hold this data rank's rows")
        off = SH.axis_index(mesh, dp) * cache.k_pages.shape[0]
        local = cache._replace(page_table=cache.page_table - off)
        out, local = _decode_local(q, k, v, local, cfg, window, softcap,
                                   donate, plan)
        cache = local._replace(page_table=cache.page_table)
    elif dp and batch == 1 and window is None:
        if layout != "pages":
            raise ValueError(f"context-parallel decode needs the "
                             f"{cache.pages_per_seq} pages a sequence to "
                             f"split over the data axes {dp}")
        out, cache = _paged_decode_cp(q[:, 0], k[:, 0], v[:, 0], cache, cfg,
                                      mesh, dp, softcap, donate, plan)
    elif layout == "pages":
        whole = paged.gather_pages(cache, mesh, dp)
        out, whole = _decode_local(q, k, v, whole, cfg, window, softcap,
                                   True, plan)
        cache = paged.own_shard(whole, mesh, dp)
    else:
        out, cache = _decode_local(q, k, v, cache, cfg, window, softcap,
                                   donate, plan)
    wo = p["wo"]
    if plan is not None and plan.q_cut:
        wo = wo[plan.q0 * cfg.head_dim:plan.q1 * cfg.head_dim]
    out = out.reshape(b, 1, -1) @ wo.to(cdtype(cfg))
    if plan is not None:
        out = _sum_over_model(out, mesh)
    return out, cache


def _qkv_rope(p: dict, x: torch.Tensor, lengths: torch.Tensor,
              cfg: ModelConfig, plan: Optional[Heads] = None):
    """q, k, v of one decode step, (B, 1, heads, D), rotated to the
    positions ``lengths``."""
    q, k, v = _qkv(p, x, cfg, plan)
    positions = lengths[:, None]                    # (B, 1)
    if cfg.mrope:
        positions = positions[..., None].expand(-1, -1, 3)
    q, k = _apply_rope(q, k, positions, cfg)
    return q, k, v


def _decode_local(q, k, v, cache: paged.PagedKV, cfg: ModelConfig, window,
                  softcap, donate, plan: Optional[Heads] = None):
    """The single-device body: append every kv head, then K8 (no window)
    or the gather and the plain version under the window mask, on
    ``plan``'s heads.  q (B, 1, heads, D), k, v (B, 1, Hkv, D)."""
    cache = paged.append(cache, k[:, 0], v[:, 0], inplace=donate)
    return _attend(q[:, 0], cache, cfg, window, softcap, plan), cache


def _attend(q, cache: paged.PagedKV, cfg: ModelConfig, window, softcap,
            plan: Optional[Heads] = None):
    """q (B, heads, D) over the appended cache → (B, heads, D): one call a
    run of heads, each over its kv heads' view of the pages."""
    runs, base = (_all_runs(cfg), 0) if plan is None else (plan.runs,
                                                             plan.q0)
    outs = []
    for q0, q1, k0, k1 in runs:
        qr = q[:, q0 - base:q1 - base]
        view = cache._replace(k_pages=cache.k_pages[:, :, k0:k1],
                              v_pages=cache.v_pages[:, :, k0:k1])
        if window is None:
            outs.append(kops.paged_decode_attention(
                qr, view.k_pages, view.v_pages, view.page_table,
                view.lengths, softcap=softcap, impl=cfg.kernels))
            continue
        kf, vf, mask = paged.gather(view)           # batched access
        pos_in_seq = torch.arange(mask.shape[1], device=mask.device)[None, :]
        cur = view.lengths[:, None] - 1
        mask = mask & (pos_in_seq >= cur - window)
        outs.append(kref.decode_attention_ref(qr, kf, vf, mask,
                                              softcap=softcap))
    if not outs:                                    # a rank with no head
        return q
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def _cp_logits(q, k_pages, pos0: int, new_len, scale: float, softcap,
               kv_index):
    """One rank's scores in a context-parallel step: q (Hq, D) against its
    pages (P_loc, ps, kvh, D) holding positions pos0, pos0 + 1, …, in
    float32, masked to the positions below ``new_len`` (NEG_INF past
    them); q head i reads kv head ``kv_index[i]``.  Returns (logits (Hq,
    S_loc), mask (S_loc,))."""
    n, ps, kvh, hd = k_pages.shape
    kf = k_pages.reshape(n * ps, kvh, hd)[:, kv_index].float()
    pos = pos0 + torch.arange(n * ps, device=q.device)
    mask = pos < new_len
    logits = torch.einsum("hd,shd->hs", q.float(), kf) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return torch.where(mask[None, :], logits, kref.NEG_INF), mask


def _paged_decode_cp(q, k_new, v_new, cache: paged.PagedKV,
                     cfg: ModelConfig, mesh, dp, softcap, donate,
                     plan: Optional[Heads] = None):
    """Context-parallel single-sequence decode under the identity table
    (``repro/models/attention.py:211-282``): the pages split over dp; the
    owner of the tail page takes the append (every kv head); every rank
    attends over its pages in float32 with its q heads (``plan``'s, or
    all); the partials merge with one all-reduce MAX and two SUMs
    (flash-decoding), a rank with no visible position adding zeros, and a
    sum of 0 read as 1.  q: (1, heads, D), k_new, v_new: (1, kvh, D).
    Returns (out (1, heads, D), the updated shard)."""
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
    g = cfg.n_heads // cfg.n_kv_heads
    q0, q1 = (0, cfg.n_heads) if plan is None else (plan.q0, plan.q1)
    kv_index = torch.arange(q0, q1, device=q.device) // g
    logits, mask = _cp_logits(q[0], kp, off * ps, new_len,
                              1.0 / math.sqrt(cfg.head_dim), softcap,
                              kv_index)
    m = logits.max(dim=1).values                     # (Hq,)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p_ = torch.where(mask[None, :], torch.exp(logits - m[:, None]), 0.0)
    l = p_.sum(dim=1)
    vf = vp.reshape(p_loc * ps, *vp.shape[2:])[:, kv_index].float()
    acc = torch.einsum("hs,shd->hd", p_, vf)
    dist.all_reduce(l, group=group)
    dist.all_reduce(acc, group=group)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[:, None]).to(q.dtype)[None]
    return out, cache._replace(k_pages=kp, v_pages=vp,
                               lengths=cache.lengths + 1)
