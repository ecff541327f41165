"""Model assembly: init, forward, prefill, decode — the dense family (with
gemma2's alternating local/global layers, and the untied LM head of
nemotron), the MoE family (granite-moe, phi3.5-moe: the dense block with
``models/moe.py`` for its MLP), the ssm family (falcon-mamba, mamba1
blocks over K9), the hybrid family (zamba2: mamba2 blocks with one
shared attention block between segments of them) and the frontend-stub
families (musicgen: audio; qwen2-vl: vision with M-RoPE), whose dense
blocks take embeddings in place of token ids.

Port of ``repro/models/lm.py``.  Entry points:

  init_params(cfg, gen, device=, dtype=)      → params
  forward_hidden(params, inputs, cfg, mesh=)  → (B, S, d)
  logits_fn(params, hidden, cfg, mesh=)       → (B, S, vocab_padded)
  loss_fn(params, batch, cfg, mesh=)          → scalar mean cross-entropy
  prefill(params, inputs, cfg, mesh=,
          max_len=)                           → (last logits, caches)
  decode_step(params, inputs, caches, cfg,
              mesh=, donate=False)            → (logits (B, 1, V), caches)
  make_cache(cfg, batch, max_len, device=,
             mesh=)                           → empty caches

``inputs``: {"tokens": (B, S) integer} or, for a frontend-stub config,
{"embeds": (B, S, d)}, plus "positions": (B, S) integer, or (B, S, 3)
under M-RoPE.
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

Every family trains: ``loss_fn``'s gradient runs through K6-with-LSE and
K7 (attention) and K9 and K9-bwd (the selective scan) on the card.

Serving on a mesh (``launch/mesh.py``; ``mesh=None`` is one device):
every rank passes the same global inputs and gets the same global logits
back, as an SPMD program does, and computes its share of the step as the
reference's ``jit`` partitions it over its input shardings
(``repro/launch/dryrun.py:107-195``).  ``params`` are this rank's shards
under ``ShardingRules.param_specs`` (``sharding_rules.shard_params`` cuts
them).

* **Rows over the data axes.**  Where the batch tiles the data axes (the
  reference's ``_constrain_tokens`` condition) a rank keeps its data
  rank's rows before ``_embed`` and the blocks run under the local
  convention (``core/sharding.py``), as ``loss_fn`` does; only the last
  position's logits are gathered over the data axes.  A batch that does
  not tile them (batch 1: the context-parallel decode, ``long_500k``)
  keeps its rows whole on every rank.
* **Heads, ff, ``d_inner`` and vocab over ``model``.**  Every block is
  gathered over its data axes alone (``core.sharding.gather_fsdp``) as
  its layer runs, so it keeps its ``model`` shards, and the layers split
  their compute where ``sharding_rules.model_dim`` says the weight is
  split: attention by heads (K6 / K8 on the rank's heads, ``wo``
  row-parallel), or, where the heads do not divide ``model``, by the
  reference's ``_attn_act_spec`` over the batch or the sequence; the MLP
  by ff columns; the mamba mixers by ``d_inner`` channels (K9 on the
  rank's channels, ``x_proj`` and ``out_proj`` row-parallel,
  ``models/ssm.py``); the embedding's take and the LM head by vocab (or
  by ``d`` where the vocab does not divide); the MoE's experts, as
  ``moe_roomy``'s exchange places them.  Row-parallel outputs join by an
  all-reduce over ``model``.
* **Replicated within a model group**: the norms, the router, and any
  weight a divisibility fallback of the rules replicated.

The decode caches are each rank's shard (``paged.shard_layout``: its
rows over the data axes, or at batch 1 its pages), with every kv head on
each model rank (``cache_specs``), which ``prefill`` writes directly and
``make_cache`` allocates; ``decode_step`` reads and writes them in place
of the whole.  The SSM states are the rank's rows where the batch tiles
the data axes, else whole, and the rank's channels of ``h`` and ``conv``
(``ssm.mixer_channels``; the reference's ``cache_specs`` put them over
``model`` at batch 1 alone, a layout with no effect on a number).
The reference's ``_constrain`` hints on other activations have no
counterpart.

Training on a mesh (``forward_hidden`` / ``loss_fn`` with ``mesh=``) keeps
the rules of ``core/sharding.py``: ``params`` are this rank's shards under
``ShardingRules.param_specs`` (``distributed.sharding_rules.shard_params``
cuts them), and ``batch`` is this data rank's rows, the same on every rank
of its model group (the local convention: the roomy exchanges split the
rows over ``model`` alone).  Each rank computes its share of the step as
in serving, under autograd: a block is gathered over its data axes alone
(``gather_fsdp``) inside its remat region, so no rank keeps a gathered
block for the backward (the non-reentrant ``checkpoint`` gathers again
there, and the gather's backward reduce-scatters the gradient to the
shard and sums it over the axes the spec replicates); the layers run the
rank's heads (K6-LSE / K7), ff columns, ``d_inner`` channels (K9 / K9-bwd)
and vocab columns.  The embedding, the final norm and the hybrid's
shared block are gathered once a call.  They are gathered in float32 and
each layer casts at use as it does off a mesh (the router and the norms
read the float32 values), so a one-rank mesh computes the bits of no
mesh.  The loss is a sum of shares: rank r takes ``L_r = Σ_{its rows}
−ll·mask / (global mask count · tp)``, the count from one ``all_reduce``
over the data axes, ``tp`` because the model group repeats the rows; the
log-likelihoods come from a vocab-parallel cross-entropy on the rank's
``V / tp`` float32 logit columns, which are never gathered (the row max
over ``model`` with no gradient, the sum of exponentials and the label's
logit by all-reduces over ``model``), as the reference constrains its
logits to vocab over ``model`` (``repro/models/lm.py:192-216``).
``loss_fn`` returns ``Σ_r L_r`` over the mesh with the gradient of this
rank's share, so that every parameter's gradient is the sum of the
ranks' parts of it.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from .. import tree as T
from ..core import paged
from ..core import sharding as SH
from ..distributed import sharding_rules as SR
from .blocks import (init_mamba_block, init_transformer_block, mamba_block,
                     mamba_block_decode, mamba_block_prefill,
                     transformer_block, transformer_block_decode)
from .config import ModelConfig
from .layers import (cdtype, embed_tokens, init_embedding, lm_head, rms_norm,
                     vocab_block)
from .ssm import init_ssm_state, mixer_channels

PAGE_SIZE = 128


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
    if cfg.local_global_pattern and cfg.n_layers % 2:
        raise ValueError("the local/global pattern needs an even n_layers")
    dev = _device.resolve(device)
    if dev.type == "meta":                    # shapes only: no numbers drawn
        gen = None
    elif not isinstance(gen, torch.Generator):
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

def _embed(params, inputs: Dict, cfg: ModelConfig, mesh=None
           ) -> torch.Tensor:
    """The stub frontend's embeddings in the compute dtype when the config
    has one and the inputs carry them, else the token ids' table rows
    (``repro/models/lm.py:110-116``; on a mesh, the roomy embedding where
    the config asks for it)."""
    if cfg.frontend_stub and "embeds" in inputs:
        x = inputs["embeds"].to(cdtype(cfg))
    else:
        x = embed_tokens(params["embed"], inputs["tokens"], cfg, mesh)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _on_mesh(params, cfg: ModelConfig, mesh):
    """(params with the embedding, the final norm and the hybrid's shared
    block gathered over their data axes, the blocks' specs, the mesh under
    the local convention holding model shards).  Off a mesh: (params, a
    None spec a block, None)."""
    if mesh is None:
        return params, [None] * cfg.n_layers, None
    specs = SR.config_specs(cfg, mesh)
    view = SH.MeshView(mesh, local=True)
    out = dict(params)
    for key in ("embed", "final_norm", "shared"):
        if key in params:
            out[key] = _block(params[key], specs[key], view)
    return out, specs["blocks"], view


def _block(p_l, spec_l, mesh):
    """One block's params: off a mesh ``p_l`` itself (``spec_l`` None);
    on one, gathered over the data axes alone, each leaf keeping its
    ``model`` shard (``core.sharding.gather_fsdp``)."""
    if spec_l is None:
        return p_l
    return T.tree_map(lambda x, spec: SH.gather_fsdp(x, spec, mesh), p_l,
                      spec_l)


class _Serve(NamedTuple):
    """A serving call on a mesh: the params with the embedding, the final
    norm and the hybrid's shared block gathered over their data axes, the
    blocks' specs, the mesh view the layers get, the inputs this rank
    serves, and (this data rank, data ranks) whose rows those are ((0, 1)
    where every rank serves the whole batch)."""
    params: dict
    specs: list
    mesh: object
    inputs: dict
    rows: Tuple[int, int]


def _serve_on_mesh(params, inputs: Dict, cfg: ModelConfig, mesh) -> _Serve:
    """Off a mesh: everything as given.  On one: this data rank's rows
    where the batch tiles the data axes (the local convention), else the
    whole batch (the global one), and the layers' view holding model
    shards (the module docstring)."""
    if mesh is None:
        return _Serve(params, [None] * cfg.n_layers, None, inputs, (0, 1))
    specs = SR.config_specs(cfg, mesh)
    i, n = _dp_shard(mesh)
    local = next(iter(inputs.values())).shape[0] % n == 0
    view = SH.MeshView(mesh, local=local)
    if local and n > 1:
        dp = SH.data_axes(mesh)
        inputs = {k: SH.shard_leading(v, mesh, dp) for k, v in inputs.items()}
    out = dict(params)
    for key in ("embed", "final_norm", "shared"):
        if key in params:
            out[key] = _block(params[key], specs[key], view)
    return _Serve(out, specs["blocks"], view, inputs,
                  (i, n) if local else (0, 1))


def _last_logits(sv: _Serve, hidden, cfg: ModelConfig, mesh):
    """The logits of the rows this rank served, gathered over the data
    axes when those were its data rank's rows."""
    logits = logits_fn(sv.params, hidden, cfg, sv.mesh)
    if sv.rows[1] > 1:
        logits = SH.gather_leading(logits, mesh, SH.data_axes(mesh))
    return logits


def _hidden(params, inputs: Dict, cfg: ModelConfig, mesh, specs
            ) -> torch.Tensor:
    """``forward_hidden`` from ``_on_mesh``'s params, block specs (a block
    whose spec is None is whole) and mesh."""
    x = _embed(params, inputs, cfg, mesh)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, p_l, spec_l, x, *args, **kw):
        def body(p_l, x, *args):          # gathered inside the remat region
            return fn(_block(p_l, spec_l, mesh), x, *args, **kw)
        if remat:
            return checkpoint(body, p_l, x, *args, use_reentrant=False)
        return body(p_l, x, *args)
    if cfg.family in ("ssm", "hybrid"):
        version = 1 if cfg.family == "ssm" else 2
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l, spec_l in zip(params["blocks"][s0:s1], specs[s0:s1]):
                x = run(mamba_block, p_l, spec_l, x, cfg, version=version,
                        mesh=mesh)
            if shared:
                x = transformer_block(params["shared"], x,
                                      inputs["positions"], cfg, mesh=mesh)
        return rms_norm(x, params["final_norm"], cfg.rms_eps)
    for p_l, spec_l, w in zip(params["blocks"], specs, layer_windows(cfg)):
        x = run(transformer_block, p_l, spec_l, x, inputs["positions"], cfg,
                window=w, mesh=mesh)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def forward_hidden(params, inputs: Dict, cfg: ModelConfig, mesh=None
                   ) -> torch.Tensor:
    """With ``cfg.remat`` and grad mode on, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    and recomputed in the backward, as the reference's ``_maybe_remat``
    does with ``jax.checkpoint`` (``repro/models/lm.py:120-121,148-159``):
    every transformer block, and every mamba block of the ssm and hybrid
    families.  The hybrid's shared block runs after each segment that asks
    for it, never rematted, as in the reference.  On a mesh ``params`` are
    this rank's shards and ``inputs`` this data rank's rows (the module
    docstring); the result is those rows' hidden states."""
    params, specs, local = _on_mesh(params, cfg, mesh)
    return _hidden(params, inputs, cfg, local, specs)


def logits_fn(params, hidden: torch.Tensor, cfg: ModelConfig,
              mesh=None) -> torch.Tensor:
    """``mesh``: the layers' view of a call on a mesh (vocab-parallel on
    model shards, the columns gathered); None for whole params."""
    return lm_head(params["embed"], hidden, cfg, mesh)


def _loss_denominator(mask: torch.Tensor, mesh) -> torch.Tensor:
    """The global mask count (one ``all_reduce`` over the data axes) times
    ``tp``, the model group's size, which repeats the rows."""
    count = mask.sum().reshape(1)
    dp = SH.data_axes(mesh)
    if dp:
        dist.all_reduce(count, group=SH.axis_group(mesh, dp)[0])
    tp = SH.mesh_axes(mesh).get("model", 1)
    return count[0] * tp


class _MeshLoss(torch.autograd.Function):
    """The value Σ_r L_r over the mesh (one ``all_reduce``); the gradient
    this rank's share's."""

    @staticmethod
    def forward(ctx, share, group):
        total = share.detach().clone().reshape(1)
        dist.all_reduce(total, group=group)
        return total[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


def _log_likelihood(logits: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, mesh) -> torch.Tensor:
    """log softmax(logits)[label] of each position (labels clamped to 0).
    Where the LM head is vocab-parallel (``layers.vocab_block``) the
    logits are this rank's ``V / tp`` columns, and the cross-entropy is
    vocab-parallel: the row max over ``model`` with no gradient, the sum
    of exponentials and the label's logit each by a differentiable
    all-reduce over ``model``; every rank of the group gets every row's
    value."""
    block = vocab_block(cfg, mesh) if mesh is not None else None
    if block is None:
        logp = torch.log_softmax(logits, dim=-1)
        return logp.gather(-1, labels[..., None])[..., 0]
    v0, width = block
    with torch.no_grad():
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX,
                        group=SH.axis_group(mesh, "model")[0])
    sumexp = SH.all_reduce(torch.exp(logits - m[..., None]).sum(-1), mesh,
                           "model")
    local = labels - v0
    mine = (local >= 0) & (local < width)
    picked = logits.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    picked = SH.all_reduce(torch.where(mine, picked, 0.0), mesh, "model")
    return picked - m - torch.log(sumexp)


def loss_fn(params, batch: Dict, cfg: ModelConfig, mesh=None
            ) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is >= 0, on
    float32 logits (``repro/models/lm.py:192-216``).  ``batch``:
    {"inputs": {"tokens" or "embeds", "positions"}, "labels": (B, S)}.  On
    a mesh: ``params`` this rank's shards, ``batch`` this data rank's rows;
    the value is the mesh's loss, the gradient this rank's share's (the
    module docstring)."""
    top, specs, view = _on_mesh(params, cfg, mesh)
    hidden = _hidden(top, batch["inputs"], cfg, view, specs)
    logits = lm_head(top["embed"], hidden, cfg, view, gather=False).float()
    labels = batch["labels"].long()
    mask = labels >= 0
    ll = _log_likelihood(logits, labels.clamp(min=0), cfg, view)
    if mesh is None:
        return -(ll * mask).sum() / mask.sum().clamp(min=1)
    share = -(ll * mask).sum() / _loss_denominator(mask, mesh).clamp(min=1)
    return _MeshLoss.apply(share, SH.axis_group(
        mesh, tuple(SH.mesh_axes(mesh)))[0])


# ------------------------------------------------------ caches / decode

def _round_len(max_len: int) -> int:
    return -(-max_len // PAGE_SIZE) * PAGE_SIZE


def _kv_to_pages(k, v, max_len: int, cfg: ModelConfig,
                 pages: Optional[slice] = None):
    """(B, S, kvh, hd) → (B·pps, ps, kvh, hd) pages under the identity
    table: a pad to max_len and a reshape, no scatter.  ``pages``: only
    those pages of a batch of one (a rank's shard at batch 1), cut from
    the positions before the pad."""
    if pages is not None:
        t0, t1 = pages.start * PAGE_SIZE, pages.stop * PAGE_SIZE
        k, v, max_len = k[:, t0:t1], v[:, t0:t1], t1 - t0
    b, s, kvh, hd = k.shape
    pad = max_len - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    shape = (b * (max_len // PAGE_SIZE), PAGE_SIZE, kvh, hd)
    return (k.reshape(shape).to(cdtype(cfg)),
            v.reshape(shape).to(cdtype(cfg)))


def _dp_shard(mesh):
    """(this rank's coordinate, size) over the mesh's data axes; (0, 1)
    off a mesh."""
    dp = SH.data_axes(mesh)
    if not dp:
        return 0, 1
    return SH.axis_index(mesh, dp), SH.axis_size(mesh, dp)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               mesh=None):
    """Empty decode caches: one ``PagedKV`` per layer; for the ssm family
    one zero ``SSMState`` per layer (``max_len`` unused); for the hybrid
    family one mamba2 ``SSMState`` per layer and one ``PagedKV`` per
    application of the shared block.  On a mesh each ``PagedKV`` is this
    rank's shard only, and each ``SSMState`` its data rank's rows where
    the batch tiles the data axes, and its model rank's channels."""
    dev = _device.resolve(device)
    max_len = _round_len(max_len)
    shard = _dp_shard(mesh)

    def kv(n):
        return [paged.make(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                           page_size=PAGE_SIZE, dtype=cdtype(cfg), device=dev,
                           shard=shard)
                for _ in range(n)]
    if cfg.family in ("ssm", "hybrid"):
        version = 1 if cfg.family == "ssm" else 2
        rows = batch // shard[1] if batch % shard[1] == 0 else batch
        channels = mixer_channels(
            cfg, None if mesh is None else SH.MeshView(mesh, local=True),
            version)
        caches = {"ssm": [init_ssm_state(cfg, rows, dev, version, channels)
                          for _ in range(cfg.n_layers)]}
        if cfg.family == "hybrid":
            caches["kv"] = kv(n_shared_applications(cfg))
        return caches
    return {"kv": kv(cfg.n_layers)}


def prefill(params, inputs: Dict, cfg: ModelConfig, mesh=None,
            max_len: Optional[int] = None):
    """Full forward that builds the decode caches; returns (logits of the
    last position (B, 1, V), caches).  For the ssm family the caches are
    each layer's ``SSMState`` after the prompt (K9's final state and the
    conv's last inputs); ``max_len`` is unused.  The hybrid family's are
    each mamba2 layer's ``SSMState`` and each shared-block application's
    ``PagedKV``.  On a mesh ``params`` are this rank's shards, each rank
    computes its share (the module docstring), and each ``PagedKV`` is
    written as this rank's shard of the pages (``repro/models/lm.py:221-
    242``: pages over dp)."""
    sv = _serve_on_mesh(params, inputs, cfg, mesh)
    params, specs, view, inputs = sv.params, sv.specs, sv.mesh, sv.inputs
    x = _embed(params, inputs, cfg, view)
    if cfg.family == "ssm":
        states = []
        for p_l, spec_l in zip(params["blocks"], specs):
            x, st = mamba_block_prefill(_block(p_l, spec_l, view), x, cfg,
                                        mesh=view)
            states.append(st)
        hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return _last_logits(sv, hidden, cfg, mesh), {"ssm": states}
    b, s = x.shape[0], x.shape[1]
    batch = b * sv.rows[1]
    max_len = _round_len(max_len or s)
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    pps = max_len // PAGE_SIZE
    i, n = _dp_shard(mesh)
    layout = paged.shard_layout(batch, pps, n) if n > 1 else None
    pages, rows = paged._shard_slices(layout, batch, pps, i, n)
    table = paged.identity_table(batch, pps, x.device)[rows]
    lengths = torch.full((table.shape[0],), s, dtype=torch.int32,
                         device=x.device)
    cut = pages if layout == "pages" else None

    def attend(p_l, x, window=None):
        x, (k, v) = transformer_block(p_l, x, inputs["positions"], cfg,
                                      window=window, return_kv=True,
                                      mesh=view)
        kp, vp = _kv_to_pages(k, v, max_len, cfg, cut)
        return x, paged.PagedKV(kp, vp, table, lengths)
    caches = []
    if cfg.family == "hybrid":
        states = []
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l, spec_l in zip(params["blocks"][s0:s1], specs[s0:s1]):
                x, st = mamba_block_prefill(_block(p_l, spec_l, view), x,
                                            cfg, version=2, mesh=view)
                states.append(st)
            if shared:
                x, c = attend(params["shared"], x)
                caches.append(c)
        hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return (_last_logits(sv, hidden, cfg, mesh),
                {"ssm": states, "kv": caches})
    for p_l, spec_l, w in zip(params["blocks"], specs, layer_windows(cfg)):
        x, c = attend(_block(p_l, spec_l, view), x, w)
        caches.append(c)
    hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return _last_logits(sv, hidden, cfg, mesh), {"kv": caches}


def decode_step(params, inputs: Dict, caches, cfg: ModelConfig, mesh=None,
                *, donate: bool = False):
    """One-token step.  inputs: {"tokens": (B, 1)} or, for a frontend
    stub, {"embeds": (B, 1, d)}; rope positions come from the caches'
    lengths.  Returns (logits (B, 1, V), new caches);
    the caches passed in are left as they were, unless ``donate``: then
    each layer's new K/V row is written into the pages passed in (the
    returned caches share them), as the reference's decode step donates
    its caches to ``jit`` (``repro/launch/dryrun.py:188-191``), so a step
    holds one copy of the cache and moves none of it.  Every unwindowed
    attention layer reads its cache with K8 (the hybrid's shared block
    once per application, each over its own cache).  On a mesh ``params``
    are this rank's shards, the caches this rank's shards (``prefill`` /
    ``make_cache`` with the same mesh), each rank computes its share (the
    module docstring), and the attention takes the reference's sharded
    branches, K8 on the rank's heads."""
    sv = _serve_on_mesh(params, inputs, cfg, mesh)
    params, specs, view = sv.params, sv.specs, sv.mesh
    x = _embed(params, sv.inputs, cfg, view)
    if cfg.family == "ssm":
        states = []
        for p_l, spec_l, st in zip(params["blocks"], specs, caches["ssm"]):
            x, st = mamba_block_decode(_block(p_l, spec_l, view), x, st, cfg,
                                       mesh=view)
            states.append(st)
        hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return _last_logits(sv, hidden, cfg, mesh), {"ssm": states}
    if cfg.family == "hybrid":
        states, new = [], []
        kv = iter(caches["kv"])
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l, spec_l, st in zip(params["blocks"][s0:s1],
                                       specs[s0:s1], caches["ssm"][s0:s1]):
                x, st = mamba_block_decode(_block(p_l, spec_l, view), x, st,
                                           cfg, version=2, mesh=view)
                states.append(st)
            if shared:
                x, c = transformer_block_decode(params["shared"], x,
                                                next(kv), cfg, donate=donate,
                                                mesh=view)
                new.append(c)
        hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return (_last_logits(sv, hidden, cfg, mesh),
                {"ssm": states, "kv": new})
    new = []
    for p_l, spec_l, c, w in zip(params["blocks"], specs, caches["kv"],
                                 layer_windows(cfg)):
        x, c = transformer_block_decode(_block(p_l, spec_l, view), x, c, cfg,
                                        window=w, donate=donate, mesh=view)
        new.append(c)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _last_logits(sv, hidden, cfg, mesh), {"kv": new}
