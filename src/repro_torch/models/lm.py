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
  logits_fn(params, hidden, cfg)              → (B, S, vocab_padded)
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
every rank passes the same inputs and gets the same logits back, as an
SPMD program does, with the params whole on every rank.  The roomy
embedding and the roomy MoE exchange tokens over the mesh
(``layers.py``, ``moe.py``); attention and the mamba blocks run
replicated; the decode caches are each rank's shard
(``paged.shard_layout``: rows over the data axes when the batch splits
over them, pages at batch 1), which ``prefill`` and ``make_cache``
produce and ``decode_step`` reads and writes in place of the whole.  The
SSM state stays whole on every rank (the reference's ``cache_specs``
only give GSPMD a layout for it).  The reference's ``_constrain`` /
``_constrain_tokens`` are GSPMD layout hints with no effect on a number;
activations here are global on every rank, so they have no counterpart.

Training on a mesh (``forward_hidden`` / ``loss_fn`` with ``mesh=``) keeps
the rules of ``core/sharding.py``: ``params`` are this rank's shards under
``ShardingRules.param_specs`` (``distributed.sharding_rules.shard_params``
cuts them), and ``batch`` is this data rank's rows, the same on every rank
of its model group (the local convention: the roomy exchanges split the
rows over ``model`` alone).  A block's params are gathered whole
(``core.sharding.gather_param``) inside its remat region, so no rank keeps
a gathered block for the backward: the non-reentrant ``checkpoint``
gathers again there, and the gather's backward reduce-scatters the
gradient to the shard.  The embedding, the final norm and the hybrid's
shared block are gathered once a call.  They are gathered in float32 and
each layer casts at use as it does off a mesh (the router and the norms
read the float32 values), so a one-rank mesh computes the bits of no
mesh.  The loss is a sum of shares: rank r takes ``L_r = Σ_{its rows}
−ll·mask / (global mask count · tp)``, the count from one ``all_reduce``
over the data axes, ``tp`` because the model group repeats the rows;
``loss_fn`` returns ``Σ_r L_r`` over the mesh (the reference's
``repro/models/lm.py:211-216``) with the gradient of this rank's share,
so that every parameter's gradient is the sum of the ranks' parts of it.
Compute stays replicated within a model group apart from the roomy
exchanges: TP is a storage layout, as in serving.  The reference's
``_constrain`` on the logits is a layout hint with no counterpart.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

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
from .layers import cdtype, embed_tokens, init_embedding, lm_head, rms_norm
from .ssm import init_ssm_state

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


def _gather_tree(tree, specs, mesh):
    """Each shard of ``tree`` gathered whole under its spec."""
    return T.tree_map(lambda x, spec: SH.gather_param(x, spec, mesh), tree,
                      specs)


def _on_mesh(params, cfg: ModelConfig, mesh):
    """(params with the embedding, the final norm and the hybrid's shared
    block gathered whole, the blocks' specs, the mesh under the local
    convention)."""
    specs = SR.config_specs(cfg, mesh)
    local = SH.LocalRows(mesh)
    out = dict(params)
    for key in ("embed", "final_norm", "shared"):
        if key in params:
            out[key] = _gather_tree(params[key], specs[key], local)
    return out, specs["blocks"], local


def _hidden(params, inputs: Dict, cfg: ModelConfig, mesh=None,
            block_specs=None) -> torch.Tensor:
    """``forward_hidden`` from params whose blocks are whole
    (``block_specs`` None) or shards under ``block_specs``."""
    x = _embed(params, inputs, cfg, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    specs = block_specs or [None] * cfg.n_layers

    def run(fn, p_l, spec_l, x, *args, **kw):
        def body(p_l, x, *args):
            if spec_l is not None:        # gathered inside the remat region
                p_l = _gather_tree(p_l, spec_l, mesh)
            return fn(p_l, x, *args, **kw)
        if remat:
            return checkpoint(body, p_l, x, *args, use_reentrant=False)
        return body(p_l, x, *args)
    if cfg.family in ("ssm", "hybrid"):
        version = 1 if cfg.family == "ssm" else 2
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l, spec_l in zip(params["blocks"][s0:s1], specs[s0:s1]):
                x = run(mamba_block, p_l, spec_l, x, cfg, version=version)
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
    if mesh is None:
        return _hidden(params, inputs, cfg)
    params, block_specs, local = _on_mesh(params, cfg, mesh)
    return _hidden(params, inputs, cfg, local, block_specs)


def logits_fn(params, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return lm_head(params["embed"], hidden, cfg)


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


def loss_fn(params, batch: Dict, cfg: ModelConfig, mesh=None
            ) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is >= 0, on
    float32 logits (``repro/models/lm.py:192-216``).  ``batch``:
    {"inputs": {"tokens" or "embeds", "positions"}, "labels": (B, S)}.  On
    a mesh: ``params`` this rank's shards, ``batch`` this data rank's rows;
    the value is the mesh's loss, the gradient this rank's share's (the
    module docstring)."""
    if mesh is None:
        hidden = _hidden(params, batch["inputs"], cfg)
        top = params
    else:
        top, block_specs, local = _on_mesh(params, cfg, mesh)
        hidden = _hidden(top, batch["inputs"], cfg, local, block_specs)
    logits = logits_fn(top, hidden, cfg).float()
    labels = batch["labels"].long()
    mask = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    if mesh is None:
        return -(ll * mask).sum() / mask.sum().clamp(min=1)
    share = -(ll * mask).sum() / _loss_denominator(mask, mesh).clamp(min=1)
    return _MeshLoss.apply(share, SH.axis_group(
        mesh, tuple(SH.mesh_axes(mesh)))[0])


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
    rank's shard only."""
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
        caches = {"ssm": [init_ssm_state(cfg, batch, dev, version)
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
    ``PagedKV``.  On a mesh each ``PagedKV`` keeps this rank's shard of
    the pages (``repro/models/lm.py:221-242``: pages over dp)."""
    x = _embed(params, inputs, cfg, mesh)
    if cfg.family == "ssm":
        states = []
        for p_l in params["blocks"]:
            x, st = mamba_block_prefill(p_l, x, cfg)
            states.append(st)
        hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states}
    b, s = x.shape[0], x.shape[1]
    max_len = _round_len(max_len or s)
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    table = paged.identity_table(b, max_len // PAGE_SIZE, x.device)
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    i, n = _dp_shard(mesh)

    def attend(p_l, x, window=None):
        x, (k, v) = transformer_block(p_l, x, inputs["positions"], cfg,
                                      window=window, return_kv=True,
                                      mesh=mesh)
        kp, vp = _kv_to_pages(k, v, max_len, cfg)
        cache = paged.PagedKV(kp, vp, table, lengths)
        if n > 1:                     # keep this rank's shard, not views
            cache = paged.PagedKV(*(t.clone() for t in paged.shard(
                cache, i, n)))
        return x, cache
    caches = []
    if cfg.family == "hybrid":
        states = []
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l in params["blocks"][s0:s1]:
                x, st = mamba_block_prefill(p_l, x, cfg, version=2)
                states.append(st)
            if shared:
                x, c = attend(params["shared"], x)
                caches.append(c)
        hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states, "kv": caches}
    for p_l, w in zip(params["blocks"], layer_windows(cfg)):
        x, c = attend(p_l, x, w)
        caches.append(c)
    hidden = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return logits_fn(params, hidden, cfg), {"kv": caches}


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
    once per application, each over its own cache).  On a mesh the caches
    are this rank's shards (``prefill`` / ``make_cache`` with the same
    mesh) and the attention takes the reference's sharded branches."""
    x = _embed(params, inputs, cfg, mesh)
    if cfg.family == "ssm":
        states = []
        for p_l, st in zip(params["blocks"], caches["ssm"]):
            x, st = mamba_block_decode(p_l, x, st, cfg)
            states.append(st)
        hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states}
    if cfg.family == "hybrid":
        states, new = [], []
        kv = iter(caches["kv"])
        for s0, s1, shared in _hybrid_segments(cfg):
            for p_l, st in zip(params["blocks"][s0:s1],
                               caches["ssm"][s0:s1]):
                x, st = mamba_block_decode(p_l, x, st, cfg, version=2)
                states.append(st)
            if shared:
                x, c = transformer_block_decode(params["shared"], x,
                                                next(kv), cfg, donate=donate,
                                                mesh=mesh)
                new.append(c)
        hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return logits_fn(params, hidden, cfg), {"ssm": states, "kv": new}
    new = []
    for p_l, c, w in zip(params["blocks"], caches["kv"], layer_windows(cfg)):
        x, c = transformer_block_decode(p_l, x, c, cfg, window=w,
                                        donate=donate, mesh=mesh)
        new.append(c)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return logits_fn(params, hidden, cfg), {"kv": new}
