"""Per-arch sharding rules: params, batches, caches → partition specs (port
of ``repro/distributed/sharding_rules.py``).

Policy (DESIGN.md §5): TP over ``model`` on head/ff/expert/vocab dims where
the dim divides evenly; FSDP (ZeRO-3) over ``data`` (+``pod``) on the
opposite dim; batch/tokens over (``pod``, ``data``).  Divisibility
fallbacks replicate the offending dim and are reported by ``describe()``,
in the reference's words.

Leaf rules are keyed by parameter name with a *trailing-dims role
pattern*.  The reference stacks its blocks ((L, …), or (L/2, 2, …) for
gemma2's local/global pairs) and gives the stack dims None; the port keeps
a list of L block dicts, so a block leaf's spec is the reference's for the
stacked shape with the stack's leading Nones dropped (and ``describe()``
names the stacked shapes, as the reference's does).  Caches likewise: the
port's per-layer ``PagedKV`` / ``SSMState`` leaves get the reference's spec
of a one-dim (L, …) stack, with that None dropped.  At batch 1 the
reference gives gemma2's (L/2, 2, P, …) pages its (None, dp, …) spec too,
which puts dp on the pair axis; the port shards the pages.

A spec is a ``PartitionSpec``: a tuple with one entry a dim (an axis name,
a tuple of names taken as one flattened axis, or None), trailing dims
replicated.  ``named`` turns specs into ``torch.distributed.tensor``
placements, one per mesh dim.  Serving on a mesh holds its caches as
local shards under ``cache_specs``.  Serving and a train step hold their
params (and the step its AdamW moments) as each rank's shards under
``param_specs`` (TP over ``model``, ZeRO-3 over the
data axes, the fallbacks replicated): ``shard_params`` cuts a whole tree
into this rank's shards and ``gather_params`` rebuilds it, both by the
same placements as ``named``; ``config_specs`` gives a config's spec tree
without allocating its params.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import tree as T
from ..core import sharding as SH
from ..core.sharding import mesh_axes
from ..models.config import ModelConfig

# trailing-dim role patterns per leaf name
_PATTERNS: Dict[str, Tuple[str, ...]] = {
    # embeddings: vocab TP over model; d over model only as the fallback
    # when vocab doesn't divide (never over data — batch owns that axis in
    # the gather)
    "table": ("vocab", "d_embed"),
    "head": ("d_embed", "vocab"),
    # attention
    "wq": ("fsdp", "tp_q"),
    "wk": ("fsdp", "tp_kv"),
    "wv": ("fsdp", "tp_kv"),
    "wo": ("tp_q", "fsdp"),
    # dense mlp
    "up": ("fsdp", "tp_ff"),
    "gate": ("fsdp", "tp_ff"),
    "down": ("tp_ff", "fsdp"),
    # moe (detected by ndim: expert leaves have a leading E dim)
    "router": ("fsdp", "none"),
    # mamba
    "in_proj": ("fsdp", "tp_di"),
    "conv_w": ("none", "tp_conv"),
    "conv_b": ("tp_conv",),
    "x_proj": ("tp_di", "none"),
    "dt_proj": ("none", "tp_di"),
    "dt_bias": ("none",),
    "a_log": ("tp_di", "none"),
    "d_skip": ("tp_di",),
    "out_proj": ("tp_di", "fsdp"),
    # norms
    "ln1": ("none",), "ln2": ("none",), "post_ln1": ("none",),
    "post_ln2": ("none",), "ln": ("none",), "norm": ("none",),
    "final_norm": ("none",),
}

_MOE_PATTERNS: Dict[str, Tuple[str, ...]] = {
    "up": ("ep", "fsdp", "none"),
    "gate": ("ep", "fsdp", "none"),
    "down": ("ep", "none", "fsdp"),
}


class PartitionSpec(tuple):
    """One entry a dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _drop(spec: P, n: int) -> P:
    """``spec`` without its first ``n`` entries (the stack's Nones)."""
    return P(*spec[n:])


class ShardingRules:
    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        shape = mesh_axes(mesh)
        self.shape = shape
        self.tp = shape.get("model", 1)
        self.fsdp_axes = tuple(a for a in ("pod", "data") if a in shape)
        self.fsdp = math.prod(shape[a] for a in self.fsdp_axes) or 1
        self.dp_axes = self.fsdp_axes
        self.fallbacks: List[str] = []

    # ------------------------------------------------------- role → axis
    def _axis_for(self, role: str, dim: int, leaf: str) -> Optional[object]:
        cfg, tp = self.cfg, self.tp
        if role == "none":
            return None
        if role == "fsdp":
            if self.fsdp > 1 and dim % self.fsdp == 0:
                return self.fsdp_axes if len(self.fsdp_axes) > 1 \
                    else self.fsdp_axes[0]
            if self.fsdp > 1:
                self.fallbacks.append(f"{leaf}: dim {dim} !% fsdp {self.fsdp}")
            return None
        if role == "d_embed":
            # only shard d over model when the vocab dim could not be
            if cfg.vocab_padded % tp != 0 and tp > 1 and dim % tp == 0:
                return "model"
            return None
        # TP roles — require clean division by the model axis
        ok = dim % tp == 0
        if role == "tp_q":
            ok = ok and cfg.n_heads % tp == 0
        elif role == "tp_kv":
            ok = ok and cfg.n_kv_heads % tp == 0
        elif role == "vocab":
            ok = ok and cfg.vocab_padded % tp == 0
        if not ok:
            if tp > 1:
                self.fallbacks.append(f"{leaf}: role {role} dim {dim} "
                                      f"replicated (tp={tp})")
            return None
        if role == "ep":
            return "model"
        return "model" if tp > 1 else None

    def _spec_for(self, path: str, shape: Tuple[int, ...]) -> P:
        """The reference's spec of the leaf at ``path`` ("blocks/attn/wq")
        with the (stacked) ``shape``."""
        leaf = path.split("/")[-1]
        in_moe = "/moe/" in path or path.endswith("moe")
        pattern = (_MOE_PATTERNS.get(leaf) if in_moe and leaf in _MOE_PATTERNS
                   else _PATTERNS.get(leaf))
        if pattern is None:
            return P()                                    # replicate unknown
        roles = ("none",) * (len(shape) - len(pattern)) + pattern
        return P(*(self._axis_for(r, d, f"{path}{shape}")
                   for r, d in zip(roles, shape)))

    def _stack(self) -> Tuple[int, ...]:
        """The reference's stack dims of a block leaf."""
        n = self.cfg.n_layers
        return (n // 2, 2) if self.cfg.local_global_pattern else (n,)

    # ------------------------------------------------------------- trees
    def param_specs(self, params) -> dict:
        """params: the port's params (tensors, or anything with a
        ``shape``: ``lm.init_params(..., device="meta")`` allocates none)
        → the same tree with a spec a leaf."""
        stack = self._stack()

        def spec(path, leaf):
            if path[0] == "blocks":                  # ("blocks", i, ...)
                name = "/".join(("blocks",) + path[2:])
                full = self._spec_for(name, stack + tuple(leaf.shape))
                return _drop(full, len(stack))
            return self._spec_for("/".join(path), tuple(leaf.shape))
        return _map_with_path(spec, params)

    def _dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else (
            self.dp_axes[0] if self.dp_axes else None)

    def batch_spec(self) -> P:
        """(B, S) token batches: batch over (pod, data)."""
        return P(self._dp())

    def token_spec(self, extra_dims: int = 1) -> P:
        return P(self._dp(), *([None] * extra_dims))

    def activation_spec(self) -> P:
        """(B, S, d) activations."""
        return self.token_spec(extra_dims=2)

    def cache_specs(self, caches, batch: int) -> dict:
        """Decode caches. batch ≥ fsdp → shard the batch dims; batch == 1
        (long context) → shard the page/state dims over data (context
        parallelism).  ``caches``: the port's ({"kv": [PagedKV], "ssm":
        [SSMState]}), of tensors or of anything with a ``shape``."""
        dp = self._dp()

        def spec(name, ndim):
            # the reference's rule on its (L, …) leaves: k_pages/v_pages
            # (L, P, page, kvh, hd); page_table (L, B, pps); lengths (L,
            # B); ssm conv (L, B, k, C), h (L, B, di, N)
            if name in ("k_pages", "v_pages"):
                if batch == 1:
                    return P(None, dp, None, None, None)
                return P(*([None] * (ndim - 4)), dp, None, None, None)
            if name == "page_table":
                if batch == 1:
                    return P(*([None] * ndim))
                return P(*([None] * (ndim - 2)), dp, None)
            if name == "lengths":
                if batch == 1:
                    return P(*([None] * ndim))
                return P(*([None] * (ndim - 1)), dp)
            if name == "h":
                if batch == 1:
                    return P(*([None] * (ndim - 2)), "model", None)
                return P(*([None] * (ndim - 3)), dp, None, None)
            if name == "conv":
                if batch == 1:
                    return P(*([None] * (ndim - 1)), "model")
                return P(*([None] * (ndim - 3)), dp, None, None)
            return P()
        return _map_with_path(
            lambda path, leaf: _drop(spec(path[-1], len(leaf.shape) + 1), 1),
            caches)

    def describe(self) -> str:
        lines = [f"mesh={dict(self.shape)} tp={self.tp} "
                 f"fsdp={self.fsdp} axes={self.fsdp_axes}"]
        if self.fallbacks:
            lines.append("sharding fallbacks (replicated dims):")
            lines += [f"  - {f}" for f in sorted(set(self.fallbacks))]
        else:
            lines.append("no sharding fallbacks")
        return "\n".join(lines)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples, in
    the tree's own structure (a path names keys, fields and indices)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if T._is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def placements(mesh, spec: P) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh dim
    in the mesh's order: ``Shard(d)`` where dim d's entry names that axis
    (a tuple shards d over each of its axes, major first, as the
    reference's flattened axis), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    on = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            on[a] = d
    return tuple(Shard(on[a]) if a in on else Replicate()
                 for a in mesh_axes(mesh))


def named(mesh, spec_tree):
    """A tree of specs → the same tree of placement tuples on ``mesh``."""
    def walk(t):
        if isinstance(t, PartitionSpec):
            return placements(mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if T._is_namedtuple(t):
            return type(t)(*(walk(v) for v in t))
        return type(t)(walk(v) for v in t)
    return walk(spec_tree)


# ------------------------------------------------- params as shards

class _Shape:
    """A mesh's shape alone, as ``mesh_axes`` reads a stand-in."""

    def __init__(self, shape: Tuple[Tuple[str, int], ...]):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def _specs(cfg: ModelConfig, shape: Tuple[Tuple[str, int], ...]) -> dict:
    from ..models import lm
    return ShardingRules(cfg, _Shape(shape)).param_specs(
        lm.init_params(cfg, 0, device="meta"))


def config_specs(cfg: ModelConfig, mesh) -> dict:
    """``ShardingRules(cfg, mesh).param_specs`` of ``cfg``'s params, their
    shapes taken on the meta device (nothing allocated); computed once a
    config and mesh shape (callers share the tree: read it only)."""
    return _specs(cfg, tuple(mesh_axes(mesh).items()))


def model_dim(cfg: ModelConfig, mesh, leaf: str) -> Optional[int]:
    """The dim of a block's or the embedding's leaf (``"attn/wq"``,
    ``"mlp/down"``, ``"moe/up"``, ``"mamba/in_proj"``, ``"embed/table"``,
    ``"embed/head"``) that ``param_specs`` splits over ``model`` once
    ``_axis_for``'s fallbacks are taken, with the stack dims dropped; None
    where the spec replicates it over ``model`` or the config has no such
    leaf.  The tensor-parallel layers (serving and training) ask this,
    never the config, so their compute is split exactly where the weight
    is."""
    return _model_dims(cfg, tuple(mesh_axes(mesh).items())).get(leaf)


@functools.lru_cache(maxsize=None)
def _model_dims(cfg: ModelConfig, shape: Tuple[Tuple[str, int], ...]
                ) -> Dict[str, Optional[int]]:
    specs = _specs(cfg, shape)
    out: Dict[str, Optional[int]] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = next(
                    (d for d, e in enumerate(v)
                     if "model" in SH._entry_axes(e)), None)
    # the first block's leaves ("attn/…", "mlp/…", "moe/…", or a mamba
    # block's "mamba/…") and the hybrid's shared transformer block's
    for tree in specs["blocks"][:1] + [specs.get("shared", {})]:
        walk(tree, "")
    walk(specs["embed"], "embed/")
    return out


def shard_params(params, specs, mesh):
    """This rank's shard of every leaf of a whole tree under its spec (a
    copy, so the whole tree can be freed): the placements of
    ``named(mesh, specs)``.  ``specs`` mirrors ``params``' structure above
    its leaves."""
    return T.tree_map(lambda x, spec: SH.shard_param(x, spec, mesh).clone(),
                      params, specs)


@torch.no_grad()
def gather_params(shards, specs, mesh):
    """The whole tree from this rank's shards: the inverse of
    ``shard_params`` (collective: every rank of the mesh calls it)."""
    return T.tree_map(lambda x, spec: SH.gather_param(x, spec, mesh), shards,
                      specs)


class Placement:
    """Where one logical leaf lives on a mesh: its ``spec`` on ``mesh``.
    Called on the whole leaf it gives this rank's block (what the
    reference's ``jax.device_put(arr, sharding)`` places here);
    ``gather`` rebuilds the whole leaf from the blocks (collective)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __call__(self, whole):
        return SH.shard_param(whole, self.spec, self.mesh)

    @torch.no_grad()
    def gather(self, shard):
        return SH.gather_param(shard, self.spec, self.mesh)


def shardings(mesh, spec_tree):
    """A tree of specs → the same tree of ``Placement``s on ``mesh`` (the
    port's counterpart of ``named`` for a checkpoint's restore)."""
    def walk(t):
        if isinstance(t, PartitionSpec):
            return Placement(mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if T._is_namedtuple(t):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(spec_tree)
