"""Carry state between the JAX package and the port, through numpy.

The JAX package keeps packed 2-bit words as uint32 arrays and ranks as
rows of uint32 words (word 0 high); the port keeps words as int32 tensors
with the same bits and ranks as int64.  LM params and caches are stacked
over layers in the reference ((L, …), or (L/2, 2, …) local/global pairs
for gemma2) and kept as one entry per layer in the port; so are AdamW's
moments, which mirror the params.  These functions
move state across, so the two packages can start from identical state.
They take array-likes (numpy arrays, or anything ``np.asarray`` accepts,
such as a JAX array) and import nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from . import tree as T
from .core import bitarray as BA
from .core import paged
from .core import ranking as R
from .core import rlist as RL
from .core import rset as RS
from .models.ssm import SSMState
from .optim import AdamWState


def words_to_torch(words, device=None) -> torch.Tensor:
    """(W,) uint32 packed words → (W,) int32 tensor with the same bits."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(w.view(np.int32).copy()).to(
        _device.resolve(device))


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """(W,) int32 tensor → (W,) uint32 numpy words with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32).copy()


def bitarray_from_jax(jax_bitarray, device=None) -> BA.RoomyBitArray:
    """A JAX ``RoomyBitArray``'s packed ``data`` as the port's array."""
    return BA.RoomyBitArray(words_to_torch(jax_bitarray.data, device))


def ranks_from_rows(rows, device=None) -> torch.Tensor:
    """(m, 1|2) uint32 rank rows (word 0 high) → (m,) int64 ranks."""
    rows = np.ascontiguousarray(np.asarray(rows, dtype=np.uint32))
    return R.rows_to_ranks(torch.from_numpy(rows.view(np.int32).copy())).to(
        _device.resolve(device))


def ranks_to_numpy(ranks: torch.Tensor) -> np.ndarray:
    """(m,) int64 ranks → (m,) uint64 numpy ranks (the numpy tier's type)."""
    return ranks.detach().cpu().numpy().astype(np.uint64)


def _count(count, dev) -> torch.Tensor:
    return torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=dev)


def rlist_from_jax(rl, device=None) -> RL.RoomyList:
    """A JAX ``RoomyList`` (uint32 data, int32 count) as the port's: every
    row's bits, those past ``count`` too, and a 0-d int32 count."""
    data = RL.as_rows(np.asarray(rl.data), device)
    return RL.RoomyList(data, _count(rl.count, data.device))


def rset_from_jax(s, device=None) -> RS.RoomySet:
    """A JAX ``RoomySet`` as the port's, as ``rlist_from_jax``."""
    return RS.RoomySet(*rlist_from_jax(s, device))


# ------------------------------------------------------------ LM state

def array_to_torch(a, device=None) -> torch.Tensor:
    """An array-like of a numpy dtype → a tensor of the same dtype."""
    return torch.from_numpy(np.array(a)).to(_device.resolve(device))


def _layer(stacked, i: int, cfg):
    """Layer i of a reference-stacked leaf: a[i//2, i%2] for gemma2's
    (L/2, 2, …) pairs (local first), a[i] otherwise."""
    a = np.asarray(stacked)
    return a[i // 2, i % 2] if cfg.local_global_pattern else a[i]


def lm_params_from_jax(params, cfg, device=None) -> dict:
    """The reference's ``lm.init_params`` pytree (dicts of array-likes)
    → the port's params: the same dicts, ``blocks`` as a list of L (each
    with its ``moe`` subtree for the MoE family, its mamba2 leaves for the
    hybrid), and the hybrid's one ``shared`` block as it is.  Every family
    of the reference crosses: the frontend stubs' blocks are dense ones
    (musicgen's MLP non-gated GELU), their table the tied LM head."""
    conv = lambda a: array_to_torch(a, device)  # noqa: E731
    out = {"embed": T.tree_map(conv, params["embed"]),
           "final_norm": conv(params["final_norm"]),
           "blocks": [T.tree_map(lambda a: conv(_layer(a, i, cfg)),
                                 params["blocks"])
                      for i in range(cfg.n_layers)]}
    if "shared" in params:
        out["shared"] = T.tree_map(conv, params["shared"])
    return out


def opt_state_from_jax(state, cfg, device=None):
    """The reference's ``AdamWState`` (step, m, v over its stacked params)
    → the port's ``optim.AdamWState``: step as an int, m and v as
    ``lm_params_from_jax`` lays out params."""
    return AdamWState(step=int(np.asarray(state.step)),
                      m=lm_params_from_jax(state.m, cfg, device),
                      v=lm_params_from_jax(state.v, cfg, device))


def lm_params_shard_from_jax(params, cfg, mesh, specs=None,
                             device=None) -> dict:
    """This rank's shards of the reference's params under ``specs``
    (default: ``ShardingRules(cfg, mesh).param_specs``): what a train step
    on ``mesh`` holds (``lm_params_from_jax`` then ``shard_params``)."""
    from .distributed.sharding_rules import config_specs, shard_params
    specs = config_specs(cfg, mesh) if specs is None else specs
    return shard_params(lm_params_from_jax(params, cfg, device), specs, mesh)


def opt_state_shard_from_jax(state, cfg, mesh, specs=None, device=None):
    """This rank's shards of the reference's ``AdamWState``: its m and v
    as ``lm_params_shard_from_jax`` cuts params."""
    return AdamWState(
        step=int(np.asarray(state.step)),
        m=lm_params_shard_from_jax(state.m, cfg, mesh, specs, device),
        v=lm_params_shard_from_jax(state.v, cfg, mesh, specs, device))


def lm_caches_from_jax(caches, cfg, device=None) -> dict:
    """The reference's decode caches ({"kv": PagedKV with stacked
    leaves}, {"ssm": SSMState with (L, …) leaves}, or the hybrid's both,
    its kv stacked over the shared block's applications) → the port's
    ({"kv": [PagedKV] * L}, {"ssm": [SSMState] * L}, or both, with a
    ``PagedKV`` per application)."""
    out = {}
    if "ssm" in caches:
        st = caches["ssm"]
        out["ssm"] = [SSMState(*(array_to_torch(np.asarray(leaf)[i], device)
                                 for leaf in (st.conv, st.h)))
                      for i in range(cfg.n_layers)]
    if "kv" in caches:
        kv = caches["kv"]
        n = np.asarray(kv.lengths).shape[0] * (
            2 if cfg.local_global_pattern else 1)
        out["kv"] = [paged.PagedKV(*(array_to_torch(
            _layer(getattr(kv, f), i, cfg), device)
            for f in paged.PagedKV._fields)) for i in range(n)]
    return out


def lm_caches_shard_from_jax(caches, cfg, coord: int, n: int,
                             device=None) -> dict:
    """The reference's global decode caches → data rank ``coord``'s shard
    of them over ``n`` data ranks, as ``ShardingRules.cache_specs`` lays
    the pages out and the port's decode on a mesh reads them: each
    ``PagedKV`` cut by ``paged.shard`` (rows and their pages, or pages
    alone at batch 1), the SSM states the rank's rows where the batch
    tiles the ranks, else whole (``lm.make_cache``)."""
    whole = lm_caches_from_jax(caches, cfg, device)
    out = dict(whole)
    if "kv" in whole:
        out["kv"] = [paged.PagedKV(*(t.clone() for t in paged.shard(
            c, coord, n))) for c in whole["kv"]]
    if "ssm" in whole:
        b = whole["ssm"][0].h.shape[0]
        if b % n == 0:
            per = b // n
            out["ssm"] = [SSMState(*(t[coord * per:(coord + 1) * per].clone()
                                     for t in st)) for st in whole["ssm"]]
    return out


def lm_caches_unshard(shards, batch: int) -> dict:
    """Every data rank's caches (in coordinate order) → the whole caches
    of ``batch`` sequences: the pages (and rows) joined, the SSM states
    joined where each rank held its rows, else rank 0's."""
    out = dict(shards[0])
    if "kv" in out:
        out["kv"] = [paged.unshard([s["kv"][i] for s in shards], batch)
                     for i in range(len(out["kv"]))]
    if "ssm" in out and out["ssm"][0].h.shape[0] != batch:
        out["ssm"] = [SSMState(*(torch.cat([s["ssm"][i][f] for s in shards])
                                 for f in range(2)))
                      for i in range(len(out["ssm"]))]
    return out
