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
    → the port's params: the same dicts, ``blocks`` as a list of L."""
    conv = lambda a: array_to_torch(a, device)  # noqa: E731
    return {"embed": T.tree_map(conv, params["embed"]),
            "final_norm": conv(params["final_norm"]),
            "blocks": [T.tree_map(lambda a: conv(_layer(a, i, cfg)),
                                  params["blocks"])
                       for i in range(cfg.n_layers)]}


def opt_state_from_jax(state, cfg, device=None):
    """The reference's ``AdamWState`` (step, m, v over its stacked params)
    → the port's ``optim.AdamWState``: step as an int, m and v as
    ``lm_params_from_jax`` lays out params."""
    return AdamWState(step=int(np.asarray(state.step)),
                      m=lm_params_from_jax(state.m, cfg, device),
                      v=lm_params_from_jax(state.v, cfg, device))


def lm_caches_from_jax(caches, cfg, device=None) -> dict:
    """The reference's decode caches ({"kv": PagedKV with stacked
    leaves}) → the port's ({"kv": [PagedKV] * L})."""
    kv = caches["kv"]
    return {"kv": [paged.PagedKV(*(array_to_torch(
        _layer(getattr(kv, f), i, cfg), device) for f in paged.PagedKV._fields))
        for i in range(cfg.n_layers)]}
