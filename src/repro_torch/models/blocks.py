"""The transformer and mamba blocks, for prefill and for one decode step.

Port of ``repro/models/blocks.py``: the transformer block (pre-norm
attention and an MLP, or the MoE layer when ``cfg.is_moe``, each followed
by gemma2's post-norm when ``cfg.post_norm``) and the mamba block
(pre-norm mamba1 or mamba2 by ``version``, residual).  zamba2's shared
block is a transformer block with one weight set and a KV cache for each
place it runs (``lm.py``).  ``mesh``: the MoE layer's roomy dispatch and
the decode attention's sharded branches (``moe.py``, ``attention.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import paged
from .attention import attention, decode_attention, init_attention
from .config import ModelConfig
from .layers import init_mlp, mlp, rms_norm
from .moe import init_moe, moe
from .ssm import (SSMState, init_mamba1, init_mamba2, mamba1, mamba1_decode,
                  mamba1_prefill, mamba2, mamba2_decode, mamba2_prefill)


def init_transformer_block(gen: torch.Generator, cfg: ModelConfig, *,
                           device, dtype) -> dict:
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)  # noqa: E731
    p = {"ln1": zeros(), "ln2": zeros(),
         "attn": init_attention(gen, cfg, device=device, dtype=dtype)}
    if cfg.is_moe:
        p["moe"] = init_moe(gen, cfg, device=device, dtype=dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg, device=device, dtype=dtype)
    if cfg.post_norm:
        p["post_ln1"] = zeros()
        p["post_ln2"] = zeros()
    return p


def _mlp_half(p: dict, x: torch.Tensor, cfg: ModelConfig,
              mesh=None) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    h = moe(p["moe"], h, cfg, mesh) if cfg.is_moe else mlp(p["mlp"], h, cfg)
    if cfg.post_norm:
        h = rms_norm(h, p["post_ln2"], cfg.rms_eps)
    return x + h


def transformer_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, *, window: Optional[int] = None,
                      return_kv: bool = False, mesh=None):
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    h, kv = attention(p["attn"], h, positions, cfg, window=window,
                      return_kv=True)
    if cfg.post_norm:
        h = rms_norm(h, p["post_ln1"], cfg.rms_eps)
    x = _mlp_half(p, x + h, cfg, mesh)
    return (x, kv) if return_kv else x


def transformer_block_decode(p: dict, x: torch.Tensor, cache: paged.PagedKV,
                             cfg: ModelConfig, *,
                             window: Optional[int] = None,
                             donate: bool = False, mesh=None
                             ) -> Tuple[torch.Tensor, paged.PagedKV]:
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    h, cache = decode_attention(p["attn"], h, cache, cfg, window=window,
                                donate=donate, mesh=mesh)
    if cfg.post_norm:
        h = rms_norm(h, p["post_ln1"], cfg.rms_eps)
    return _mlp_half(p, x + h, cfg, mesh), cache


# ------------------------------------------------------- mamba blocks

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, *, device,
                     dtype, version: int = 1) -> dict:
    init = init_mamba1 if version == 1 else init_mamba2
    return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mamba": init(gen, cfg, device=device, dtype=dtype)}


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                version: int = 1) -> torch.Tensor:
    fn = mamba1 if version == 1 else mamba2
    return x + fn(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps), cfg)


def mamba_block_decode(p: dict, x: torch.Tensor, state: SSMState,
                       cfg: ModelConfig, version: int = 1
                       ) -> Tuple[torch.Tensor, SSMState]:
    fn = mamba1_decode if version == 1 else mamba2_decode
    h, state = fn(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps), state, cfg)
    return x + h, state


def mamba_block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        version: int = 1) -> Tuple[torch.Tensor, SSMState]:
    fn = mamba1_prefill if version == 1 else mamba2_prefill
    h, state = fn(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps), cfg)
    return x + h, state
