"""The transformer and mamba1 blocks, for prefill and for one decode step.

Port of ``repro/models/blocks.py``: the transformer block (pre-norm
attention and MLP, each followed by gemma2's post-norm when
``cfg.post_norm``) and the mamba1 block (pre-norm mamba1, residual).  The
mamba2 and MoE blocks come with their slices (ROADMAP items 9.4, 9.5).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import paged
from .attention import attention, decode_attention, init_attention
from .config import ModelConfig
from .layers import init_mlp, mlp, rms_norm
from .ssm import SSMState, init_mamba1, mamba1, mamba1_decode, mamba1_prefill


def init_transformer_block(gen: torch.Generator, cfg: ModelConfig, *,
                           device, dtype) -> dict:
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)  # noqa: E731
    p = {"ln1": zeros(), "ln2": zeros(),
         "attn": init_attention(gen, cfg, device=device, dtype=dtype),
         "mlp": init_mlp(gen, cfg, device=device, dtype=dtype)}
    if cfg.post_norm:
        p["post_ln1"] = zeros()
        p["post_ln2"] = zeros()
    return p


def _mlp_half(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.rms_eps), cfg)
    if cfg.post_norm:
        h = rms_norm(h, p["post_ln2"], cfg.rms_eps)
    return x + h


def transformer_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, *, window: Optional[int] = None,
                      return_kv: bool = False):
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    h, kv = attention(p["attn"], h, positions, cfg, window=window,
                      return_kv=True)
    if cfg.post_norm:
        h = rms_norm(h, p["post_ln1"], cfg.rms_eps)
    x = _mlp_half(p, x + h, cfg)
    return (x, kv) if return_kv else x


def transformer_block_decode(p: dict, x: torch.Tensor, cache: paged.PagedKV,
                             cfg: ModelConfig, *,
                             window: Optional[int] = None,
                             donate: bool = False
                             ) -> Tuple[torch.Tensor, paged.PagedKV]:
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    h, cache = decode_attention(p["attn"], h, cache, cfg, window=window,
                                donate=donate)
    if cfg.post_norm:
        h = rms_norm(h, p["post_ln1"], cfg.rms_eps)
    return _mlp_half(p, x + h, cfg), cache


# ------------------------------------------------------ mamba1 block

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, *, device,
                     dtype) -> dict:
    return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mamba": init_mamba1(gen, cfg, device=device, dtype=dtype)}


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + mamba1(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps), cfg)


def mamba_block_decode(p: dict, x: torch.Tensor, state: SSMState,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    h, state = mamba1_decode(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps),
                             state, cfg)
    return x + h, state


def mamba_block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, SSMState]:
    h, state = mamba1_prefill(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps),
                              cfg)
    return x + h, state
