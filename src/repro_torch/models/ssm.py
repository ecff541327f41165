"""The mamba1 block of falcon-mamba: forward, prefill and one decode step.

Port of the mamba1 half of ``repro/models/ssm.py``; mamba2 comes with the
hybrid slice (ROADMAP item 9.5).  The full-sequence forward and the
prefill run the selective scan through ``kernels.ops.mamba_scan`` (K9 on
the card), the prefill with ``return_state=True`` for the decode state;
the decode step is plain PyTorch, as in the reference.

Decode keeps O(1) state per layer, ``SSMState``: the last conv-1 inputs of
the depthwise causal convolution and the (d_inner, N) float32 scan state.

Init draws the reference's distributions on a ``torch.Generator``; the two
packages draw different numbers from one seed, so the tests carry the
reference's params across with ``convert.lm_params_from_jax``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import cdtype, dense_init


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, conv-1, d_inner) in the compute dtype
    h: torch.Tensor       # (B, d_inner, N) float32


def init_mamba1(gen: torch.Generator, cfg: ModelConfig, *, device,
                dtype) -> dict:
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    kw = dict(device=device, dtype=dtype)
    in_proj = dense_init(gen, (d, 2 * di), **kw)
    conv_w = torch.empty((cfg.ssm_conv, di), dtype=torch.float32,
                         device=device)
    conv_w.normal_(0.0, 1.0, generator=gen)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).repeat(di, 1)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": dense_init(gen, (di, dtr + 2 * n), **kw),
        "dt_proj": dense_init(gen, (dtr, di), **kw),
        "dt_bias": torch.full((di,), -4.6, **kw),   # softplus ≈ 0.01
        "a_log": a_log.to(dtype),
        "d_skip": torch.ones((di,), **kw),
        "out_proj": dense_init(gen, (di, d), **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq (``repro/models/ssm.py:47-56``).
    x: (B, S, C); w: (K, C) → (B, S, C) in x.dtype.  Written as K shifted
    multiply-adds in float32 (w cast to x's dtype first, as the reference
    casts it), rounded to x's dtype, plus b in x's dtype: no convolution
    library call, so no TF32 on the card."""
    k = w.shape[0]
    wx = w.to(x.dtype).float()
    xp = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = xp[:, :s].float() * wx[0]
    for j in range(1, k):
        out += xp[:, j:j + s] * wx[j]
    return out.to(x.dtype) + b.to(x.dtype)


def _projections(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The mamba1 block's input side: (x_in, z, and the scan's inputs
    x_c, dt, a, b, c).  b and c are column slices of one projection."""
    dt_c = cdtype(cfg)
    di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    x_in, z = (x @ p["in_proj"].to(dt_c)).split(di, dim=-1)
    x_c = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt_in, b_mat, c_mat = (x_c @ p["x_proj"].to(dt_c)).split(
        [dtr, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(dt_c) + p["dt_bias"].to(dt_c))
    a = -torch.exp(p["a_log"].float())
    return x_in, z, (x_c, dt, a, b_mat, c_mat)


def mamba1(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d) → (B, S, d): the full-sequence forward over K9."""
    _, z, scan_in = _projections(p, x, cfg)
    y = kops.mamba_scan(*scan_in, p["d_skip"], impl=cfg.kernels)
    return (y * F.silu(z)) @ p["out_proj"].to(cdtype(cfg))


def mamba1_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, SSMState]:
    """The full-sequence forward that also returns the decode state: K9
    with its final state, and the conv's last inputs."""
    x_in, z, scan_in = _projections(p, x, cfg)
    y, h_last = kops.mamba_scan(*scan_in, p["d_skip"], impl=cfg.kernels,
                                return_state=True)
    out = (y * F.silu(z)) @ p["out_proj"].to(cdtype(cfg))
    return out, SSMState(conv=_conv_tail(x_in, cfg.ssm_conv), h=h_last)


def mamba1_decode(p: dict, x: torch.Tensor, state: SSMState,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d) → (out (B, 1, d), the next state).  Plain PyTorch, in
    float32 from the conv on, as ``repro/models/ssm.py:77-103``."""
    dt_c = cdtype(cfg)
    di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    x_in, z = (x[:, 0] @ p["in_proj"].to(dt_c)).split(di, dim=-1)
    window = torch.cat([state.conv, x_in[:, None]], dim=1)     # (B, K, di)
    conv = (window.float() * p["conv_w"].float()).sum(1) \
        + p["conv_b"].float()
    x_c = F.silu(conv).to(dt_c)
    dt_in, b_mat, c_mat = (x_c @ p["x_proj"].to(dt_c)).split(
        [dtr, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(dt_c) + p["dt_bias"].to(dt_c))
    a = -torch.exp(p["a_log"].float())                         # (di, n)
    dtf, xf = dt.float(), x_c.float()
    h = state.h * torch.exp(dtf[..., None] * a) \
        + (dtf * xf)[..., None] * b_mat.float()[:, None, :]
    y = (h * c_mat.float()[:, None, :]).sum(-1) + xf * p["d_skip"].float()
    out = (y.to(dt_c) * F.silu(z)) @ p["out_proj"].to(dt_c)
    return out[:, None], SSMState(conv=window[:, 1:], h=h)


def _conv_tail(x_in: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 conv inputs (zero-padded on the left for short seqs),
    as a tensor of its own: a view would keep the whole projection alive
    in the cache."""
    s = x_in.shape[1]
    if s >= k - 1:
        return x_in[:, s - (k - 1):].clone()
    return F.pad(x_in, (0, 0, (k - 1) - s, 0))


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> SSMState:
    di, n = cfg.d_inner, cfg.ssm_state
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=cdtype(cfg),
                         device=device),
        h=torch.zeros((batch, di, n), dtype=torch.float32, device=device))
