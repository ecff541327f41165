"""State-space blocks: mamba1 (falcon-mamba) and mamba2 (zamba2's
backbone), each with a forward, a prefill and one decode step.

Port of ``repro/models/ssm.py``.  mamba1's forward and prefill run the
selective scan through ``kernels.ops.mamba_scan`` (K9 on the card), the
prefill with ``return_state=True`` for the decode state.  mamba2 has a
scalar decay a head; by default (``mamba2_use_ssd``) it runs the chunked
matmul form ``kernels.ref.mamba2_ssd``, model math with no kernel behind
it; with ``mamba2_use_ssd=False`` it broadcasts the head scalars into K9's
(d_inner, N) form and runs K9, and its prefill takes K9 with its last
state, as mamba1's does (where the reference's prefill runs the plain
sequential scan).  The decode steps are plain PyTorch, as in the
reference.

Decode keeps O(1) state per layer, ``SSMState``: the last conv-1 inputs of
the depthwise causal convolution (d_inner channels for mamba1, d_inner +
2N for mamba2, whose conv also runs over B and C) and the (d_inner, N)
float32 scan state.

Init draws the reference's distributions on a ``torch.Generator``; the two
packages draw different numbers from one seed, so the tests carry the
reference's params across with ``convert.lm_params_from_jax``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ref as kref
from .config import ModelConfig
from .layers import cdtype, dense_init, rms_norm


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, conv-1, conv channels) in the compute dtype
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


# ------------------------------------------------------------- mamba2

def init_mamba2(gen: torch.Generator, cfg: ModelConfig, *, device,
                dtype) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    heads = di // cfg.mamba2_head_dim
    conv_ch = di + 2 * n
    kw = dict(device=device, dtype=dtype)
    in_proj = dense_init(gen, (d, 2 * di + 2 * n + heads), **kw)
    conv_w = torch.empty((cfg.ssm_conv, conv_ch), dtype=torch.float32,
                         device=device)
    conv_w.normal_(0.0, 1.0, generator=gen)
    a_log = torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32,
                                     device=device))
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), **kw),
        "dt_bias": torch.full((heads,), -4.6, **kw),
        "a_log": a_log.to(dtype),
        "d_skip": torch.ones((heads,), **kw),
        "norm": torch.zeros((di,), **kw),
        "out_proj": dense_init(gen, (di, d), **kw),
    }


def _mamba2_split(xz: torch.Tensor, cfg: ModelConfig):
    """in_proj's output → (z, x, B, C, dt) (``repro/models/ssm.py:124-127``)."""
    di, n = cfg.d_inner, cfg.ssm_state
    return xz.split([di, di, n, n, di // cfg.mamba2_head_dim], dim=-1)


def _heads_to_channels(p: dict, dt: torch.Tensor, cfg: ModelConfig):
    """mamba2's head scalars broadcast into K9's form: dt (..., H) →
    (..., d_inner), a → (d_inner, N), d → (d_inner,)
    (``repro/models/ssm.py:150-157``)."""
    hd, n = cfg.mamba2_head_dim, cfg.ssm_state
    a = -torch.exp(p["a_log"].float().repeat_interleave(hd))
    return (dt.repeat_interleave(hd, dim=-1),
            a[:, None].expand(cfg.d_inner, n),
            p["d_skip"].repeat_interleave(hd))


def _mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig,
            return_state: bool):
    """The mamba2 forward; with ``return_state`` also the prefill's state
    (the conv's last inputs, the scan's final state)."""
    dt_c = cdtype(cfg)
    bsz, seq, _ = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.mamba2_head_dim
    z, x_in, b_mat, c_mat, dt_h = _mamba2_split(x @ p["in_proj"].to(dt_c),
                                                cfg)
    conv_in = torch.cat([x_in, b_mat, c_mat], dim=-1)
    conv = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    x_c, b_mat, c_mat = conv.split([di, n, n], dim=-1)
    dt = F.softplus(dt_h + p["dt_bias"].to(dt_c))            # (B, S, H)
    h_last = None
    if cfg.mamba2_use_ssd:
        y4, h4 = kref.mamba2_ssd(
            x_c.reshape(bsz, seq, di // hd, hd), dt,
            -torch.exp(p["a_log"].float()), b_mat, c_mat, p["d_skip"],
            chunk=cfg.ssd_chunk)
        y = y4.reshape(bsz, seq, di).to(dt_c)
        h_last = h4.reshape(bsz, di, n)
    else:
        dt_full, a_full, d_full = _heads_to_channels(p, dt, cfg)
        out = kops.mamba_scan(x_c, dt_full, a_full, b_mat, c_mat, d_full,
                              impl=cfg.kernels, return_state=return_state)
        y, h_last = out if return_state else (out, None)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.rms_eps)
    out = y @ p["out_proj"].to(dt_c)
    if not return_state:
        return out
    return out, SSMState(conv=_conv_tail(conv_in, cfg.ssm_conv), h=h_last)


def mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d) → (B, S, d): SSD, or K9 when ``mamba2_use_ssd`` is off."""
    return _mamba2(p, x, cfg, return_state=False)


def mamba2_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, SSMState]:
    """The forward that also returns the decode state: SSD's final state,
    or K9's with its last state."""
    return _mamba2(p, x, cfg, return_state=True)


def mamba2_decode(p: dict, x: torch.Tensor, state: SSMState,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d) → (out (B, 1, d), the next state).  Plain PyTorch, in
    float32 from the conv on, as ``repro/models/ssm.py:162-188``; the decay
    exp(dt·a) is taken once a channel (it is one value across the N
    states)."""
    dt_c = cdtype(cfg)
    di, n = cfg.d_inner, cfg.ssm_state
    z, x_in, b_mat, c_mat, dt_h = _mamba2_split(
        x[:, 0] @ p["in_proj"].to(dt_c), cfg)
    conv_in = torch.cat([x_in, b_mat, c_mat], dim=-1)        # (B, conv_ch)
    window = torch.cat([state.conv, conv_in[:, None]], dim=1)
    conv = (window.float() * p["conv_w"].float()).sum(1) \
        + p["conv_b"].float()
    x_c, b_mat, c_mat = F.silu(conv).to(dt_c).split([di, n, n], dim=-1)
    dt = F.softplus(dt_h + p["dt_bias"].to(dt_c))            # (B, H)
    dt_full, a_full, d_full = _heads_to_channels(p, dt, cfg)
    dtf, xf = dt_full.float(), x_c.float()
    h = state.h * torch.exp(dtf[..., None] * a_full[:, :1]) \
        + (dtf * xf)[..., None] * b_mat.float()[:, None, :]
    y = (h * c_mat.float()[:, None, :]).sum(-1) + xf * d_full.float()
    y = rms_norm(y.to(dt_c) * F.silu(z), p["norm"], cfg.rms_eps)
    out = y @ p["out_proj"].to(dt_c)
    return out[:, None], SSMState(conv=window[:, 1:], h=h)


def _conv_tail(x_in: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 conv inputs (zero-padded on the left for short seqs),
    as a tensor of its own: a view would keep the whole projection alive
    in the cache."""
    s = x_in.shape[1]
    if s >= k - 1:
        return x_in[:, s - (k - 1):].clone()
    return F.pad(x_in, (0, 0, (k - 1) - s, 0))


def init_ssm_state(cfg: ModelConfig, batch: int, device,
                   version: int = 1) -> SSMState:
    di, n = cfg.d_inner, cfg.ssm_state
    conv_ch = di if version == 1 else di + 2 * n
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=cdtype(cfg), device=device),
        h=torch.zeros((batch, di, n), dtype=torch.float32, device=device))
