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

On a mesh whose layers hold model shards (serving and training,
``core/sharding.py``) a mixer splits over ``model`` by ``d_inner``
channels, as the reference's rules split its weights (``tp_di`` /
``tp_conv``, ``distributed/sharding_rules.py``): model rank r computes the
channels [r·di/tp, (r+1)·di/tp) (``MixerSplit``).  The rules cut a
concatenated dim contiguously, which does not line up with the channels
(mamba1's ``in_proj`` is [x | z]: its first model ranks hold all of x;
mamba2's is [z | x | B | C | dt] and its conv spans [x | B | C]), so the
mixer regroups those leaves' columns at use by one all-to-all over
``model`` (``core.sharding.take_columns``, backward the reverse
all-to-all) and keeps the stored shards in the reference's layout; a leaf
the rules replicate (``dt_bias``, mamba2's ``a_log`` and ``norm``) is cut
to the rank's channels.

* **mamba1**: the conv and ``dt_proj`` on the rank's channels; ``x_proj``
  row-parallel, its (…, dt_rank + 2N) output all-reduced over ``model``
  (B and C are shared by every channel); K9 on the rank's di/tp channels
  (K9-bwd under a gradient); ``out_proj`` row-parallel, then the
  all-reduce; the decode step's plain update on the rank's channels.
* **mamba2**: the rank's heads and their channels; B, C and their conv
  channels computed on every rank of the group; the SSD form on the
  rank's heads; the gated RMSNorm over ``d_inner``, its sum of squares
  all-reduced over ``model``; ``out_proj`` row-parallel.

``SSMState`` on such a mesh holds the rank's channels: ``h`` (B, di/tp,
N), ``conv`` (B, conv-1, di/tp) for mamba1 and (B, conv-1, di/tp + 2N)
for mamba2 ([its x channels | B | C]).  Where ``d_inner`` (or mamba2's
heads) does not divide ``model``, the mixer runs every channel on each
rank, its leaves gathered over ``model`` where the rules split them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import sharding as SH
from ..kernels import ops as kops
from ..kernels import ref as kref
from .config import ModelConfig
from .layers import cdtype, dense_init, rms_norm, tp_dim


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, conv-1, conv channels) in the compute dtype
    h: torch.Tensor       # (B, d_inner, N) float32 (a rank's channels)


# ------------------------------------------------- the split over model

class MixerSplit(NamedTuple):
    """Model rank ``m`` of ``tp``'s share of a mixer: the channels [m·di/tp,
    (m+1)·di/tp) (mamba2: the heads [m·H/tp, (m+1)·H/tp) and theirs)."""
    mesh: object
    m: int
    tp: int


def mixer_split(cfg: ModelConfig, mesh, version: int
                ) -> Optional[MixerSplit]:
    """This rank's ``MixerSplit`` where the layers hold model shards and
    the rules split ``out_proj`` over ``model`` (d_inner divides it; for
    mamba2 its heads must divide it too), else None: every channel."""
    if tp_dim(cfg, mesh, "mamba/out_proj") != 0:
        return None
    tp = SH.axis_size(mesh, "model")
    if version == 2 and (cfg.d_inner // cfg.mamba2_head_dim) % tp:
        return None
    return MixerSplit(mesh, SH.axis_index(mesh, "model"), tp)


def mixer_channels(cfg: ModelConfig, mesh, version: int) -> int:
    """The d_inner channels a rank's mixer computes and its state holds."""
    sp = mixer_split(cfg, mesh, version)
    return cfg.d_inner if sp is None else cfg.d_inner // sp.tp


def _layout(cfg: ModelConfig, version: int) -> dict:
    """Each leaf's channel dim and its blocks along it, (size, split): a
    rank takes its share of a split block (channels, or mamba2's heads)
    and all of another (mamba2's B and C, which every channel reads)."""
    di, n = cfg.d_inner, cfg.ssm_state
    ch = ((di, True),)
    if version == 1:
        return {"in_proj": (1, ch + ch), "conv_w": (1, ch),
                "conv_b": (0, ch), "x_proj": (0, ch), "dt_proj": (1, ch),
                "dt_bias": (0, ch), "a_log": (0, ch), "d_skip": (0, ch),
                "out_proj": (0, ch)}
    heads = ((di // cfg.mamba2_head_dim, True),)
    bc = ((n, False), (n, False))
    return {"in_proj": (1, ch + ch + bc + heads), "conv_w": (1, ch + bc),
            "conv_b": (0, ch + bc), "dt_bias": (0, heads),
            "a_log": (0, heads), "d_skip": (0, heads), "norm": (0, ch),
            "out_proj": (0, ch)}


@functools.lru_cache(maxsize=None)
def _wanted(blocks: Tuple, tp: int) -> Tuple:
    """Every rank's (start, stop) ranges of a dim laid out as ``blocks``."""
    out = []
    for r in range(tp):
        ranges, at = [], 0
        for size, split in blocks:
            a, b = (at + r * size // tp, at + (r + 1) * size // tp) \
                if split else (at, at + size)
            ranges.append((a, b))
            at += size
        out.append(tuple(ranges))
    return tuple(out)


def _take(x: torch.Tensor, name: str, cfg: ModelConfig, version: int,
          sp: MixerSplit) -> torch.Tensor:
    """The rank's channels of leaf ``name``: the stored shard itself where
    it is one block split over ``model``, regrouped by ``take_columns``
    where it concatenates several, cut from the leaf where the rules
    replicate it."""
    dim, blocks = _layout(cfg, version)[name]
    want = _wanted(blocks, sp.tp)
    stored = tp_dim(cfg, sp.mesh, f"mamba/{name}")
    if name == "in_proj":             # cast at use anyway: move half the bytes
        x = x.to(cdtype(cfg))
    if stored is None:
        mine = want[sp.m]
        if len(mine) == 1:
            return x.narrow(dim, mine[0][0], mine[0][1] - mine[0][0])
        idx = [c for a, b in mine for c in range(a, b)]
        return x.index_select(dim, torch.tensor(idx, device=x.device))
    if stored != dim:
        raise ValueError(f"mamba/{name}: the rules split dim {stored} over "
                         f"model, the mixer's channels lie on dim {dim}")
    if len(blocks) == 1:
        return x
    return SH.take_columns(x, sp.mesh, "model", dim, want)


def _weights(p: dict, cfg: ModelConfig, version: int, mesh
             ) -> Tuple[dict, Optional[MixerSplit]]:
    """(the leaves the mixer computes with, its split): the rank's
    channels under a split; every channel off model shards (``p``
    itself), or, where the channels do not split, each leaf gathered over
    ``model`` where the rules split it."""
    sp = mixer_split(cfg, mesh, version)
    if sp is not None:
        return {k: _take(v, k, cfg, version, sp) for k, v in p.items()}, sp
    whole = {}
    for k, v in p.items():
        dim = tp_dim(cfg, mesh, f"mamba/{k}")
        whole[k] = v if dim is None else SH.all_gather(v, mesh, "model", dim)
    return whole, None


def _x_proj_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """mamba1's row-parallel ``x_proj`` partials joined over ``model``."""
    return SH.all_reduce(x, mesh, "model")


def _out(y: torch.Tensor, w: dict, cfg: ModelConfig,
         sp: Optional[MixerSplit]) -> torch.Tensor:
    """``out_proj``, row-parallel on the rank's channels under a split."""
    out = y @ w["out_proj"].to(cdtype(cfg))
    return out if sp is None else SH.all_reduce(out, sp.mesh, "model")


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


def _projections(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """The mamba1 block's input side: (x_in, z, the scan's inputs x_c, dt,
    a, b, c, the leaves, the split), on the rank's channels under a
    split.  b and c are column slices of one projection."""
    dt_c = cdtype(cfg)
    n, dtr = cfg.ssm_state, cfg.dt_rank
    w, sp = _weights(p, cfg, 1, mesh)
    x_in, z = (x @ w["in_proj"].to(dt_c)).chunk(2, dim=-1)
    x_c = F.silu(_causal_conv(x_in, w["conv_w"], w["conv_b"]))
    dt_in, b_mat, c_mat = _dt_b_c(x_c, w, cfg, sp).split([dtr, n, n],
                                                         dim=-1)
    dt = F.softplus(dt_in @ w["dt_proj"].to(dt_c) + w["dt_bias"].to(dt_c))
    a = -torch.exp(w["a_log"].float())
    return x_in, z, (x_c, dt, a, b_mat, c_mat), w, sp


def _dt_b_c(x_c, w: dict, cfg: ModelConfig, sp) -> torch.Tensor:
    """``x_proj``: row-parallel on the rank's channels under a split, its
    partials joined over ``model``."""
    out = x_c @ w["x_proj"].to(cdtype(cfg))
    return out if sp is None else _x_proj_sum(out, sp.mesh)


def mamba1(p: dict, x: torch.Tensor, cfg: ModelConfig,
           mesh=None) -> torch.Tensor:
    """(B, S, d) → (B, S, d): the full-sequence forward over K9."""
    _, z, scan_in, w, sp = _projections(p, x, cfg, mesh)
    y = kops.mamba_scan(*scan_in, w["d_skip"], impl=cfg.kernels)
    return _out(y * F.silu(z), w, cfg, sp)


def mamba1_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """The full-sequence forward that also returns the decode state: K9
    with its final state, and the conv's last inputs."""
    x_in, z, scan_in, w, sp = _projections(p, x, cfg, mesh)
    y, h_last = kops.mamba_scan(*scan_in, w["d_skip"], impl=cfg.kernels,
                                return_state=True)
    out = _out(y * F.silu(z), w, cfg, sp)
    return out, SSMState(conv=_conv_tail(x_in, cfg.ssm_conv), h=h_last)


def mamba1_decode(p: dict, x: torch.Tensor, state: SSMState,
                  cfg: ModelConfig, mesh=None
                  ) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d) → (out (B, 1, d), the next state).  Plain PyTorch, in
    float32 from the conv on, as ``repro/models/ssm.py:77-103``."""
    dt_c = cdtype(cfg)
    n, dtr = cfg.ssm_state, cfg.dt_rank
    w, sp = _weights(p, cfg, 1, mesh)
    x_in, z = (x[:, 0] @ w["in_proj"].to(dt_c)).chunk(2, dim=-1)
    window = torch.cat([state.conv, x_in[:, None]], dim=1)     # (B, K, di)
    conv = (window.float() * w["conv_w"].float()).sum(1) \
        + w["conv_b"].float()
    x_c = F.silu(conv).to(dt_c)
    dt_in, b_mat, c_mat = _dt_b_c(x_c, w, cfg, sp).split([dtr, n, n],
                                                         dim=-1)
    dt = F.softplus(dt_in @ w["dt_proj"].to(dt_c) + w["dt_bias"].to(dt_c))
    a = -torch.exp(w["a_log"].float())                         # (di, n)
    dtf, xf = dt.float(), x_c.float()
    h = state.h * torch.exp(dtf[..., None] * a) \
        + (dtf * xf)[..., None] * b_mat.float()[:, None, :]
    y = (h * c_mat.float()[:, None, :]).sum(-1) + xf * w["d_skip"].float()
    out = _out(y.to(dt_c) * F.silu(z), w, cfg, sp)
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


def _mamba2_split(xz: torch.Tensor, cfg: ModelConfig, tp: int = 1):
    """in_proj's output → (z, x, B, C, dt) (``repro/models/ssm.py:124-127``):
    the rank's share of z, x and dt under a split over ``tp``."""
    di, n = cfg.d_inner // tp, cfg.ssm_state
    return xz.split([di, di, n, n, di // cfg.mamba2_head_dim], dim=-1)


def _heads_to_channels(w: dict, dt: torch.Tensor, cfg: ModelConfig):
    """mamba2's head scalars broadcast into K9's form: dt (..., H) →
    (..., H·head_dim), a → (H·head_dim, N), d → (H·head_dim,)
    (``repro/models/ssm.py:150-157``)."""
    hd, n = cfg.mamba2_head_dim, cfg.ssm_state
    a = -torch.exp(w["a_log"].float().repeat_interleave(hd))
    return (dt.repeat_interleave(hd, dim=-1), a[:, None].expand(-1, n),
            w["d_skip"].repeat_interleave(hd))


def _gated_norm(g: torch.Tensor, gain: torch.Tensor, cfg: ModelConfig,
                sp: Optional[MixerSplit]) -> torch.Tensor:
    """RMSNorm over d_inner of the gated output; under a split the rank
    holds its channels, and the sum of squares is all-reduced over
    ``model``."""
    if sp is None:
        return rms_norm(g, gain, cfg.rms_eps)
    xf = g.float()
    ss = SH.all_reduce((xf * xf).sum(dim=-1, keepdim=True), sp.mesh,
                       "model")
    out = xf * torch.rsqrt(ss / cfg.d_inner + cfg.rms_eps) \
        * (1.0 + gain.float())
    return out.to(g.dtype)


def _mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig,
            return_state: bool, mesh=None):
    """The mamba2 forward; with ``return_state`` also the prefill's state
    (the conv's last inputs, the scan's final state)."""
    dt_c = cdtype(cfg)
    bsz, seq, _ = x.shape
    n, hd = cfg.ssm_state, cfg.mamba2_head_dim
    w, sp = _weights(p, cfg, 2, mesh)
    z, x_in, b_mat, c_mat, dt_h = _mamba2_split(
        x @ w["in_proj"].to(dt_c), cfg, 1 if sp is None else sp.tp)
    di = x_in.shape[-1]
    conv_in = torch.cat([x_in, b_mat, c_mat], dim=-1)
    conv = F.silu(_causal_conv(conv_in, w["conv_w"], w["conv_b"]))
    x_c, b_mat, c_mat = conv.split([di, n, n], dim=-1)
    dt = F.softplus(dt_h + w["dt_bias"].to(dt_c))            # (B, S, H)
    h_last = None
    if cfg.mamba2_use_ssd:
        y4, h4 = kref.mamba2_ssd(
            x_c.reshape(bsz, seq, di // hd, hd), dt,
            -torch.exp(w["a_log"].float()), b_mat, c_mat, w["d_skip"],
            chunk=cfg.ssd_chunk)
        y = y4.reshape(bsz, seq, di).to(dt_c)
        h_last = h4.reshape(bsz, di, n)
    else:
        dt_full, a_full, d_full = _heads_to_channels(w, dt, cfg)
        out = kops.mamba_scan(x_c, dt_full, a_full, b_mat, c_mat, d_full,
                              impl=cfg.kernels, return_state=return_state)
        y, h_last = out if return_state else (out, None)
    out = _out(_gated_norm(y * F.silu(z), w["norm"], cfg, sp), w, cfg, sp)
    if not return_state:
        return out
    return out, SSMState(conv=_conv_tail(conv_in, cfg.ssm_conv), h=h_last)


def mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig,
           mesh=None) -> torch.Tensor:
    """(B, S, d) → (B, S, d): SSD, or K9 when ``mamba2_use_ssd`` is off."""
    return _mamba2(p, x, cfg, return_state=False, mesh=mesh)


def mamba2_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """The forward that also returns the decode state: SSD's final state,
    or K9's with its last state."""
    return _mamba2(p, x, cfg, return_state=True, mesh=mesh)


def mamba2_decode(p: dict, x: torch.Tensor, state: SSMState,
                  cfg: ModelConfig, mesh=None
                  ) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d) → (out (B, 1, d), the next state).  Plain PyTorch, in
    float32 from the conv on, as ``repro/models/ssm.py:162-188``; the decay
    exp(dt·a) is taken once a channel (it is one value across the N
    states)."""
    dt_c = cdtype(cfg)
    n = cfg.ssm_state
    w, sp = _weights(p, cfg, 2, mesh)
    z, x_in, b_mat, c_mat, dt_h = _mamba2_split(
        x[:, 0] @ w["in_proj"].to(dt_c), cfg, 1 if sp is None else sp.tp)
    di = x_in.shape[-1]
    conv_in = torch.cat([x_in, b_mat, c_mat], dim=-1)        # (B, conv_ch)
    window = torch.cat([state.conv, conv_in[:, None]], dim=1)
    conv = (window.float() * w["conv_w"].float()).sum(1) \
        + w["conv_b"].float()
    x_c, b_mat, c_mat = F.silu(conv).to(dt_c).split([di, n, n], dim=-1)
    dt = F.softplus(dt_h + w["dt_bias"].to(dt_c))            # (B, H)
    dt_full, a_full, d_full = _heads_to_channels(w, dt, cfg)
    dtf, xf = dt_full.float(), x_c.float()
    h = state.h * torch.exp(dtf[..., None] * a_full[:, :1]) \
        + (dtf * xf)[..., None] * b_mat.float()[:, None, :]
    y = (h * c_mat.float()[:, None, :]).sum(-1) + xf * d_full.float()
    y = _gated_norm(y.to(dt_c) * F.silu(z), w["norm"], cfg, sp)
    return _out(y, w, cfg, sp)[:, None], SSMState(conv=window[:, 1:], h=h)


def _conv_tail(x_in: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 conv inputs (zero-padded on the left for short seqs),
    as a tensor of its own: a view would keep the whole projection alive
    in the cache."""
    s = x_in.shape[1]
    if s >= k - 1:
        return x_in[:, s - (k - 1):].clone()
    return F.pad(x_in, (0, 0, (k - 1) - s, 0))


def init_ssm_state(cfg: ModelConfig, batch: int, device,
                   version: int = 1, channels: Optional[int] = None
                   ) -> SSMState:
    """Zero state of ``batch`` rows: every channel, or the ``channels``
    of d_inner a rank's mixer computes (``mixer_channels``)."""
    di, n = channels or cfg.d_inner, cfg.ssm_state
    conv_ch = di if version == 1 else di + 2 * n
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=cdtype(cfg), device=device),
        h=torch.zeros((batch, di, n), dtype=torch.float32, device=device))
