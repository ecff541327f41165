"""Rotary position embeddings (``repro/models/rope.py:rope``).

qwen2-vl's M-RoPE comes with the slice that ports that model.
"""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer.  Rotates the two
    halves of D in float32 and casts back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = _freqs(x.shape[-1], theta, x.device)              # (half,)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)
