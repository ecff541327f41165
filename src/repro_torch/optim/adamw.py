"""AdamW with global-norm clipping (``repro/optim/adamw.py``).

m and v mirror the param tree and are float32 whatever the compute dtype
(the params are the float32 master copy).  ``update`` works in place under
``torch.no_grad()``: it overwrites the params, m and v, and scales the
grads it is given.  That is the counterpart of the reference's donated
buffers (``jax.jit(..., donate_argnums=(0, 1, 2))``): at gemma2-2b's full
width each extra copy of the params costs 10.46 GB.  The arithmetic keeps
the reference's order of operations in float32, so the two agree to a few
ulp.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tree as T


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                requires_grad=False)
    return AdamWState(step=0, m=T.tree_map(zeros, params),
                      v=T.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²) in float32, a 0-d tensor."""
    sq = [torch.linalg.vector_norm(x.detach(), dtype=torch.float32).square()
          for x in T.leaves(tree)]
    return torch.sqrt(sum(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads · min(1, max_norm / norm), norm), out of place."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return T.tree_map(lambda g: g * scale, grads), norm


def _f32(x) -> float:
    return float(np.float32(x))


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr: float,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0):
    """One AdamW step in place.  Returns (params, new state, grad norm);
    the params and the state's m and v are the tensors passed in."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, clip_norm) if clip_norm is not None else None
    step = state.step + 1
    bc1 = _f32(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = _f32(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    lr = _f32(lr)
    for g, m, v, p in zip(T.leaves(grads), T.leaves(state.m),
                          T.leaves(state.v), T.leaves(params)):
        g = g.float()
        if scale is not None:
            g = g.mul_(scale)
        m.mul_(b1).add_((1 - b1) * g)
        g2 = (1 - b2) * g
        v.mul_(b2).add_(g2.mul_(g))
        del g, g2
        u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        u.add_(weight_decay * p)
        p.sub_(u.mul_(lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
