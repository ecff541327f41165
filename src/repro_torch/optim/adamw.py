"""AdamW with global-norm clipping (``repro/optim/adamw.py``).

m and v mirror the param tree and are float32 whatever the compute dtype
(the params are the float32 master copy).  ``update`` works in place under
``torch.no_grad()``: it overwrites the params, m and v, and scales the
grads it is given.  That is the counterpart of the reference's donated
buffers (``jax.jit(..., donate_argnums=(0, 1, 2))``): at gemma2-2b's full
width each extra copy of the params costs 10.46 GB.  The arithmetic keeps
the reference's order of operations in float32, so the two agree to a few
ulp.

On a mesh (``mesh=`` with the params' ``specs``) the params, grads, m and v
are each rank's shards under ``ShardingRules.param_specs``.  The update is
elementwise, so it runs on shards unchanged; only the global norm needs the
mesh, and counts each logical element once (``global_norm``).  With
``mesh=None`` nothing changes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as T
from ..core import sharding as SH


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


def _square(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.detach(), dtype=torch.float32).square()


def _counted(spec, coord) -> bool:
    """Whether this rank's shard counts toward the norm: on coordinate 0
    of every axis the spec replicates."""
    return all(coord[a] == 0 for a in coord if a not in SH.spec_axes(spec))


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²) in float32, a 0-d tensor.  On a mesh
    ``tree`` holds this rank's shards under ``specs``: a dim the spec
    replicates over an axis lies on every coordinate of that axis, so a
    shard's squares count only on coordinate 0 of each axis its spec
    replicates; the leaves' sums are all-reduced over the mesh as one
    vector and then added in leaf order, as off the mesh."""
    if mesh is None:
        return torch.sqrt(sum(_square(x) for x in T.leaves(tree)))
    coord = dict(zip(SH.mesh_axes(mesh), mesh.get_coordinate()))
    pairs = []
    T.tree_map(lambda x, spec: pairs.append((x, spec)), tree, specs)
    sq = torch.stack([_square(x) if _counted(spec, coord)
                      else x.new_zeros((), dtype=torch.float32)
                      for x, spec in pairs])
    dist.all_reduce(sq, group=SH.axis_group(mesh, tuple(coord))[0])
    return torch.sqrt(sum(sq.unbind()))


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
           weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0,
           mesh=None, specs=None):
    """One AdamW step in place.  Returns (params, new state, grad norm);
    the params and the state's m and v are the tensors passed in (shards
    on a mesh, whose global norm ``specs`` says how to count)."""
    gnorm = global_norm(grads, mesh, specs)
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
