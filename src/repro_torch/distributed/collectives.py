"""Cross-pod collectives: the wire-level compressed gradient exchange (port
of ``repro/distributed/collectives.py``).

``crosspod_int8_mean`` runs on every rank with the process group of the
``pod`` axis (``core.sharding.axis_group(mesh, "pod")[0]``): each pod
quantizes its gradients to int8 in blocks of 256 with a float32 scale a
block (``optim.compress.int8_compress``), all-gathers the int8 payload and
the scales across pods, so the inter-pod wire carries about a quarter of
the bytes of a float32 all-reduce, then dequantizes, sums the pods in
coordinate order and divides by their number.  The quantization residual
of this pod is returned, for the caller to carry to the next step (the
error feedback of ``optim/compress.py``).  ``crosspod_f32_mean`` is the
uncompressed baseline, an ``all_reduce`` SUM divided by the pods.

As in the reference, the train step does not call these: it reduces in
float32 and round-trips the codec (``optim.compress.mesh_round_trip``).
They are the wire-level form, held to the reference's bits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree as T
from ..core import sharding as SH
from ..optim import compress


def crosspod_int8_mean(grads, group=None):
    """grads (this pod's float32 tree) → (the mean over the pods of
    ``group``, this pod's residual), both in ``grads``' layout."""
    msg, residual = compress.int8_compress(grads, None)
    n = dist.get_world_size(group)

    def gather_avg(q, s, size):
        q_all = SH.group_gather(q[None], group, n)          # int8 on the wire
        s_all = SH.group_gather(s[None], group, n)          # f32 scales
        parts = q_all.to(torch.float32) * s_all[..., None]
        x = parts[0]
        for part in parts[1:]:                          # coordinate order
            x = x + part
        return (x / n).reshape(-1)[:size]
    mean = T.tree_map(gather_avg, msg.q, msg.scale, compress._numels(grads))
    return compress._split(mean, grads), residual


def crosspod_f32_mean(grads, group=None):
    """The uncompressed baseline: (the mean over the pods, None)."""
    n = dist.get_world_size(group)

    def mean(g):
        total = g.detach().clone()
        dist.all_reduce(total, group=group)
        return total / n
    return T.tree_map(mean, grads), None
