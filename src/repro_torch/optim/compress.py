"""Gradient compression with error feedback (``repro/optim/compress.py``).

Two codecs; the residual of what compression dropped is carried to the
next step:

  int8   per-block symmetric quantization (blocks of 256 elements)
  topk   the largest-|g| fraction of each leaf (indices + values)

The train step round-trips the gradient through the codec after the
full float32 reduction, as the reference's does: the round trip models
the wire format of a cross-pod reduction and keeps the residual exact.
The wire-level reduction itself, int8 on the pod-to-pod link, is
``distributed.collectives.crosspod_int8_mean`` (and its float32 baseline
``crosspod_f32_mean``); like the reference's, the train step does not
call it.

On a mesh the codecs see the logical leaf: ``int8_compress`` blocks the
flattened logical leaf in 256s and top-k picks over the whole leaf, so a
shard encoded on its own would give other blocks and another top-k.
``mesh_round_trip`` gathers each leaf of the gradient and of the residual
whole, encodes and decodes as off the mesh, and keeps this rank's shard of
the decoded gradient and of the new residual.

The codecs work on the reference's leaves.  Where the port keeps a list of
trees of one structure (gemma2's ``blocks``, one entry per layer), the
reference keeps one stacked array per leaf, layers in order, and encodes
it whole: an int8 block may straddle two layers, and top-k picks the
largest fraction of all layers together.  So each such leaf is joined
across the list, flat, before it is encoded; the message is in that
joined layout, and the residual and the decompressed gradient come back in
the port's.  A list's items hold no lists.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import tree as T
from ..distributed.sharding_rules import gather_params, shard_params

_BLOCK = 256


def _zeros_like_f32(tree):
    return T.tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                      tree)


def _blockify(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _BLOCK)


def _joined(tree, join):
    """``tree`` with each list of trees replaced by one tree of the items'
    structure whose leaves are ``join(*item leaves)``."""
    if isinstance(tree, dict):
        return {k: _joined(tree[k], join) for k in sorted(tree)}
    if isinstance(tree, list):
        return T.tree_map(join, *tree)
    return tree


def _join(tree):
    """The reference's leaves of ``tree``: list items' leaves flattened and
    joined in order."""
    return _joined(tree, lambda *xs: torch.cat([x.reshape(-1) for x in xs]))


def _split(flat, template):
    """``flat`` (each leaf flat, lists joined as ``_join`` joins them) cut
    into ``template``'s layout and shapes."""
    if isinstance(template, dict):
        return {k: _split(flat[k], template[k]) for k in sorted(template)}
    if isinstance(template, list):
        def item(i):
            def cut(f, *xs):
                return f.split([x.numel() for x in xs])[i].reshape(
                    xs[i].shape)
            return T.tree_map(cut, flat, *template)
        return [item(i) for i in range(len(template))]
    return flat.reshape(template.shape)


def _numels(template):
    """Element counts of ``template``'s leaves in ``_join``'s layout."""
    return _joined(T.tree_map(lambda x: x.numel(), template),
                   lambda *ns: sum(ns))


def _accumulate(grads, residual):
    if residual is None:
        residual = _zeros_like_f32(grads)
    return T.tree_map(lambda g, r: g.float() + r, grads, residual)


class Int8Msg(NamedTuple):
    q: dict
    scale: dict


def int8_compress(grads, residual):
    """Returns (Int8Msg in ``_join``'s layout, new residual in ``grads``');
    ``residual=None`` reads as zeros."""
    acc = _accumulate(grads, residual)

    def enc(x):
        blocks = _blockify(x)
        scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
        return q.to(torch.int8), scale

    msg = Int8Msg(*_encode(enc, _join(acc)))
    deq = int8_decompress(msg, acc)
    return msg, T.tree_map(lambda a, d: a - d, acc, deq)


def _encode(enc, acc):
    """Two trees of ``acc``'s structure: the first and the second output of
    ``enc`` on each leaf."""
    pairs = [enc(x) for x in T.leaves(acc)]
    return (T.unflatten(acc, [a for a, _ in pairs]),
            T.unflatten(acc, [b for _, b in pairs]))


def int8_decompress(msg: Int8Msg, template) -> dict:
    """The gradient in ``template``'s layout."""
    def dec(q, s, n):
        return (q.float() * s[:, None]).reshape(-1)[:n]
    return _split(T.tree_map(dec, msg.q, msg.scale, _numels(template)),
                  template)


class TopkMsg(NamedTuple):
    idx: dict
    val: dict


def topk_compress(grads, residual, density: float = 0.05):
    """Returns (TopkMsg in ``_join``'s layout, new residual in ``grads'``);
    ``residual=None`` reads as zeros."""
    acc = _accumulate(grads, residual)

    def enc(x):
        flat = x.reshape(-1)
        k = max(1, int(flat.shape[0] * density))
        idx = torch.topk(flat.abs(), k).indices
        return idx.to(torch.int32), flat[idx]

    msg = TopkMsg(*_encode(enc, _join(acc)))
    deq = topk_decompress(msg, acc)
    return msg, T.tree_map(lambda a, d: a - d, acc, deq)


def topk_decompress(msg: TopkMsg, template) -> dict:
    """The gradient in ``template``'s layout."""
    def dec(idx, val, n):
        out = torch.zeros(n, dtype=torch.float32, device=val.device)
        return out.index_add_(0, idx.long(), val)
    return _split(T.tree_map(dec, msg.idx, msg.val, _numels(template)),
                  template)


def wire_bytes(msg) -> int:
    """Bytes this message would put on the cross-pod link."""
    return sum(x.numel() * x.element_size() for x in T.leaves(msg))


def mesh_round_trip(codec: str, grads, residual, specs, mesh):
    """The codec round trip of a train step on a mesh.  ``grads`` and
    ``residual`` (None reads as zeros) are this rank's shards under
    ``specs``; returns this rank's shards of (the decoded gradient, the
    new residual).  Every leaf is gathered whole first (collective), so
    the blocks and the top-k are the logical leaf's."""
    codecs = {"int8": (int8_compress, int8_decompress),
              "topk": (topk_compress, topk_decompress)}
    encode, decode = codecs[codec]
    whole = gather_params(grads, specs, mesh)
    res = None if residual is None else gather_params(residual, specs, mesh)
    msg, res = encode(whole, res)
    whole = decode(msg, whole)
    return shard_params(whole, specs, mesh), shard_params(res, specs, mesh)
