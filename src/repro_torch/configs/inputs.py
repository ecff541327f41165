"""Inputs of each (arch x shape) cell: tensors on the ``meta`` device for
the dry run (shapes and dtypes, nothing allocated) and concrete tensors
for smoke runs (port of ``repro/configs/inputs.py``).

``make_inputs`` draws numpy arrays from ``np.random.default_rng(seed)`` in
the reference's order, so its tokens, labels, positions and embeddings are
the reference's bit for bit, then moves them onto ``device`` (default
"cuda"; raises without a card).  Decode's caches are ``lm.make_cache``'s:
the port's layout, a list a layer, where the reference stacks them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import device as _device
from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import cdtype
from .shapes import ShapeSpec


def _pos_shape(cfg: ModelConfig, b: int, s: int) -> Tuple[int, ...]:
    return (b, s, 3) if cfg.mrope else (b, s)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """The step inputs of this cell as ``meta`` tensors
    (``repro/configs/inputs.py:22-52``):

    train   → {"inputs": …, "labels": …}            (feeds a train step)
    prefill → {"inputs": …}                          (feeds prefill)
    decode  → {"inputs": one token, "caches": …}     (feeds decode_step)
    """
    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    inputs = {"positions": meta(_pos_shape(cfg, b, s), torch.int32)}
    if cfg.frontend_stub:
        inputs["embeds"] = meta((b, s, cfg.d_model), cdtype(cfg))
    else:
        inputs["tokens"] = meta((b, s), torch.int32)
    if shape.kind == "train":
        return {"inputs": inputs, "labels": meta((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"inputs": inputs}
    return {"inputs": inputs,
            "caches": lm.make_cache(cfg, b, shape.seq_len, device="meta")}


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                device=None) -> Dict:
    """Concrete inputs matching ``input_specs``, on ``device``: the
    reference's numpy draws (``repro/configs/inputs.py:55-79``) as
    tensors, the decode caches empty."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1

    def pos(b_, s_):
        p = np.tile(np.arange(s_, dtype=np.int32)[None], (b_, 1))
        return np.tile(p[:, :, None], (1, 1, 3)) if cfg.mrope else p

    def t(x):
        return torch.from_numpy(x).to(dev)
    inputs = {"positions": pos(b, s)}
    if cfg.frontend_stub:
        inputs["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32) * 0.02
    else:
        inputs["tokens"] = rng.integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32)
    inputs = {k: t(v) for k, v in inputs.items()}
    if shape.kind == "train":
        return {"inputs": inputs,
                "labels": t(rng.integers(0, cfg.vocab_size,
                                         (b, s)).astype(np.int32))}
    if shape.kind == "prefill":
        return {"inputs": inputs}
    return {"inputs": inputs,
            "caches": lm.make_cache(cfg, b, shape.seq_len, device=dev)}
