"""The assigned input shapes, the same four for every LM arch (the port's
copy of ``repro/configs/shapes.py``).

``train_4k`` / ``prefill_32k`` run a train step / ``lm.prefill``;
``decode_32k`` / ``long_500k`` run ``lm.decode_step`` (one new token
against a KV cache of ``seq_len``).  ``long_500k`` needs sub-quadratic
attention, so it runs only for the ssm and hybrid archs.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(shape: ShapeSpec, family: str) -> bool:
    """long_500k needs sub-quadratic attention: ssm/hybrid only."""
    if shape.name == "long_500k":
        return family in ("ssm", "hybrid")
    return True
