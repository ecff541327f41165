"""Learning-rate schedules (``repro/optim/schedule.py``): WSD
(warmup-stable-decay, minicpm-2b's native schedule and the default),
cosine and constant.  Each returns step → lr, computed in float32 as the
reference computes it, and returned as a Python float."""
from __future__ import annotations

import numpy as np

_F = np.float32


def wsd(peak_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, final_ratio: float = 0.1):
    """Linear warmup → plateau at ``peak_lr`` → linear decay to
    ``final_ratio · peak_lr``."""
    def lr(step) -> float:
        s = _F(step)
        if s < warmup_steps:
            return float(_F(peak_lr) * s / _F(max(warmup_steps, 1)))
        if s < warmup_steps + stable_steps:
            return float(_F(peak_lr))
        frac = (s - _F(warmup_steps) - _F(stable_steps)) / _F(
            max(decay_steps, 1))
        return float(_F(peak_lr) * (_F(1.0) - _F(1.0 - final_ratio)
                                    * np.clip(frac, _F(0), _F(1))))
    return lr


def cosine(peak_lr: float, warmup_steps: int, total_steps: int,
           final_ratio: float = 0.1):
    def lr(step) -> float:
        s = _F(step)
        if s < warmup_steps:
            return float(_F(peak_lr) * s / _F(max(warmup_steps, 1)))
        prog = np.clip((s - _F(warmup_steps))
                       / _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        cos = _F(final_ratio) + _F((1 - final_ratio) * 0.5) * (
            _F(1) + np.cos(_F(np.pi) * prog))
        return float(_F(peak_lr) * cos)
    return lr


def constant(peak_lr: float):
    return lambda step: float(_F(peak_lr))
