"""Optimizer of the port: AdamW, schedules, gradient compression
(``repro/optim``)."""
from . import compress, schedule
from .adamw import AdamWState, clip_by_global_norm, global_norm, init, update

__all__ = ["AdamWState", "clip_by_global_norm", "compress", "global_norm",
           "init", "schedule", "update"]
