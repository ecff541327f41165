"""Architecture registry — maps ``--arch`` ids to (FULL, SMOKE) configs.

The same ten architectures as ``repro/configs/registry.py``.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (falcon_mamba_7b, gemma2_2b, granite_34b, granite_moe_3b,
               minicpm_2b, musicgen_medium, nemotron4_15b, phi35_moe_42b,
               qwen2_vl_2b, zamba2_1p2b)

_MODULES = {"gemma2-2b": gemma2_2b, "falcon-mamba-7b": falcon_mamba_7b,
            "nemotron-4-15b": nemotron4_15b, "minicpm-2b": minicpm_2b,
            "granite-34b": granite_34b,
            "granite-moe-3b-a800m": granite_moe_3b,
            "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
            "zamba2-1.2b": zamba2_1p2b,
            "musicgen-medium": musicgen_medium,
            "qwen2-vl-2b": qwen2_vl_2b}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.FULL
